"""The port stands alone: no JAX, no nelegan_tpu, and no silent CPU
fallback."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "nelegan_tpu_torch"
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|nelegan_tpu)(?:[.\s]|$)"
    r"|import_module\(\s*['\"](?:jax|flax|nelegan_tpu)(?:['\".])",
    re.MULTILINE)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_reference_package():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'nelegan_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('imported', len(" + repr(_port_modules()) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_no_port_source_imports_jax_or_reference_package():
    sources = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        hit = _FORBIDDEN.search(path.read_text())
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_default_device_raises_without_cuda(monkeypatch):
    from nelegan_tpu_torch.cli import serve
    from nelegan_tpu_torch.device import resolve_device
    from nelegan_tpu_torch.models.generator import Generator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.EnhanceServer(Generator(hidden=8, n_blocks=3))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--torch-checkpoint", "absent.pt"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_non_cuda_accelerators():
    """A tensor off the CPU never takes the plain version: on CUDA the
    wrapper launches its kernel, on anything else it raises."""
    from nelegan_tpu_torch.dsp.imcra import imcra_psd, imcra_scan
    from nelegan_tpu_torch.ops.cascade import gammatone_cascade
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="device"):
        imcra_scan(torch.empty(1, 4, 257, device=meta))
    with pytest.raises(ValueError, match="device"):
        imcra_scan(torch.empty(1, 4, 257, device=meta), keep_state=False)
    with pytest.raises(ValueError, match="device"):
        imcra_psd(torch.empty(1, 4, 257, device=meta))
    with pytest.raises(ValueError, match="device"):
        gammatone_cascade(torch.empty(2, 8, device=meta),
                          torch.empty(2, device=meta))


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
