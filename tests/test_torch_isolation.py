"""The port stands alone: no JAX, flax, msgpack or nelegan_tpu, none of the
reference package's native sources, and no silent CPU fallback."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "nelegan_tpu_torch"
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|msgpack|nelegan_tpu)"
    r"(?:[.\s]|$)"
    r"|import_module\(\s*['\"](?:jax|flax|msgpack|nelegan_tpu)(?:['\".])",
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
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', "
        "'nelegan_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack') and sys.modules[m] "
        "is not None]\n"
        "assert not bad, bad\n"
        "print('imported', len(" + repr(_port_modules()) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_scoring_modules_are_covered():
    """The scoring slice's modules are among those imported and scanned
    above."""
    mods = set(_port_modules())
    assert {"nelegan_tpu_torch.metrics", "nelegan_tpu_torch.metrics._framing",
            "nelegan_tpu_torch.metrics.calibrate",
            "nelegan_tpu_torch.metrics.estoi",
            "nelegan_tpu_torch.metrics.siib",
            "nelegan_tpu_torch.metrics.haspi",
            "nelegan_tpu_torch.metrics.haspi.ear_model",
            "nelegan_tpu_torch.metrics.haspi.chains",
            "nelegan_tpu_torch.ops.iir",
            "nelegan_tpu_torch.dsp.resample",
            "nelegan_tpu_torch.metrics.pesq",
            "nelegan_tpu_torch.metrics.visqol",
            "nelegan_tpu_torch.metrics.clean_pool",
            "nelegan_tpu_torch.utils.lru",
            "nelegan_tpu_torch.cli.eval_reverb",
            "nelegan_tpu_torch.cli.collect_norm"} <= mods


def test_trainer_modules_are_covered():
    """The training loop's modules are among those imported and scanned."""
    assert {"nelegan_tpu_torch.train.loop",
            "nelegan_tpu_torch.train.resilience",
            "nelegan_tpu_torch.cli.train",
            "nelegan_tpu_torch.utils.profiling"} <= set(_port_modules())


def test_recovery_and_report_modules_are_covered():
    """The world's recovery and the training report are among the modules
    imported and scanned; the report reads the JAX campaign's results as
    data, imports nothing of the JAX package, and builds its corpus with
    the repository's tool run as a program."""
    assert {"nelegan_tpu_torch.train.resilience",
            "nelegan_tpu_torch.cli.train_report"} <= set(_port_modules())
    from nelegan_tpu_torch.cli import train_report
    from nelegan_tpu_torch.train import resilience
    assert callable(resilience.resume_after_restart)
    assert train_report.JAX_REPORT.suffix == ".json"


def test_parallel_modules_are_covered(monkeypatch):
    """The data-parallel modules are among those imported and scanned; a
    mesh needs a process group, and its default device is CUDA."""
    assert {"nelegan_tpu_torch.parallel", "nelegan_tpu_torch.parallel.mesh",
            "nelegan_tpu_torch.parallel.launch",
            "nelegan_tpu_torch.utils.tree"} <= set(_port_modules())
    from nelegan_tpu_torch.parallel import launch, make_mesh
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(devices=["cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with launch.world_of_one():
            pass


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
    from nelegan_tpu_torch.train import gan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.EnhanceServer(Generator(hidden=8, n_blocks=3))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--torch-checkpoint", "absent.pt"])
    with pytest.raises(RuntimeError, match="CUDA"):
        gan.init_train_state()
    with pytest.raises(RuntimeError, match="CUDA"):
        gan.featurize_bands(np.zeros((1, 4608), np.float32),
                            np.zeros((1, 4608), np.float32), [4096])
    assert resolve_device("cpu") == torch.device("cpu")


def test_new_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from nelegan_tpu_torch import metrics, pipeline, streaming
    from nelegan_tpu_torch.cli import (collect_norm, eval_reverb,
                                       export_torch, infer, serve, stream,
                                       train, train_report)
    from nelegan_tpu_torch.dsp.imcra import imcra_init
    from nelegan_tpu_torch.metrics.siib import siib
    from nelegan_tpu_torch.models.generator import Generator
    from nelegan_tpu_torch.train.checkpoint import load_generator
    from nelegan_tpu_torch.train.loop import Trainer, TrainPaths

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = Generator(hidden=8, n_blocks=3)
    x = np.zeros(4096, np.float32)
    calls = [
        lambda: streaming.StreamingEnhancer(gen),
        lambda: streaming.init_stream_state(gen),
        lambda: streaming.enhance_offline_causal(gen, x, x),
        lambda: pipeline.active_speech_level_batch(x[None]),
        lambda: load_generator(torch_checkpoint="absent.pt"),
        lambda: serve.main(["--checkpoint", "absent"]),
        lambda: stream.main(["--clean", "a.wav", "--noise", "a.wav", "--out",
                             "b.wav", "--checkpoint", "absent"]),
        lambda: infer.main(["--test-clean", str(tmp_path), "--test-noise",
                            str(tmp_path), "--checkpoint", "absent"]),
        lambda: export_torch.main(["--checkpoint", "absent", "--out", "x.pt"]),
        lambda: metrics.score_pair(x, x, x),
        lambda: metrics.score_batch([x], [x], [x]),
        lambda: metrics.score_corpus([x], [x], [x]),
        lambda: siib(x, x),
        lambda: imcra_init(3, torch.float32),
        lambda: metrics.pesq_p862(x, x),
        lambda: metrics.visqol_speech(x, x),
        lambda: eval_reverb.main(["--test-clean", str(tmp_path),
                                  "--test-noise", str(tmp_path),
                                  "--checkpoint", "absent"]),
        lambda: collect_norm.main(["--clean", str(tmp_path), "--noise",
                                   str(tmp_path), "--enhanced",
                                   str(tmp_path)]),
        lambda: Trainer(TrainPaths(*[str(tmp_path)] * 4)),
        lambda: train.main(["--train-clean", str(tmp_path), "--train-noise",
                            str(tmp_path), "--test-clean", str(tmp_path),
                            "--test-noise", str(tmp_path)]),
        lambda: train_report.main(["--work", str(tmp_path), "--out",
                                   str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_port_never_opens_the_reference_native_sources(tmp_path):
    """The wav reader is built from the port's own csrc/wavio.cpp; nothing
    the port opens, runs or loads lies under the repository's csrc/."""
    code = (
        "import sys\n"
        "seen = []\n"
        "sys.addaudithook(lambda ev, args: seen.append((ev, repr(args))) if "
        "ev in ('open', 'ctypes.dlopen', 'subprocess.Popen') else None)\n"
        "import numpy as np\n"
        "from nelegan_tpu_torch.data import wavio\n"
        f"p = {str(tmp_path / 'x.wav')!r}\n"
        "wavio.write_wav_pcm16(p, np.zeros(300, np.float32))\n"
        "assert wavio.read_wav(p)[0].shape == (300,)\n"
        "wavio.read_wav_batch([p, p], 400)\n"
        f"bad = [s for s in seen if {str(REPO / 'csrc')!r} in s[1]]\n"
        "assert not bad, bad\n"
        "assert any(ev == 'ctypes.dlopen' for ev, _ in seen)\n"
        "print('ok', wavio.library_path())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert str(REPO / "build" / "nelegan_tpu_torch") in out.stdout


def test_kernel_wrappers_refuse_non_cuda_accelerators():
    """A tensor off the CPU never takes the plain version: on CUDA the
    wrapper launches its kernel, on anything else it raises."""
    from nelegan_tpu_torch.dsp.imcra import imcra_psd, imcra_scan
    from nelegan_tpu_torch.ops.cascade import gammatone_cascade
    from nelegan_tpu_torch.ops.iir import linrec, one_pole
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
    with pytest.raises(ValueError, match="device"):
        linrec(torch.empty(2, device=meta), torch.empty(2, 8, device=meta))
    with pytest.raises(ValueError, match="device"):
        one_pole(torch.empty(2, 8, device=meta), 0.5)


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_guard_imports_without_jax(tmp_path):
    """The guarded CLI runs of chip_smoke.py import the script itself for
    its generator guard: with JAX and the reference package blocked it
    imports, and its hooks see a Trainer's generator through epoch 1
    (here through __init__ alone: no corpus is read) and undo."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', "
        "'nelegan_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import chip_smoke as cs\n"
        "from nelegan_tpu_torch.train import loop\n"
        "init = loop.Trainer.__init__\n"
        "undo = cs.install_generator_guard()\n"
        "assert loop.Trainer.__init__ is not init\n"
        "undo()\n"
        "assert loop.Trainer.__init__ is init and cs.GUARDS == []\n"
        "g = cs.GeneratorGuard('t')\n"
        "m = cs.Generator(hidden=8, n_blocks=3)\n"
        "g.mark('a', m)\n"
        "g.mark('b', m)\n"
        "assert g.ok, g.record()\n"
        "import torch\n"
        "with torch.no_grad():\n"
        "    m.fc1.weight.view(-1)[3:6] += 1.0\n"
        "g.mark('c', m)\n"
        "v = g.record()['violation']\n"
        "assert v['point'] == 'c' and v['tensor'] == 'fc1.weight', v\n"
        "assert v['changed'] == 3 and v['ranges'] == [[3, 5]], v\n"
        "print('guarded')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "guarded" in out.stdout
