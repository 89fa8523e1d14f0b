"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names compared whole
(`nelegan_tpu_torch` begins with `nelegan_tpu`)."""
import ast
import json
import os
import subprocess
import sys

from conftest import ENHANCE_SHRINK, ROOT

BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nelegan_tpu"}


def imported_top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(imported_top_names(p)) & FORBIDDEN)
           for p in py_files(BENCH)}
    assert not {p: b for p, b in bad.items() if b}


def test_the_scan_compares_whole_top_level_names():
    assert "nelegan_tpu_torch" not in FORBIDDEN
    src = "import nelegan_tpu_torch.pipeline\nfrom nelegan_tpu.x import y\n"
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), "pb_scan_probe.py")
    with open(path, "w") as f:
        f.write(src)
    try:
        assert set(imported_top_names(path)) & FORBIDDEN == {"nelegan_tpu"}
    finally:
        os.remove(path)


def test_reference_imports_nothing_of_the_program():
    bad = {p: sorted(n for n in imported_top_names(p)
                     if n == "nelegan_tpu_torch")
           for p in py_files(os.path.join(BENCH, "reference"))}
    assert not {p: b for p, b in bad.items() if b}


def test_a_run_loads_no_jax():
    """A run's process, program and reference included, holds none of the
    forbidden modules once it is over."""
    code = ("import json, sys; sys.path.insert(0, %r);"
            "from portbench import harness; harness.set_environment();"
            "harness.run_cell('enhance.f32.b64', 5, 0.2, False, "
            "device='cpu', shrink=%s);"
            "print(json.dumps(harness.forbidden_modules()))"
            % (ROOT, json.dumps(ENHANCE_SHRINK)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
