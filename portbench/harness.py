"""One run of one benchmark cell of `nelegan_tpu_torch`, driven by data.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` finds everything by name:

  * the cell ``portbench/workloads/<cell>.json``: its configuration, its
    traffic, and the limit of every number that decides `correct`, each
    with its reason;
  * the configuration ``portbench/configs/<config>.json``: the sizes the
    port runs at;
  * the traffic ``portbench/traffic/<traffic>.json``: its parameters and
    its `kind`, the module ``portbench/traffic/<kind>.py`` that runs it;
  * each per-layer metric ``portbench/metrics/<metric>.py``, whose `read`
    takes the traced run's `Context` and returns a number or None.

The kind's `run(ctx)` sets up, measures for `--seconds`, and leaves in
`ctx` the end-to-end metrics, the traced window and the numbers its
comparison with the plain reference (`portbench/reference/`) gave.  The
last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number beside its limit; the same numbers close
standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
# every build and kernel cache, at fixed paths inside the checkout
CACHE = ROOT / "build" / "portbench"
# top-level module names that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nelegan_tpu")


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A file of the benchmark as a module, whatever dots its name has."""
    spec = importlib.util.spec_from_file_location(
        "portbench._" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class Limit:
    value: float
    why: str


class Checks:
    """The numbers that decide `correct`, each held to its limit.

    A number is defined only with a limit, which comes from the cell's
    file: `define` refuses one that has none, or a limit that is not a
    finite number >= 0.  `correct` is exactly "every number defined is
    finite and within its limit"; a number never defined leaves the run
    not correct (`missing`)."""

    def __init__(self, limits: Dict[str, dict]):
        self.limits: Dict[str, Limit] = {}
        for name, spec in limits.items():
            v = spec.get("limit") if isinstance(spec, dict) else None
            if (not isinstance(v, (int, float)) or isinstance(v, bool)
                    or not math.isfinite(v) or v < 0):
                raise ValueError(f"check {name!r}: limit {v!r} is not a "
                                 f"finite number >= 0")
            if not spec.get("why"):
                raise ValueError(f"check {name!r}: its limit gives no reason")
            self.limits[name] = Limit(float(v), spec["why"])
        self.values: Dict[str, float] = {}

    def define(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"check {name!r} has no limit in the cell's file")
        self.values[name] = float(value)

    @property
    def missing(self) -> List[str]:
        return [n for n in self.limits if n not in self.values]

    @property
    def correct(self) -> bool:
        return not self.missing and all(
            math.isfinite(v) and v <= self.limits[n].value
            for n, v in self.values.items())

    def table(self) -> Dict[str, dict]:
        """{name: {"value", "limit"}} in the cell file's order; a number
        never defined reads null."""
        return {n: {"value": self.values.get(n), "limit": lim.value}
                for n, lim in self.limits.items()}


@dataclasses.dataclass
class Context:
    """What a kind's `run` gets, and what it leaves for the readers and the
    result line."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: Any                      # torch.device
    config: dict                     # portbench/configs/<config>.json
    traffic: dict                    # portbench/traffic/<traffic>.json
    workload: dict                   # portbench/workloads/<cell>.json
    tmp: str                         # this run's scratch directory
    checks: Checks
    metrics: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    window: Any = None               # trace.Window of the traced run
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # hooks a test plants to break the timed path (None in a benchmark run)
    fault: Optional[Callable[[str, Any], Any]] = None

    def report(self, name: str, value: float, unit: str) -> None:
        self.metrics[name] = (float(value), unit)


def _cells_metric_names(cell: str, trace: bool) -> Optional[List[str]]:
    """The metric names BENCHMARK.json gives this cell, in its order
    (None without a BENCHMARK.json)."""
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        return None
    with open(path) as f:
        bench = json.load(f)
    key = "per_layer" if trace else "end_to_end"
    return [m["name"] for m in bench.get(key, [])
            if cell in m.get("workloads", [cell])]


def read_layer_metrics(ctx: Context) -> Dict[str, tuple]:
    """Every reader under portbench/metrics/ that finds something to read
    in this cell, by file name; a reader that returns None is left out."""
    out = {}
    for path in sorted((BENCH / "metrics").glob("*.py")):
        if path.stem.startswith("_"):
            continue
        mod = load_module(path)
        value = mod.read(ctx)
        if value is not None:
            out[path.stem] = (float(value), mod.UNIT)
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def set_environment() -> None:
    """Caches at fixed paths inside the checkout; nothing loads JAX."""
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def set_host_threads(config: dict) -> Optional[int]:
    """The configuration's `host_threads`, if it states one, for OpenMP,
    MKL and OpenBLAS; call before torch is imported.  -> the count, for
    `torch.set_num_threads` once it is."""
    n = config.get("host_threads")
    if n is None:
        return None
    for var in THREAD_VARS:
        os.environ[var] = str(int(n))
    return int(n)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device=None, fault=None, control: bool = False,
             shrink: Optional[dict] = None,
             notes: Optional[dict] = None) -> dict:
    """One run of `cell`; -> the result line's object.  `device` None means
    CUDA, which must be there.  A test passes "cpu", a `fault` to plant,
    and `shrink`, traffic parameters that size the cell down to what a
    test run can hold; `control` adds the control's numbers, and the
    program's, to the result (never in a benchmark run)."""
    import torch
    workload = load_json("workloads", cell)
    config = load_json("configs", workload["config"])
    traffic = {**load_json("traffic", workload["traffic"]), **(shrink or {})}
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    tmp = tempfile.mkdtemp(prefix=f"portbench-{cell}-")
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                  device=dev, config=config, traffic=traffic,
                  workload=workload, tmp=tmp,
                  checks=Checks(workload["limits"]), fault=fault)
    try:
        kind = load_module(BENCH / "traffic" / f"{traffic['kind']}.py")
        kind.run(ctx, control=control)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if notes is not None:
        notes.update({k: ctx.layer[k] for k in
                      ("setup_parts", "reference_s", "traced_epoch_s",
                       "untraced_epoch_s") if k in ctx.layer})
        if "window" in ctx.layer:
            notes["window"] = {k: v for k, v in ctx.layer["window"].items()
                               if k != "steps"}
        if ctx.window is not None:
            notes["launches_in_spans"] = ctx.window.launches_in_spans
    names = _cells_metric_names(cell, trace)
    if trace:
        found = read_layer_metrics(ctx)
    else:
        found = dict(ctx.metrics)
    if names is not None:
        found = {n: found[n] for n in names if n in found}
    result = {"correct": ctx.checks.correct, "attempted": ctx.attempted,
              "failed": ctx.failed,
              "metrics": {n: {"value": v, "unit": u}
                          for n, (v, u) in found.items()},
              "device": device_record(ctx)}
    if trace and ctx.window is not None:
        result["breakdown"] = ctx.window.breakdown()
    if control:
        result["control"] = ctx.layer.get("control")
        result["program"] = ctx.layer.get("program")
        result["faults"] = ctx.layer.get("faults")
    result["checks"] = ctx.checks.table()
    return result


def device_record(ctx: Context) -> dict:
    import torch
    dev = ctx.device
    rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    if ctx.trace and ctx.window is not None:
        rec["busy_s"] = ctx.window.busy_s
        rec["window_s"] = ctx.window.window_s
    return rec


def print_result(result: dict, notes: Optional[dict] = None) -> None:
    if notes:
        print(f"portbench: {json.dumps(notes)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    workload = load_json("workloads", args.workload)
    threads = set_host_threads(load_json("configs", workload["config"]))
    import torch
    if threads is not None:
        torch.set_num_threads(threads)
    chips = int(workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(f"portbench: {power_limit()}; torch {torch.__version__}; "
          f"host threads {torch.get_num_threads()}", file=sys.stderr)
    notes: dict = {}
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), notes=notes)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the measuring process loaded {bad}",
              file=sys.stderr)
        return 4
    print_result(result, notes)
    return 0
