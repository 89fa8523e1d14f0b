"""Build, load and launch the port's hand-written CUDA kernels.

Each source under `nelegan_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into its own shared library with a plain C interface, under
`build/nelegan_tpu_torch/` at the repository root, on first use (or all at
once, in parallel, through `build()`).  The libraries are loaded with
`ctypes`; every pointer and the stream are passed as `c_void_p`.  Each C
entry point returns `cudaGetLastError()` after its launch and `launch`
raises when that is not 0.

`launches` counts, per kernel, the launches made through `launch`: it is how
a run shows that a path really went through a kernel.  Nothing here is
imported or built until a CUDA tensor asks for a kernel, so the module
imports on a machine without `nvcc` or a GPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_P, _I = ctypes.c_void_p, ctypes.c_int
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nelegan_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


@dataclasses.dataclass(frozen=True)
class Kernel:
    source: str                 # file under csrc/
    symbol: str                 # C entry point
    argtypes: Tuple             # ctypes argument types of `symbol`
    flags: Tuple[str, ...] = ()  # extra nvcc flags for this source


KERNELS: Dict[str, Kernel] = {
    # y2, psd, state_in, state_out, ju_in, ju_out, B, T, K, l0, coef,
    # is_frames, v_frames, stream; a NULL state_in starts a fresh scan, a
    # NULL state_out keeps no state.  Built without FMA contraction so its
    # float32 arithmetic rounds as PyTorch's elementwise ops do: the VAD
    # thresholds turn one-ulp differences into different decisions.
    "imcra_scan": Kernel("imcra.cu", "imcra_scan_f32",
                         (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I,
                          _P),
                         ("-fmad=false",)),
    # x, a, y, rows, n, stream
    "gammatone_cascade": Kernel("cascade.cu", "gammatone_cascade_f32",
                                (_P, _P, _P, _I, _I, _P)),
    # a, b, y0, y, rows, n, kind (0 float32, 1 complex64, 2 float64),
    # a_per_step, stream: the first-order recurrence y[n] = a[n] y[n-1] +
    # b[n] of ops/iir.py; a NULL y0 starts every row from 0.
    "linrec": Kernel("linrec.cu", "linrec",
                     (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
    # a, g, y0, y, db, da, dy0, rows, n, kind, a_per_step, stream: its
    # adjoint for the output's gradient g (NULL da or dy0: not wanted; da
    # needs the forward's y).
    "linrec_bwd": Kernel("linrec.cu", "linrec_bwd",
                         (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    # counts, seed, blocks, iters, stream: the card's check of the IMCRA
    # kernel's fast division against IEEE division (same library).
    "imcra_divide_check": Kernel("imcra.cu", "imcra_divide_check",
                                 (_P, ctypes.c_ulonglong, _I, _I, _P),
                                 ("-fmad=false",)),
}

launches: Dict[str, int] = {name: 0 for name in KERNELS}
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    with _lock:
        for name in launches:
            launches[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    path = shutil.which("nvcc")
    if path is None and CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return path


def _library_path(k: Kernel) -> Path:
    """Output path keyed by the source's content and the build flags, so an
    edited source is rebuilt and a stale library is never loaded."""
    h = hashlib.sha256((CSRC / k.source).read_bytes())
    h.update(" ".join(ARCH_FLAGS + k.flags).encode())
    return BUILD_DIR / f"lib{Path(k.source).stem}-{h.hexdigest()[:16]}.so"


def _compile_cmd(k: Kernel, out: Path) -> list:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", *k.flags, "-o", str(out),
            str(CSRC / k.source)]


def build(names: Iterable[str] | None = None) -> float:
    """Compile the named kernels (default: all) that are not built yet, one
    `nvcc` per library (entry points of one source share it), all started
    together.  Returns the wall seconds."""
    t0 = time.perf_counter()
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, started = [], set()
    for name in names:
        k = KERNELS[name]
        out = _library_path(k)
        if out.exists() or out in started:
            continue
        started.add(out)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(_compile_cmd(k, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _function(name: str):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            k = KERNELS[name]
            build([name])
            lib = ctypes.CDLL(str(_library_path(k)))
            fn = getattr(lib, k.symbol)
            fn.argtypes = list(k.argtypes)
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return getattr(lib, KERNELS[name].symbol)


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the stream given as its last argument; raise
    if the launch was refused."""
    fn = _function(name)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    with _lock:
        launches[name] += 1
