"""Tracing and per-phase step timing.

Counterpart of `nelegan_tpu/utils/profiling.py` (the reference has no
systematic profiling: one ad-hoc wall-clock loop, pyhaspi2.py:1253-1262):

  * `StepTimer` accumulates wall-clock per named phase and reports
    count/mean/total; the training loop wraps its phases with it, and a
    checkpoint's ``extra["timing"]`` (either package's) loads into its
    `_total` and `_count`;
  * `trace_context` wraps a block in a `torch.profiler` trace of the CPU
    and CUDA activities when a directory is given, exported there as a
    Chrome trace, and is a no-op otherwise, so it can stay in production
    code paths.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class StepTimer:
    def __init__(self):
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": self._total[name],
                       "count": self._count[name],
                       "mean_s": self._total[name] / self._count[name]}
                for name in self._total}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)

    def __str__(self) -> str:
        return " | ".join(
            f"{k}: {v['total_s']:.1f}s total ({v['count']}x, "
            f"mean {v['mean_s']:.2f}s)"
            for k, v in sorted(self.report().items()))


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str] = None) -> Iterator[object]:
    """A `torch.profiler.profile` of the block (CPU, and CUDA where it is
    available) when trace_dir is set, its Chrome trace written to
    ``trace_dir/trace.json`` on exit; yields the profiler (its
    `key_averages()` and `events()` stay readable), or None as a no-op."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
