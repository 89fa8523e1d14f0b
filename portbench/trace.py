"""The traced window: a `torch.profiler` trace reduced to what the readers need.

`Window` profiles a block with the device's activity alone (kernels,
copies, sets and the runtime calls that launch them; no operator of the
host is recorded, so the host runs near its untraced speed), and keeps:

  * the device's operations as intervals on the host's clock, their union
    (`busy_s`) within the window (`window_s`);
  * the host's spans, which the benchmark records itself on the same
    clock (`time.time_ns`) into `spans`: `Window.span` around the calls it
    makes into the program (`pb.*`), the adapter around the trainer's
    phases (`phase.*`); a kernel is charged to the span whose runtime call
    launched it (by correlation id), an idle gap to what the host was
    doing;
  * per kernel name, its launches and device seconds.

Nothing is rounded: each number is as measured.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# the `record_function` names the benchmark opens around its calls
SPAN_PREFIXES = ("pb.", "phase.")


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Window:
    """``with Window(device) as w: ...`` profiles the block; afterwards
    `busy_s`, `window_s`, `kernels`, `span_device_s` and `breakdown()`."""

    def __init__(self, device):
        self.device = device
        self.busy_s = 0.0
        self.window_s = 0.0
        self.kernels: Dict[str, List[float]] = {}     # name -> [n, seconds]
        self.span_device_s: Dict[str, float] = defaultdict(float)
        self.gaps: Dict[str, float] = defaultdict(float)
        self.top_ops: List[Tuple[str, float]] = []
        self.spans: List[Tuple[int, int, str]] = []
        self.launches_in_spans = None
        self._prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name))

    def __enter__(self) -> "Window":
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts = [ProfilerActivity.CUDA]
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        self._prof.stop()
        if exc[0] is None:
            self._reduce(self._prof.profiler.kineto_results.events(),
                         self._t0, t1)
        self._prof = None

    def _reduce(self, events, t0: int, t1: int) -> None:
        from torch.autograd import DeviceType
        spans = list(self.spans)
        launches: Dict[int, int] = {}
        device: List[Tuple[int, int, str, int]] = []
        for e in events:
            name = e.name()
            s = e.start_ns()
            end = s + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                # the device-side copies of annotations are no work
                if not name.startswith(SPAN_PREFIXES):
                    device.append((s, end, name, e.correlation_id()))
            elif name.startswith("cu") and e.correlation_id():
                launches[e.correlation_id()] = s
        self.window_s = (t1 - t0) * 1e-9
        clipped = [(max(s, t0), min(e, t1)) for s, e, _, _ in device
                   if e > t0 and s < t1]
        busy = _merge(clipped)
        self.busy_s = sum(e - s for s, e in busy) * 1e-9
        per_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
        for s, e, name, _ in device:
            k = per_name[name]
            k[0] += 1
            k[1] += (e - s) * 1e-9
        self.kernels = dict(per_name)
        self.top_ops = sorted(((n, v[1]) for n, v in per_name.items()),
                              key=lambda x: -x[1])[:10]
        # the innermost span around a host instant
        spans.sort(key=lambda x: (x[0], -x[1]))
        starts = [s for s, _, _ in spans]

        def span_at(t: int) -> Optional[str]:
            i = bisect.bisect_right(starts, t)
            best = None
            for j in range(i - 1, max(i - 4096, -1), -1):
                s, e, name = spans[j]
                if s <= t < e and (best is None or s >= best[0]):
                    best = (s, e, name)
                    break
            return best[2] if best else None

        inside = 0
        for s, e, _, corr in device:
            t = launches.get(corr)
            label = span_at(t) if t is not None else None
            if label is not None:
                inside += 1
                self.span_device_s[label] += (e - s) * 1e-9
        # the share of the device's operations charged to a span: a check
        # that the two clocks agree, printed beside the run
        self.launches_in_spans = inside / len(device) if device else None
        prev = t0
        for s, e in busy + [(t1, t1)]:
            if s > prev:
                self.gaps[span_at((prev + s) // 2) or "host, no span"] += (
                    s - prev) * 1e-9
            prev = max(prev, e)

    def kernel_seconds(self, fragment: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds
        `fragment`."""
        n, s = 0, 0.0
        for name, (k, sec) in self.kernels.items():
            if fragment in name:
                n += k
                s += sec
        return n, s

    def breakdown(self) -> dict:
        return {"device_ops": [[n[:160], s] for n, s in self.top_ops],
                "idle_gaps": [[n, s] for n, s in sorted(
                    self.gaps.items(), key=lambda x: -x[1])[:10]]}
