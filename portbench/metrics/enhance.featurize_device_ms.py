"""Device milliseconds a batch of the kernels launched inside
`featurize_batch` (STFT, bands, the IMCRA kernel), charged by the profiler
to the benchmark's `pb.featurize` span around the call.  Layer: batch
program (`pipeline.py`).  Moves `enhance_utts_per_s`."""
from portbench.metrics import _common as _c

UNIT = "ms"


def read(ctx):
    batches = _c.enhance_batches(ctx)
    if batches is None:
        return None
    s = ctx.window.span_device_s.get("pb.featurize", 0.0)
    return 1e3 * s / len(batches) if s > 0 else None
