"""Share of the traced enhancement batches' window in which no kernel,
copy or set ran on the device, from the profiler's timeline.  Layer:
device.  Moves `enhance_utts_per_s`."""
from portbench.metrics import _common as _c

UNIT = "%"


def read(ctx):
    if _c.enhance_batches(ctx) is None:
        return None
    return _c.idle_percent(ctx)
