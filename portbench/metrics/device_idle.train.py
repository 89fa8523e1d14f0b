"""Share of the traced training epoch (one epoch after the measured window,
profiled with the device's activity alone) in which no kernel, copy or set
ran on the device, from the profiler's timeline.  Layer: device.  Moves
`train_utts_per_s`."""
from portbench.metrics import _common as _c

UNIT = "%"


def read(ctx):
    if _c.train_window(ctx) is None:
        return None
    return _c.idle_percent(ctx)
