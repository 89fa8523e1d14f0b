"""Model FLOPs of the measured training window's G and D steps (forward
and backward, from the configuration's widths and each step's rows and
frames, `portbench/flops.py`) over the window's time, as a share of the
policy's published peak: 67 TFLOP/s for float32 without TF32, 989 TFLOP/s
for bfloat16.  The window is untraced: the steps are counted as they
run.  Layer: model step.  Moves `train_utts_per_s`."""
from portbench import flops
from portbench.metrics import _common as _c

UNIT = "%"


def read(ctx):
    w = _c.train_window(ctx)
    if w is None or not w[1]:
        return None
    _, steps, window_s = w
    model = ctx.layer["model"]
    total = sum(flops.g_step_flops(model, rows, frames) if kind == "g"
                else flops.d_step_flops(model, rows, frames)
                for kind, rows, frames in steps)
    return 100.0 * total / window_s / flops.PEAK_FLOPS[model["compute_dtype"]]
