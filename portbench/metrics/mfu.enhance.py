"""Generator forward FLOPs of the measured enhancement window's batches
(from the configuration's widths and each batch's rows and frames,
`portbench/flops.py`) over the window's time, as a share of the float32
peak without TF32, 67 TFLOP/s.  The window is untraced.  Layer: model
forward (`models/generator.py`).  Moves `enhance_utts_per_s`."""
from portbench import flops

UNIT = "%"


def read(ctx):
    w = ctx.layer.get("window")
    ran = ctx.layer.get("window_batches")
    if not ctx.trace or w is None or not ran or w["window_s"] <= 0:
        return None
    model = ctx.layer["model"]
    total = sum(count * rows * flops.generator_forward_flops(model, frames)
                for rows, frames, count in ran)
    return (100.0 * total / w["window_s"]
            / flops.PEAK_FLOPS[model["compute_dtype"]])
