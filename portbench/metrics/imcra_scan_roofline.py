"""The IMCRA kernel's share of its roofline in the traced enhancement
batches: the least time the card could take for each launch, the larger
of its bytes (|Y|^2 in and the noise PSD out, [rows, frames, 257] float32,
each once) over 3.35 TB/s and its operations over 67 TFLOP/s, summed,
over the profiler's device time of `imcra_scan_kernel`.  The count follows
from the batch's shape, not from how the kernel is written.  Layer:
kernels (`csrc/imcra.cu`).  Moves `enhance_utts_per_s`."""
from portbench import flops
from portbench.metrics import _common as _c

UNIT = "%"


def read(ctx):
    batches = _c.enhance_batches(ctx)
    if batches is None:
        return None
    n, seconds = ctx.window.kernel_seconds("imcra_scan_kernel")
    if n != len(batches) or seconds <= 0:
        return None
    bound = sum(flops.roofline_seconds(flops.imcra_ops(rows, frames),
                                       flops.imcra_bytes(rows, frames))
                for rows, frames in batches)
    return 100.0 * bound / seconds
