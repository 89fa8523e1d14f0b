"""Operations and bytes of the model and the IMCRA scan, from shapes alone,
and the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W limit).

A multiply-add counts two operations.  Only the convolutions and dense
layers count (the normalisations, activations and pools are a few
operations an element against hundreds a multiply-add chain); a forward
pass is `*_forward_flops`, a training step three forward passes for the
models that get weight gradients (forward, input gradient, weight
gradient) and two for the frozen discriminators the generator's loss
passes through (forward, input gradient).
"""
from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # without TF32
HBM_BYTES_PER_S = 3.35e12
# IMCRA's operations an element (bin) and frame: the plain step
# (`reference/imcra.py`, `imcra_step`) counted line by line, the
# frequency smoothing's 3-tap sums, the speech-presence probability and the
# minimum tracking (every 15th frame) included: about 80.
IMCRA_OPS_PER_BIN_FRAME = 80


def generator_forward_flops(model: dict, frames: int) -> float:
    """One row of `frames` frames through the generator: causal conv1d
    blocks 2*bands -> hidden -> ... -> bands, then two dense bands x bands."""
    nb, hid, n = model["n_bands"], model["gen_hidden"], model["gen_blocks"]
    ins = [2 * nb] + [hid] * (n - 1)
    outs = [hid] * (n - 1) + [nb]
    ks = ([model["gen_kernel_first"]] + [model["gen_kernel_mid"]] * (n - 2)
          + [model["gen_kernel_last"]])
    macs = sum(i * o * k for i, o, k in zip(ins, outs, ks)) + 2 * nb * nb
    return 2.0 * macs * frames


def discriminator_forward_flops(model: dict, in_ch: int, n_scores: int,
                                frames: int) -> float:
    """One [in_ch, bands, frames] image through a spectral-norm trunk (VALID
    convs) and its 64-64-16-n head."""
    h, w = model["n_bands"], frames
    macs = 0
    prev = in_ch
    for c, k in zip(model["disc_channels"], model["disc_kernels"]):
        h, w = h - k + 1, max(w - k + 1, 0)
        macs += h * w * prev * c * k * k
        prev = c
    macs += prev * 64 + 64 * 16 + 16 * n_scores
    return 2.0 * macs


def d_pair_forward_flops(model: dict, frames: int) -> float:
    return (discriminator_forward_flops(model, 3, model["n_intel_scores"],
                                        frames)
            + discriminator_forward_flops(model, 2, model["n_quality_scores"],
                                          frames))


def g_step_flops(model: dict, rows: int, frames: int) -> float:
    return rows * (3 * generator_forward_flops(model, frames)
                   + 2 * d_pair_forward_flops(model, frames))


def d_step_flops(model: dict, rows: int, frames: int) -> float:
    return rows * 3 * d_pair_forward_flops(model, frames)


def imcra_bytes(rows: int, frames: int, bins: int = 257) -> float:
    """|Y|^2 in and the noise PSD out, float32, each once."""
    return 2.0 * 4 * rows * frames * bins


def imcra_ops(rows: int, frames: int, bins: int = 257) -> float:
    return float(IMCRA_OPS_PER_BIN_FRAME) * rows * frames * bins


def roofline_seconds(ops: float, nbytes: float, dtype: str = "float32"
                     ) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])
