"""Rational-rate polyphase resampling, scipy.signal.resample_poly's design.

Counterpart of `nelegan_tpu/dsp/resample.py`.  The reference package runs
the resampler as one `lax.conv_general_dilated` whose `lhs_dilation`
zero-stuffs the input; torch's convolutions have no input dilation, so the
input is zero-stuffed explicitly (up - 1 zeros between samples) and then
correlated with the reversed filter at stride `down` by `conv1d`, with the
reference package's padding, so output length and centring are the same to
the sample.  The FIR prototype is scipy's default (Kaiser beta 5.0,
10 * max(up, down) taps a side).  On the card the convolution goes through
cuDNN: callers turn TF32 off (`device.disable_tf32`).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _design_filter(up: int, down: int) -> np.ndarray:
    """scipy.signal.firwin(2 * half_len + 1, 1 / max_rate, window=("kaiser",
    5.0)) * up, written out: the windowed sinc, scaled to unit DC gain."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    m = np.arange(2 * half_len + 1) - half_len
    h = f_c * np.sinc(f_c * m) * np.kaiser(2 * half_len + 1, 5.0)
    return (h / h.sum() * up).astype(np.float64)


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Rational resample of ``x [..., n]`` by up/down (scipy-compatible),
    on x's device and in its dtype (float32 at least)."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x
    h = _design_filter(up, down)
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    half = (len(h) - 1) // 2
    dt = torch.promote_types(x.dtype, torch.float32)
    rows = x.reshape(-1, n_in).to(dt)
    stuffed = torch.zeros(rows.shape[0], (n_in - 1) * up + 1, dtype=dt,
                          device=x.device)
    stuffed[:, ::up] = rows
    pad_hi = max(half + (n_out - 1) * down - (n_in - 1) * up, 0) + len(h)
    lhs = F.pad(stuffed, (half, pad_hi))[:, None, :]
    rhs = torch.as_tensor(h[::-1].copy(), dtype=dt, device=x.device)
    y = F.conv1d(lhs, rhs[None, None, :], stride=down)[:, 0, :n_out]
    return y.reshape(x.shape[:-1] + (n_out,)).to(x.dtype)


def resample_16k_to_24k(x: torch.Tensor) -> torch.Tensor:
    return resample_poly(x, 3, 2)
