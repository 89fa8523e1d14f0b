"""Reverberation utilities for the reverb-condition evaluation.

Counterpart of `nelegan_tpu/dsp/reverb.py`, after the reference's
eval_metrics.py helpers: the RIR convolution `scipy.signal.lfilter(rir, 1, x)`
becomes an FFT convolution (reference: eval_metrics.py:131-136), the
direct-path RIR keeps argmax + 32 taps (eval_metrics.py:127-130), and
`clip_overflow` is the reference's iterative overflow guard
(audio_util.py:67-74).
"""
from __future__ import annotations

import numpy as np
import torch


def fir_filter(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """lfilter(h, [1], x): causal FIR along the last axis, output as long as
    x, in x's dtype."""
    n, m = x.shape[-1], h.shape[-1]
    full = torch.fft.irfft(torch.fft.rfft(x, n + m) * torch.fft.rfft(h, n + m),
                           n + m)
    return full[..., :n].to(x.dtype)


def direct_path_rir(rir: np.ndarray, tau: int = 32) -> np.ndarray:
    """Truncate an RIR to its direct path: argmax + tau taps, zero tail."""
    b = int(np.argmax(rir))
    out = np.zeros_like(rir)
    out[:b + tau] = rir[:b + tau]
    return out


def clip_overflow(x: np.ndarray) -> np.ndarray:
    """Shrink by growing factors (1.05, 1.10, ...) until the signal fits in
    [-1, 1), as the reference's `clip` does."""
    small = 0.05
    while np.max(x) >= 1 or np.min(x) < -1:
        x = x / (1.0 + small)
        small += 0.05
    return x
