"""STFT / iSTFT with librosa semantics (reference: audio_util.py:53-65).

librosa semantics, as the goldens pin them:

  * centered frames: the signal is padded with ``n_fft // 2`` samples of
    numpy-style (repeated) reflection on both ends,
  * a *periodic* Hann window,
  * ``rfft`` per frame -> ``[..., n_fft//2 + 1, T]`` complex (bins first),
  * iSTFT: per-frame ``irfft`` * window, overlap-add, division by the
    overlap-added squared window (left as-is where it is ~0), then the
    centre padding is trimmed from both ends.

``torch.stft``/``torch.istft`` pad and normalise differently, so framing
and overlap-add are written out here.  Windows take the frames' dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_periodic(n: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window in float64, equal to
    ``scipy.signal.get_window('hann', n, fftbins=True)``."""
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def ola_norm_half_overlap(n_fft: int = 512) -> np.ndarray:
    """Interior squared-window OLA normaliser [n_fft//2] for hop = n_fft/2:
    every emitted block sees w^2[n] + w^2[n + hop]."""
    w2 = np.asarray(hann_periodic(n_fft)) ** 2
    return w2[:n_fft // 2] + w2[n_fft // 2:]


@functools.lru_cache(maxsize=None)
def _reflect_indices(n: int, pad: int) -> np.ndarray:
    """Gather indices for numpy-style reflect padding of a length-n axis;
    pad >= n reflects repeatedly, as np.pad does."""
    idx = np.arange(-pad, n + pad)
    period = max(2 * (n - 1), 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """Slice ``x [..., n]`` into overlapping frames ``[..., T, n_fft]``."""
    if center:
        idx = torch.from_numpy(_reflect_indices(x.shape[-1], n_fft // 2))
        x = x[..., idx.to(x.device)]
    return x.unfold(-1, n_fft, hop)


def stft(x: torch.Tensor, n_fft: int = 512, hop: int = 256,
         center: bool = True) -> torch.Tensor:
    """librosa-compatible STFT (window length n_fft): real ``[..., n]`` ->
    complex ``[..., n_fft//2+1, T]``."""
    frames = frame_signal(x, n_fft, hop, center)                # [..., T, n_fft]
    window = torch.as_tensor(hann_periodic(n_fft), dtype=frames.dtype,
                             device=frames.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)    # [..., T, bins]
    return spec.transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int = 512, hop: int = 256,
          center: bool = True) -> torch.Tensor:
    """librosa-compatible inverse STFT: complex ``[..., bins, T]`` -> real
    ``[..., (T-1)*hop]`` when centred."""
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    win_np = hann_periodic(n_fft)
    frames = frames * torch.as_tensor(win_np, dtype=frames.dtype,
                                      device=frames.device)
    lead = frames.shape[:-2]
    t = frames.shape[-2]
    full = n_fft + hop * (t - 1)

    # overlap-add: out[f*hop : f*hop + n_fft] += frame f
    cols = frames.reshape(-1, t, n_fft).transpose(1, 2)        # [N, n_fft, T]
    y = F.fold(cols, output_size=(1, full), kernel_size=(1, n_fft),
               stride=(1, hop)).reshape(lead + (full,))

    # squared-window normaliser (librosa window_sumsquare), from shapes only
    wsq = np.zeros(full)
    w2 = win_np ** 2
    for i in range(t):
        wsq[i * hop:i * hop + n_fft] += w2
    tiny = np.finfo(np.float32).tiny
    wsq = np.where(wsq > tiny, wsq, 1.0)
    y = y / torch.as_tensor(wsq, dtype=y.dtype, device=y.device)

    if center:
        y = y[..., n_fft // 2: full - n_fft // 2]
    return y
