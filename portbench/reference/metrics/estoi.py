"""Extended STOI (ESTOI) with a leading batch dimension.

Counterpart of `nelegan_tpu/metrics/estoi.py` (reference: intel.py:8,
122-134, pystoi `stoi(x, y, fs, extended=True)`; Jensen & Taal, IEEE TASLP
2016): fs 10 kHz, 256/128 open-Hann frames, nfft 512, 15 one-third-octave
bands from 150 Hz, 40 dB silence removal, N = 30-frame segments with row
and column normalisation.

The reference package's `vmap` over utterances is a leading batch
dimension here: the core functions take ``[B, n]`` (or ``[n]``) signals and
an optional per-row ``n_valid``.  Silence removal is a stable sort of the
keep mask (``torch.sort(..., stable=True)``) and a gather, so a padded row
scores as its trimmed signal does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.resample import resample_poly
from portbench.reference.metrics._framing import as_rows, const
from portbench.reference.metrics._framing import frame_exclusive as _frame

FS = 10000
N_FRAME = 256
HOP = 128
NFFT = 512
NUMBAND = 15
MINFREQ = 150.0
N_SEG = 30
DYN_RANGE = 40.0
_EPS = float(np.finfo(np.float64).eps)


@functools.lru_cache(maxsize=None)
def _third_octave_matrix() -> np.ndarray:
    """15 x 257 one-third-octave band matrix (pystoi thirdoct)."""
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    k = np.arange(NUMBAND, dtype=float)
    freq_low = MINFREQ * 2.0 ** ((2 * k - 1) / 6)
    freq_high = MINFREQ * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((NUMBAND, len(f)))
    for i in range(NUMBAND):
        fl = int(np.argmin(np.square(f - freq_low[i])))
        fh = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, fl:fh] = 1.0
    return obm


def _hann_open(n: int) -> np.ndarray:
    """np.hanning(n+2)[1:-1], the open Hann pystoi uses."""
    return np.hanning(n + 2)[1:-1]


def _compact(frames: torch.Tensor, order: torch.Tensor, live: torch.Tensor
             ) -> torch.Tensor:
    """frames [B, F, L] gathered in `order` [B, F], rows past the live
    count zeroed."""
    idx = order[..., None].expand(frames.shape)
    return torch.gather(frames, 1, idx) * live[..., None].to(frames.dtype)


def _select_frames(x: torch.Tensor, n_valid):
    """Clean-driven silence removal of x [B, n]: framing and the 40 dB keep
    mask, compacted to the front.  Returns (order [B, F], kcount [B], nf)."""
    xf = _frame(x, N_FRAME, HOP) * const(_hann_open(N_FRAME), x)
    nf = xf.shape[-2]
    energy = 20.0 * torch.log10(torch.linalg.vector_norm(xf, dim=-1) + _EPS)
    if n_valid is not None:
        # reference framing: frames with start < n - framelen
        starts = torch.arange(nf, device=x.device) * HOP
        in_range = starts[None, :] < (n_valid[:, None] - N_FRAME)
        energy = torch.where(in_range, energy, -torch.inf)
    keep = energy > (energy.amax(-1, keepdim=True) - DYN_RANGE)
    kcount = keep.sum(-1)
    order = torch.sort((~keep).to(torch.int32), dim=-1, stable=True).indices
    return order, kcount, nf


def _norm_segments(sig: torch.Tensor, order, kcount, nf: int):
    """One signal's half of the ESTOI core for sig [B, n]: compacted
    overlap-add, rFFT, third-octave envelopes, 30-frame segments, row and
    column normalisation.  Returns (segments [B, S, 15, 30], seg_valid
    [B, S])."""
    w = const(_hann_open(N_FRAME), sig)
    live = torch.arange(nf, device=sig.device)[None, :] < kcount[:, None]
    sk = _compact(_frame(sig, N_FRAME, HOP) * w, order, live)
    # overlap-add of the kept frames: HOP is N_FRAME/2, so each output
    # block is one frame's first half plus the previous frame's second half
    first, second = sk[..., :HOP], sk[..., HOP:]
    sil = (F.pad(first, (0, 0, 0, 1))
           + F.pad(second, (0, 0, 1, 0))).reshape(sig.shape[0], -1)
    ssf = _frame(sil, N_FRAME, HOP) * w
    n_spec = ssf.shape[-2]
    obm = const(_third_octave_matrix(), sig)
    ps = torch.abs(torch.fft.rfft(ssf, NFFT, dim=-1)) ** 2     # [B, F', 257]
    # epsilon inside the sqrt, as in the reference package
    tob = torch.sqrt(ps @ obm.T + 1e-20).transpose(-1, -2)     # [B, 15, F']
    n_segs = max(n_spec - N_SEG + 1, 0)           # none: the score is 0
    seg_idx = (torch.arange(n_segs, device=sig.device)[:, None]
               + torch.arange(N_SEG, device=sig.device)[None, :])
    seg = tob[:, :, seg_idx].permute(0, 2, 1, 3)               # [B, S, 15, 30]
    valid_frames = kcount - 1                                  # frames of sil
    seg_valid = ((torch.arange(n_segs, device=sig.device)[None, :] + N_SEG)
                 <= valid_frames[:, None])
    s = seg - seg.mean(-1, keepdim=True)
    # float64 from the first normalisation on, whatever sig's type, as the
    # reference package computes under x64 (its float64 epsilon promotes)
    s = s / torch.clamp_min(_norm(s, -1), _EPS).to(torch.float64)
    s = s - s.mean(-2, keepdim=True)
    s = s / torch.clamp_min(_norm(s, -2), _EPS)
    return s, seg_valid


def _norm(s: torch.Tensor, dim: int) -> torch.Tensor:
    """The l2 norm of s along `dim` (kept), value-exact, with a zero
    gradient where it is 0: a segment past the kept frames is constant, and
    sqrt's infinite derivative there would turn the clamp's zero gradient
    into NaN, so one padded or silent row would poison a batch's gradient
    (the reference package's ESTOI has that fault, ROADMAP.md section 3)."""
    ss = (s * s).sum(dim, keepdim=True)
    pos = ss > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, ss, 1.0)), 0.0)


def _mean_corr(xn, yn, seg_valid) -> torch.Tensor:
    corr = (xn * yn).sum((-2, -1)) / N_SEG                    # [B, S]
    v = seg_valid.to(corr.dtype)
    return (corr * v).sum(-1) / torch.clamp_min(v.sum(-1), 1)


def estoi_clean_10k(x: torch.Tensor, n_valid=None) -> dict:
    """Clean-side half of ESTOI, a function of the reference signal only
    (the silence mask is clean-driven), cacheable across scoring calls.
    Returns {"xn", "order", "kcount"}, each with x's leading dims."""
    xb, nv, single = as_rows(x, n_valid)
    order, kcount, nf = _select_frames(xb, nv)
    xn, _ = _norm_segments(xb, order, kcount, nf)
    out = {"xn": xn, "order": order.to(torch.int32),
           "kcount": kcount.to(torch.int32)}
    return {k: v[0] for k, v in out.items()} if single else out


def estoi_from_clean_10k(y: torch.Tensor, clean: dict, n_valid=None
                         ) -> torch.Tensor:
    """ESTOI of a degraded signal against a cached clean half
    (`estoi_clean_10k`); equal to `estoi_10k`.  The valid region is encoded
    in the clean half's order and count, so `n_valid` is not read."""
    del n_valid
    yb, _, single = as_rows(y, None)
    c = {k: (v[None] if single else v) for k, v in clean.items()}
    nf = c["order"].shape[-1]
    yn, seg_valid = _norm_segments(yb, c["order"].long(), c["kcount"], nf)
    out = _mean_corr(c["xn"], yn, seg_valid)
    return out[0] if single else out


def estoi_10k(x: torch.Tensor, y: torch.Tensor, n_valid=None
              ) -> torch.Tensor:
    """ESTOI of equal-length 10 kHz signals [n] or [B, n].

    `n_valid` (optional, per row): the number of real samples; frames past
    it are excluded as if the signal had been trimmed (the framing is
    exclusive), so a zero-padded row scores as its trimmed signal."""
    xb, nv, single = as_rows(x, n_valid)
    yb = y[None] if single else y
    order, kcount, nf = _select_frames(xb, nv)
    xn, _ = _norm_segments(xb, order, kcount, nf)
    yn, seg_valid = _norm_segments(yb, order, kcount, nf)
    out = _mean_corr(xn, yn, seg_valid)
    return out[0] if single else out


def estoi(x, y, fs: int = 16000, n_valid=None) -> torch.Tensor:
    """ESTOI with internal resampling (pystoi `stoi(..., extended=True)`).
    Trims to the shorter signal like the reference wrappers (intel.py:
    122-127).  With `n_valid`, the inputs are zero-padded buffers of a
    common length and scoring is that of the valid prefix."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    n = min(x.shape[-1], y.shape[-1])
    x, y = x[..., :n], y[..., :n]
    if fs != FS:
        from math import gcd
        g = gcd(FS, fs)
        x = resample_poly(x, FS // g, fs // g)
        y = resample_poly(y, FS // g, fs // g)
        if n_valid is not None:
            n_valid = -(-torch.as_tensor(n_valid) * (FS // g) // (fs // g))
    return estoi_10k(x, y, n_valid)
