"""ViSQOL (speech mode) with a leading batch dimension.

Counterpart of `nelegan_tpu/metrics/visqol.py` (reference:
audio_util.py:232-265, which runs the ViSQOL binary; Hines et al., EURASIP
2015; Chinen et al., QoMEX 2020):

  1. gammatonegram: 32 ERB-spaced gammatone bands from 50 Hz over 32 ms,
     50 %-overlap power spectra, in dB, clamped to a RANGE_DB range below
     the louder signal's peak;
  2. the reference cut into 30-frame patches; patches more than 45 dB below
     the loudest, or not wholly inside the valid region, are excluded;
  3. patch alignment: each reference patch takes the best NSIM over
     +-SEARCH frame offsets in the degraded gammatonegram;
  4. NSIM: luminance times structure with a 3x3 box over (band, time),
     SAME zero padding (a `conv2d`, as the reference package's `lax.conv`;
     on the card TF32 must be off, `device.disable_tf32()`);
  5. mean NSIM over active patches -> MOS through 1 + MOS_A exp(MOS_Q
     (nsim - 1)), clipped to [1, 4.73].

Signals are ``[B, n]`` (or ``[n]``) with an optional per-row ``n_valid``;
the peaks, floors and patch gates are taken per row.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.stft import stft
from portbench.reference.metrics._framing import as_rows, const, on_device

FS = 16000
N_FFT = 512
HOP = 256
N_BANDS = 32
PATCH = 30           # frames per patch (ViSQOL kPatchSize)
SEARCH = 15          # +- frame search window for patch alignment
RANGE_DB = 50.0      # spectrogram dynamic range below the signal peak
# NSIM -> MOS-LQO: 1 + MOS_A exp(MOS_Q (nsim - 1)), the identity ceiling
# pinned at 4.73, MOS_Q fitted by tools/fit_visqol_map.py
MOS_A = 3.73
MOS_Q = 2.47


@functools.lru_cache(maxsize=None)
def _gammatone_matrix_50hz() -> np.ndarray:
    """[32, 257] squared-magnitude 4th-order gammatone responses, ERB-spaced
    50 Hz .. 8 kHz, row-normalised, float64."""
    ear_q, min_bw = 9.26449, 24.7
    f = np.linspace(0, FS / 2, N_FFT // 2 + 1)
    lo = np.log(50.0 + ear_q * min_bw)
    hi = np.log(FS / 2 + ear_q * min_bw)
    cf = np.exp(np.linspace(lo, hi, N_BANDS + 2))[1:-1] - ear_q * min_bw
    erb = min_bw + cf / ear_q
    g = np.zeros((N_BANDS, len(f)))
    for j in range(N_BANDS):
        g[j] = (1.0 + ((f - cf[j]) / (1.019 * erb[j])) ** 2) ** -4
    g /= g.sum(axis=1, keepdims=True)
    return g


def _smooth(v: torch.Tensor) -> torch.Tensor:
    """The 3x3 box mean over the last two axes, zero padding (SAME)."""
    img = v.reshape((-1, 1) + v.shape[-2:])
    k = torch.full((1, 1, 3, 3), 1.0 / 9.0, dtype=v.dtype, device=v.device)
    return torch.nn.functional.conv2d(img, k, padding=1).reshape(v.shape)


def _nsim(a: torch.Tensor, b: torch.Tensor, dyn: torch.Tensor
          ) -> torch.Tensor:
    """Mean NSIM between dB-gammatonegram patches a, b [..., bands, t]
    (broadcast against each other), dyn broadcast to their leading axes."""
    a, b = torch.broadcast_tensors(a, b)
    mu_a, mu_b = _smooth(a), _smooth(b)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    var_a = torch.maximum(_smooth(a * a) - mu_a ** 2, zero)
    var_b = torch.maximum(_smooth(b * b) - mu_b ** 2, zero)
    cov = _smooth(a * b) - mu_a * mu_b
    c1 = ((0.01 * dyn) ** 2)[..., None, None]
    c3 = ((0.03 * dyn) ** 2 / 2.0)[..., None, None]
    lum = (2.0 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    struct = (cov + c3) / (torch.sqrt(var_a * var_b) + c3)
    return (lum * struct).mean((-2, -1))


def visqol_nsim_16k(ref, deg, n_valid=None) -> torch.Tensor:
    """Mean aligned-patch NSIM in [~0, 1] of 16 kHz signals [n] or [B, n]
    (the ViSQOL similarity before the map to MOS)."""
    ref, nv, single = as_rows(ref, n_valid)
    deg = deg[None] if single else deg
    dt, dev = ref.dtype, ref.device
    rows, n = ref.shape
    if nv is not None:
        smask = (torch.arange(n, device=dev)[None, :] < nv[:, None]).to(dt)
        ref = ref * smask
        deg = deg * smask

    g = const(_gammatone_matrix_50hz(), ref)
    sr = 10.0 * torch.log10(g @ stft(ref).abs() ** 2 + 1e-10)  # [B, 32, T]
    sd = 10.0 * torch.log10(g @ stft(deg).abs() ** 2 + 1e-10)
    t = sr.shape[-1]
    if t < PATCH:        # sub-patch clips: pad the frames to one full patch
        sr = torch.nn.functional.pad(sr, (0, PATCH - t), value=-100.0)
        sd = torch.nn.functional.pad(sd, (0, PATCH - t), value=-100.0)
        if nv is None:
            nv = torch.full((rows,), n, device=dev)
        t = PATCH
    frames = torch.arange(t, device=dev)
    if nv is None:
        t_valid = torch.full((rows,), t, device=dev)
    else:
        t_valid = 1 + nv // HOP
    fmask = (frames[None, :] < t_valid[:, None])[:, None, :]   # [B, 1, T]

    # bounded-range floor: both gammatonegrams clamped to a positive dB
    # scale spanning RANGE_DB below the louder signal's peak, per row
    low = torch.full((), -1e9, dtype=dt, device=dev)
    hi = torch.maximum(torch.where(fmask, sr, low).amax((-2, -1)),
                       torch.where(fmask, sd, low).amax((-2, -1)))
    lo = (hi - RANGE_DB)[:, None, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    sr = torch.where(fmask, torch.maximum(sr - lo, zero), zero)
    sd = torch.where(fmask, torch.maximum(sd - lo, zero), zero)
    dyn = torch.maximum(sr.amax((-2, -1)), torch.ones((), dtype=dt,
                                                       device=dev))

    # reference patches (non-overlapping PATCH-frame blocks)
    n_patch = t // PATCH
    starts = np.arange(n_patch) * PATCH
    pidx = starts[:, None] + np.arange(PATCH)[None, :]        # [P, 30]
    rp = sr[:, :, torch.as_tensor(pidx, device=dev)]          # [B, 32, P, 30]
    rp = rp.movedim(2, 1)                                     # [B, P, 32, 30]

    # activity gate: within 45 dB of the loudest patch and wholly inside
    # the valid region; when no patch fits, the first patch
    p_peak = rp.amax((-2, -1))                                # [B, P]
    fully = torch.as_tensor(starts + PATCH, device=dev) <= t_valid[:, None]
    first = torch.arange(n_patch, device=dev) == 0
    inside = torch.where(fully.any(-1, keepdim=True), fully,
                         first & (t_valid > 1)[:, None])
    active = ((p_peak > p_peak.amax(-1, keepdim=True) - 45.0)
              & inside).to(dt)

    # patch alignment: candidate degraded windows at +-SEARCH offsets
    offs = np.arange(-SEARCH, SEARCH + 1)                     # [O]
    cand = pidx[:, None, :] + offs[None, :, None]             # [P, O, 30]
    valid_off = (cand >= 0).all(-1) & (cand < t).all(-1)      # [P, O]
    cand = torch.as_tensor(np.clip(cand, 0, t - 1), device=dev)
    dp = sd[:, :, cand].movedim(1, 3)                 # [B, P, O, 32, 30]
    sims = _nsim(rp[:, :, None], dp, dyn[:, None, None])      # [B, P, O]
    sims = torch.where(torch.as_tensor(valid_off, device=dev), sims,
                       torch.full((), -1.0, dtype=dt, device=dev))
    best = sims.amax(-1)                                      # [B, P]
    out = (best * active).sum(-1) / torch.clamp_min(active.sum(-1), 1.0)
    return out[0] if single else out


def visqol_speech_16k(ref, deg, n_valid=None) -> torch.Tensor:
    """ViSQOL speech-mode MOS-LQO in [1, ~4.73] of 16 kHz signals."""
    nsim = visqol_nsim_16k(ref, deg, n_valid)
    mos = 1.0 + MOS_A * torch.exp(MOS_Q * (nsim - 1.0))
    return torch.clamp(mos, 1.0, 4.73)


def visqol_speech(ref, deg, fs: int = 16000, device=None):
    """ViSQOL MOS of ref, deg trimmed to equal length.  Tensors are scored
    where they lie, host arrays on `device` (None: CUDA)."""
    assert fs == FS, "visqol_speech expects 16 kHz input"
    ref, deg = on_device(ref, device), on_device(deg, device)
    n = min(ref.shape[-1], deg.shape[-1])
    return visqol_speech_16k(ref[..., :n], deg[..., :n])
