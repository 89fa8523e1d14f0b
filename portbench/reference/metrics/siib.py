"""SIIB^Gauss, speech intelligibility in bits, with a leading batch
dimension.

Counterpart of `nelegan_tpu/metrics/siib.py` (reference: intel.py:4,57-100,
pysiib `SIIB(x, y, fs, gauss=True)`; Van Kuyk, Kleijn & Hendriks, IEEE SPL
2018 and IEEE/ACM TASLP 2018).  Silence removal (40 dB), 400/200 Hann STFT,
40 ERB-spaced gammatone log-energies, per-band mean removal, stacking of
K = 15 frames, the KLT (eigenvectors of the clean covariance, here
`torch.linalg.eigh` of [B, 600, 600]), per-dimension correlations and the
Gaussian capacity with production noise rho_p^2 = 0.75:

    SIIB = -0.5 * sum_j log2(1 - rho_p^2 rho_j^2) * frame_rate / K   [bits/s]

An eigenvector is fixed only up to its sign, and in a degenerate eigenspace
up to a rotation of that space; the capacity reads the squared correlation
of each direction, which is the same for either sign, so the score does not
depend on the sign `eigh` returns.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.resample import resample_poly
from portbench.reference.metrics._framing import as_rows, const
from portbench.reference.metrics._framing import frame_exclusive as _frame
from portbench.reference.metrics.estoi import _compact

FS = 16000
WIN = 400
HOP = 200
NFFT = 512
J_BANDS = 40
K_STACK = 15
RHO_P2 = 0.75
DYN_RANGE = 40.0
_EPS = float(np.finfo(np.float64).eps)


def _erb_space(flow: float, fhigh: float, n: int) -> np.ndarray:
    ear_q, min_bw = 9.26449, 24.7
    lo = np.log(flow + ear_q * min_bw)
    hi = np.log(fhigh + ear_q * min_bw)
    return np.exp(np.linspace(lo, hi, n)) - ear_q * min_bw


@functools.lru_cache(maxsize=None)
def _gammatone_matrix() -> np.ndarray:
    """[J, 257] squared-magnitude 4th-order gammatone responses, ERB-spaced
    100 Hz .. 6500 Hz, row-normalised."""
    f = np.linspace(0, FS / 2, NFFT // 2 + 1)
    cf = _erb_space(100.0, 6500.0, J_BANDS)
    erb = 24.7 + cf / 9.26449
    g = np.zeros((J_BANDS, len(f)))
    for j in range(J_BANDS):
        g[j] = (1.0 + ((f - cf[j]) / (1.019 * erb[j])) ** 2) ** -4
    g /= g.sum(axis=1, keepdims=True)
    return g


def _stack_pair(x: torch.Tensor, y: torch.Tensor | None, n_valid):
    """The SIIB front end of x, y [B, n]: framing, clean-driven silence
    removal, gammatone log-energies, mean removal, K-frame stacking.

    Returns (vx, vy, scnt): zero-mean stacked vectors [B, S, K*J] of both
    signals (vy None when y is None) and the live-vector count [B], all
    float64.

    The whole front end runs in float64, whatever the signals' type (the
    reference's pysiib is float64 throughout).  The KLT of a tiled
    utterance's covariance can be so ill-conditioned that float32
    round-off in the clean log-energies turns it: on the card a float32
    front end scored one utterance 2% apart depending on whether its KLT
    was taken alone (a pool miss) or beside the degraded signal, that is on
    the FFT batch it ran in."""
    x = x.to(torch.float64)
    y = None if y is None else y.to(torch.float64)
    w = const(np.hanning(WIN + 2)[1:-1], x)
    xf = _frame(x, WIN, HOP) * w
    nf = xf.shape[-2]
    energy = 20.0 * torch.log10(torch.linalg.vector_norm(xf, dim=-1) + _EPS)
    if n_valid is not None:
        starts = torch.arange(nf, device=x.device) * HOP
        energy = torch.where(starts[None, :] < (n_valid[:, None] - WIN),
                             energy, -torch.inf)
    keep = energy > (energy.amax(-1, keepdim=True) - DYN_RANGE)
    kcount = keep.sum(-1)
    order = torch.sort((~keep).to(torch.int32), dim=-1, stable=True).indices
    live = torch.arange(nf, device=x.device)[None, :] < kcount[:, None]
    sides = [_compact(xf, order, live)]
    if y is not None:
        sides.append(_compact(_frame(y, WIN, HOP) * w, order, live))
    xy = torch.stack(sides, 1)                               # [B, S2, F, WIN]

    g = const(_gammatone_matrix(), x)
    p2 = torch.abs(torch.fft.rfft(xy, NFFT, dim=-1)) ** 2     # [B, S2, F, 257]
    # float64 (the reference package promotes from here on under x64, its
    # float64 epsilon promoting e2): in float32 the KLT of a tiled
    # utterance's nearly rank-deficient covariance leaks into its null
    # space, and the capacity reads those directions' round-off (a 1-s
    # utterance: 31.4 bits/s against 20.1)
    e2 = torch.log(p2 @ g.T + _EPS)                          # [B, S2, F, J]
    f64 = e2.dtype
    livef = live.to(f64)[:, None, :, None]
    cnt = torch.clamp_min(kcount, 1).to(f64)[:, None, None, None]
    e2 = (e2 - (e2 * livef).sum(2, keepdim=True) / cnt) * livef

    s = nf - K_STACK + 1
    idx = (torch.arange(s, device=x.device)[:, None]
           + torch.arange(K_STACK, device=x.device)[None, :])
    v2 = e2[:, :, idx].reshape(x.shape[0], len(sides), s, K_STACK * J_BANDS)
    vlive = ((torch.arange(s, device=x.device)[None, :] + K_STACK)
             <= kcount[:, None]).to(f64)                     # [B, S]
    scnt = torch.clamp_min(vlive.sum(-1), 1.0)
    vl = vlive[:, None, :, None]
    v2 = (v2 - (v2 * vl).sum(2, keepdim=True)
          / scnt[:, None, None, None]) * vl
    return v2[:, 0], (v2[:, 1] if y is not None else None), scnt


def _capacity(vx: torch.Tensor, vy: torch.Tensor, u: torch.Tensor
              ) -> torch.Tensor:
    """Gaussian channel capacity (bits/s) in the KLT basis u [B, KJ, KJ]."""
    kx = vx @ u                                              # [B, S, KJ]
    ky = vy @ u
    xs = (kx * kx).sum(-2)
    ys = (ky * ky).sum(-2)
    xy = (kx * ky).sum(-2)
    rho2 = (xy * xy) / torch.clamp_min(xs * ys, _EPS)
    rho2 = torch.clamp(rho2, 0.0, 1.0 - 1e-7)
    bits_per_vec = -0.5 * torch.log2(1.0 - RHO_P2 * rho2).sum(-1)
    return bits_per_vec * (FS / HOP) / K_STACK


def _klt(vx: torch.Tensor, scnt: torch.Tensor) -> torch.Tensor:
    cov = (vx.transpose(-1, -2) @ vx) / scnt[:, None, None]   # [B, KJ, KJ]
    return torch.linalg.eigh(cov)[1]


def _unbatch(out, single: bool):
    return out[0] if single else out


def siib_klt_16k(x: torch.Tensor, n_valid=None) -> torch.Tensor:
    """KLT basis (eigenvectors of the stacked-vector covariance) of a clean
    16 kHz signal [n] or [B, n]: a function of the clean side only, so it
    can be cached across scoring calls."""
    xb, nv, single = as_rows(x, n_valid)
    vx, _, scnt = _stack_pair(xb, None, nv)
    return _unbatch(_klt(vx, scnt), single)


def siib_gauss_16k_with_klt(x: torch.Tensor, y: torch.Tensor, n_valid,
                            u: torch.Tensor) -> torch.Tensor:
    """SIIB^Gauss given a precomputed KLT basis of the clean signal."""
    xb, nv, single = as_rows(x, n_valid)
    yb, ub = (y[None], u[None]) if single else (y, u)
    vx, vy, _ = _stack_pair(xb, yb, nv)
    return _unbatch(_capacity(vx, vy, ub), single)


def siib_gauss_16k(x: torch.Tensor, y: torch.Tensor, n_valid=None
                   ) -> torch.Tensor:
    """SIIB^Gauss of equal-length 16 kHz signals [n] or [B, n] (bits/s).
    `n_valid` (optional, per row): the true sample count of zero-padded
    buffers; frames past it are excluded exactly."""
    xb, nv, single = as_rows(x, n_valid)
    yb = y[None] if single else y
    vx, vy, scnt = _stack_pair(xb, yb, nv)
    return _unbatch(_capacity(vx, vy, _klt(vx, scnt)), single)


def _vad_mask(x: np.ndarray, window_length=400, window_shift=200,
              delta_db=40.0) -> np.ndarray:
    """Host-side VAD of the reference wrapper's get_vad (intel.py:37-50):
    a frame-power percentile threshold."""
    n = x.shape[-1]
    if n < window_length + 1:
        x = np.pad(x, (0, window_length + 1 - n))
    nfr = x.shape[-1] - window_length
    starts = np.arange(0, nfr, window_shift)
    w = np.hanning(window_length + 2)[1:-1]
    frames = x[starts[:, None] + np.arange(window_length)[None, :]] * w
    xdb = 10 * np.log10((frames ** 2).mean(axis=1) + _EPS)
    ind = int(round(len(xdb) * 0.999) - 1)
    max_x = np.partition(xdb, ind)[ind]
    return xdb > (max_x - delta_db)


def tile_factor(x: np.ndarray) -> int:
    """The tile-to-20-s rule (intel.py:93-97): an utterance with under 20 s
    of active speech is repeated floor(25 / active seconds) times."""
    active_sec = _vad_mask(x).sum() / (FS / HOP)
    if active_sec < 20:
        return max(int(np.floor(25.0 / max(active_sec, 0.25))), 1)
    return 1


def siib_prepare(x, y, fs: int = 16000, bucket: int | None = None):
    """Host-side wrapper prep (reference intel.py:79-100): trim, resample,
    tile to 20 s of active speech, and optionally zero-pad to `bucket`.
    Returns (x_t, y_t, n_valid) as numpy arrays and an int."""
    n = min(x.shape[-1], y.shape[-1])
    x = np.asarray(x)[..., :n]
    y = np.asarray(y)[..., :n]
    if fs != FS:
        from math import gcd
        g = gcd(FS, fs)
        x = resample_poly(torch.as_tensor(x), FS // g, fs // g).numpy()
        y = resample_poly(torch.as_tensor(y), FS // g, fs // g).numpy()
    m = tile_factor(x)
    if m > 1:
        x = np.tile(x, m)
        y = np.tile(y, m)
    n_valid = x.shape[-1]
    if bucket is not None:
        assert n_valid <= bucket, (n_valid, bucket)
        x = np.pad(x, (0, bucket - n_valid))
        y = np.pad(y, (0, bucket - n_valid))
    return x, y, n_valid


def siib(x, y, fs: int = 16000, use_vad_tiling: bool = True,
         device=None) -> torch.Tensor:
    """SIIB^Gauss with the reference wrapper's tile-to-20-s rule of
    host signals x, y (numpy), scored on `device` (None: CUDA)."""
    from portbench.reference.device import resolve_device
    dev = resolve_device(device)
    if use_vad_tiling:
        x, y, _ = siib_prepare(x, y, fs)
    else:
        n = min(x.shape[-1], y.shape[-1])
        x, y = np.asarray(x)[..., :n], np.asarray(y)[..., :n]
    return siib_gauss_16k(torch.as_tensor(x, device=dev),
                          torch.as_tensor(y, device=dev))
