"""Post-ear-model metric chains of HASPI v1/v2 and HASQI v2.

Counterpart of `nelegan_tpu/metrics/haspi/chains.py` (reference:
pyHASPI/pyhaspi2.py:161-751), every table and threshold the same:

  * segment framing (eb_EnvSmooth, eb_BMcovary) as gathered frames with
    per-frame window rows;
  * the above-threshold compaction of ebm_CepCoef as a stable sort of the
    keep mask (``torch.sort(..., stable=True)``) and a gather, with masks;
  * the envelope filter of ebm_EnvFilt and the modulation filterbank of
    ebm_ModFilt as batched FFT convolutions;
  * the +-1 ms cross-covariance (eb_BMcovary) over its 49 lags, and the
    three-level histogram (eb_3LevelCovary) with the round-half-up bin rule.

The HASPI v2 chain (`env_filt_one`, `cep_coef`, `mod_filt_corr`) takes a
leading batch dimension; the v1 and HASQI pieces take one utterance.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.metrics._framing import const as _const
from portbench.reference.metrics.haspi.ear_model import bm_noise

FSAMP = 24000


def _corr_time(v: torch.Tensor, kernel: np.ndarray, pad_lo: int,
               pad_hi: int) -> torch.Tensor:
    """Correlate each row of v [..., T] with a 1-D kernel along time, the
    rows zero-padded by (pad_lo, pad_hi), as one FFT convolution with the
    reversed kernel (the reference package's lax.conv computes the same
    sums; a float64 conv1d on the CPU took seconds at HASPI's sizes)."""
    k = len(kernel)
    rows = F.pad(v, (pad_lo, pad_hi))
    n_out = rows.shape[-1] - k + 1
    m = 1
    while m < rows.shape[-1] + k - 1:
        m *= 2
    kf = torch.fft.rfft(torch.as_tensor(kernel[::-1].copy(), dtype=v.dtype,
                                        device=v.device), m)
    full = torch.fft.irfft(torch.fft.rfft(rows, m) * kf, m)
    return full[..., k - 1:k - 1 + n_out]


def _sorted_front(keep: torch.Tensor) -> torch.Tensor:
    """Stable order moving the True entries of keep [..., n] to the front."""
    return torch.sort((~keep).to(torch.int32), dim=-1, stable=True).indices


# ---------------------------------------------------------------------------
# segment framing shared by eb_EnvSmooth / eb_BMcovary
# ---------------------------------------------------------------------------

def _n_segments(npts: int, nwin: int) -> int:
    return int(1 + npts // nwin + (npts - nwin // 2) // nwin)


@functools.lru_cache(maxsize=None)
def _seg_layout(npts: int, segsize_ms: int = 16, fsamp: int = FSAMP):
    """Static framing tables: index matrix [nseg, nwin] and window rows."""
    nwin = round(segsize_ms * 0.001 * fsamp)
    if nwin % 2:
        nwin += 1
    nhalf = nwin // 2
    window = np.hanning(nwin)
    nseg = _n_segments(npts, nwin)
    idx = (np.arange(nseg)[:, None] * nhalf + np.arange(nwin)[None, :])
    wmat = np.tile(window, (nseg, 1))
    # first segment: data r[0:nhalf] weighted by window[nhalf:]
    wmat[0] = 0.0
    wmat[0, :nhalf] = window[nhalf:]
    idx[0] = np.concatenate([np.arange(nhalf), np.zeros(nhalf, int)])
    # last segment: nhalf samples, window[:nhalf]
    wmat[-1, nhalf:] = 0.0
    valid = idx < npts
    idx = np.clip(idx, 0, npts - 1)
    wmat = wmat * valid
    wsum = window.sum()
    halfsum = window[nhalf:].sum()
    norms = np.full(nseg, wsum)
    norms[0] = norms[-1] = halfsum
    return idx, wmat, norms, nwin, nhalf, window


def env_smooth(env: torch.Tensor, segsize_ms: int = 16,
               fsamp: int = FSAMP) -> torch.Tensor:
    """Windowed segment averages (reference eb_EnvSmooth,
    pyhaspi2.py:673-703): env [nchan, npts] -> [nchan, nseg]."""
    idx, wmat, norms, _, _, _ = _seg_layout(env.shape[-1], segsize_ms, fsamp)
    frames = env[..., torch.as_tensor(idx, device=env.device)]
    return (frames * _const(wmat, env)).sum(-1) / _const(norms, env)


# ---------------------------------------------------------------------------
# mel-cepstral correlation (HASPI v1 / HASQI)
# ---------------------------------------------------------------------------

def _cep_basis(nbands: int, nbasis: int) -> np.ndarray:
    freq = np.arange(nbasis)
    k = np.arange(nbands)
    cepm = np.cos(freq[None, :] * np.pi * k[:, None] / (nbands - 1))
    return cepm / np.linalg.norm(cepm, axis=0, keepdims=True)


def melcor(x: torch.Tensor, y: torch.Tensor, thr: float = 2.5):
    """Cepstral correlation (reference eb_melcor, pyhaspi2.py:706-751).
    x, y: [nbands, nseg] smoothed envelopes in dB -> (m1, xy [nbasis])."""
    nbands = x.shape[0]
    nbasis = 6
    cepm = _const(_cep_basis(nbands, nbasis), x)
    xsum = 20.0 * torch.log10((10.0 ** (x / 20.0)).sum(0) / nbands)
    sel = (xsum > thr).to(x.dtype)                         # [nseg]
    nsel = torch.clamp_min(sel.sum(), 1.0)
    xcep = cepm.T @ (x * sel)                              # [nbasis, nseg]
    ycep = cepm.T @ (y * sel)
    xcep = (xcep - (xcep * sel).sum(-1, keepdim=True) / nsel) * sel
    ycep = (ycep - (ycep * sel).sum(-1, keepdim=True) / nsel) * sel
    small = 1e-30
    xs = (xcep * xcep).sum(-1)
    ys = (ycep * ycep).sum(-1)
    xy = torch.where((xs < small) | (ys < small), 0.0,
                     torch.abs((xcep * ycep).sum(-1))
                     / torch.sqrt(torch.clamp_min(xs * ys, small)))
    m1 = xy[1:].sum() / (nbasis - 1)
    return m1, xy


# ---------------------------------------------------------------------------
# BM cross-covariance (HASPI v1 / HASQI)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _xcorr_norms(segsize_ms: int = 16, fsamp: int = FSAMP,
                 lag_ms: float = 1.0):
    """1/xcorr(window) lag-normalisation rows (the reference freezes them
    as MATLAB outputs, pyhaspi2.py:564,571)."""
    nwin = round(segsize_ms * 0.001 * fsamp)
    if nwin % 2:
        nwin += 1
    maxlag = round(lag_ms * 0.001 * fsamp)
    window = np.hanning(nwin)
    nhalf = nwin // 2
    half = window[nhalf:]

    def inv_autocorr(w):
        full = np.correlate(w, w, "full")
        c = len(full) // 2
        return 1.0 / full[c - maxlag:c + maxlag + 1]

    return (inv_autocorr(window), inv_autocorr(half),
            1.0 / np.sum(window ** 2), 1.0 / np.sum(half ** 2), maxlag)


def bm_covary(xbm: torch.Tensor, ybm: torch.Tensor, segsize_ms: int = 16,
              fsamp: int = FSAMP):
    """Time-frequency segment cross-covariance (reference eb_BMcovary,
    pyhaspi2.py:550-659): xbm, ybm [nchan, npts] -> (sigcov, msx, msy),
    each [nchan, nseg]."""
    npts = xbm.shape[-1]
    idx, wmat, _, nwin, nhalf, _ = _seg_layout(npts, segsize_ms, fsamp)
    wincorr, halfcorr, winsum2, halfsum2, maxlag = _xcorr_norms(
        segsize_ms, fsamp)
    nseg = idx.shape[0]
    idx_t = torch.as_tensor(idx, device=xbm.device)
    wm = _const(wmat, xbm)
    segx = xbm[..., idx_t] * wm                        # [nchan, nseg, nwin]
    segy = ybm[..., idx_t] * wm
    seg_len = np.full(nseg, float(nwin))
    seg_len[0] = seg_len[-1] = float(nhalf)
    seg_len_t = _const(seg_len, xbm)[None, :, None]
    segx = segx - segx.sum(-1, keepdim=True) / seg_len_t
    segy = segy - segy.sum(-1, keepdim=True) / seg_len_t
    # re-zero positions past seg_len on the half-length first/last segments
    live = _const(np.arange(nwin)[None, :] < seg_len[:, None], xbm)
    segx = segx * live
    segy = segy * live
    ms_norm = np.full(nseg, winsum2)
    ms_norm[0] = ms_norm[-1] = halfsum2
    ms_norm_t = _const(ms_norm, xbm)
    msx = (segx * segx).sum(-1) * ms_norm_t            # [nchan, nseg]
    msy = (segy * segy).sum(-1) * ms_norm_t
    # xc[l] = sum_n segx[n] * segy[n + l - maxlag], one lag at a time
    segy_pad = F.pad(segy, (maxlag, maxlag))
    xc = torch.stack([(segx * segy_pad[..., l:l + nwin]).sum(-1)
                      for l in range(2 * maxlag + 1)], -1)   # [c, s, 49]
    corr_tbl = np.tile(wincorr, (nseg, 1))
    corr_tbl[0] = halfcorr
    corr_tbl[-1] = halfcorr
    mxy = torch.abs(xc * _const(corr_tbl, xbm)).amax(-1)
    small = 1e-30
    sigcov = torch.where((msx > small) & (msy > small),
                         mxy / torch.sqrt(torch.clamp_min(msx * msy, small)),
                         0.0)
    sigcov = torch.clamp(sigcov, 0.0, 1.0)
    return sigcov, 2.0 * msx, 2.0 * msy


# ---------------------------------------------------------------------------
# three-level covariance (HASPI v1)
# ---------------------------------------------------------------------------

_NBINS = 1024


def three_level_covary(sigcov: torch.Tensor, sig_msx: torch.Tensor,
                       thr: float = 2.5):
    """Low/mid/high-intensity covariance averages (reference
    eb_3LevelCovary, pyhaspi2.py:418-547), uniform weights."""
    dt = sigcov.dtype
    nbands, _ = sigcov.shape
    sig_rms = torch.sqrt(sig_msx)
    xsum_all = 20.0 * torch.log10((10.0 ** (sig_rms / 20.0)).sum(0) / nbands)
    sel = xsum_all > thr                                  # [nseg]
    big = torch.tensor(1e9, dtype=dt, device=sigcov.device)
    xsum = torch.where(sel, xsum_all, big)
    db_min = xsum.min()
    db_sel = torch.where(sel, xsum_all, -big)
    db_max = db_sel.max()
    # round-half-up nearest-center binning at 0.5 dB steps
    kbin = torch.clamp(torch.floor((db_sel - db_min) / 0.5 + 0.5).to(
        torch.int32), 0, _NBINS - 1)
    onehot = F.one_hot(kbin.long(), _NBINS).to(dt)
    hist = (onehot * sel[:, None].to(dt)).sum(0)          # [nbins]
    xcum = torch.cumsum(hist, 0)
    xcum = xcum / xcum[-1]
    centers = db_min + 0.5 * torch.arange(_NBINS, dtype=dt,
                                          device=sigcov.device)
    nvalid_bins = torch.clamp(torch.floor((db_max - db_min) / 0.5).to(
        torch.int32) + 1, 1, _NBINS)
    in_range = torch.arange(_NBINS, device=sigcov.device) < nvalid_bins
    # the reference's literal thresholds 0.333 / 0.667 (pyhaspi2.py:471-475)
    edge0 = _last_below_ref(xcum, in_range, centers, 0.333)
    edge1 = _last_below_ref(xcum, in_range, centers, 0.667)
    levels = [sel & (xsum_all < edge0),
              sel & (xsum_all >= edge0) & (xsum_all < edge1),
              sel & (xsum_all >= edge1)]
    weight = (sig_rms > thr).to(dt) * sel[None, :].to(dt)
    wcov = weight * sigcov
    cov3 = []
    for lv in levels:
        lvf = lv.to(dt)[None, :]
        ssum = (wcov * lvf).sum(-1)                       # [nbands]
        wsum = (weight * lvf).sum(-1)
        nonzero = wsum > 0
        cov_ave = torch.where(nonzero, ssum / torch.clamp_min(wsum, 1.0), 0.0)
        cov3.append(cov_ave.sum() / nonzero.sum())
    return torch.stack(cov3)


def _last_below_ref(xcum, in_range, centers, frac):
    m = (xcum < frac) & in_range
    pos = torch.where(m, torch.arange(xcum.shape[0], device=xcum.device),
                      -1).max()
    return torch.where(m.any(), centers[torch.clamp_min(pos, 0)],
                       torch.zeros((), dtype=centers.dtype,
                                   device=centers.device))


# ---------------------------------------------------------------------------
# average covariance with synchronisation rolloff (HASQI v2)
# ---------------------------------------------------------------------------

def ave_covary2(sigcov: torch.Tensor, sig_msx: torch.Tensor, thr: float,
                cfreq: np.ndarray):
    """Reference eb_AveCovary2 (pyhaspi2.py:161-222)."""
    nchan = sigcov.shape[0]
    p = np.array([1, 3, 5, 5, 5, 5])
    fcut = 1000.0 * np.array([1.5, 2.0, 2.5, 3.0, 3.5, 4.0])
    fsync = np.sqrt(fcut[:, None] ** (2 * p[:, None]) /
                    (fcut[:, None] ** (2 * p[:, None]) +
                     cfreq[None, :] ** (2 * p[:, None])))  # [6, nchan]
    sig_rms = torch.sqrt(sig_msx)
    xsum = 20.0 * torch.log10((10.0 ** (sig_rms / 20.0)).sum(0) / nchan)
    seg_sel = (xsum > thr).to(sigcov.dtype)                # [nseg]
    weight = (sig_rms > thr).to(sigcov.dtype) * seg_sel[None, :]
    csum = (weight * sigcov).sum()
    wsum = weight.sum()
    fsync_t = _const(fsync, sigcov)
    fsum = torch.einsum("kc,cs,cs->k", fsync_t, weight, sigcov)
    ssum = torch.einsum("kc,cs->k", fsync_t, weight)
    avecov = torch.where(wsum < 1.0, 0.0, csum / torch.clamp_min(wsum, 1.0))
    syncov = torch.where(ssum > 0.0,
                         fsum / torch.where(ssum > 0.0, ssum, 1.0), 0.0)
    return avecov, syncov


def spect_diff(xsl: torch.Tensor, ysl: torch.Tensor):
    """Loudness spectrum differences (reference eb_SpectDiff,
    pyhaspi2.py:224-251): (dloud, dnorm, dslope), each [3]."""
    nbands = xsl.shape[0]
    x = 10.0 ** (xsl / 20.0)
    y = 10.0 ** (ysl / 20.0)
    x = x / x.sum()
    y = y / y.sum()

    def stats(d):
        return torch.stack([d.abs().sum(),
                            nbands * torch.std(d, correction=0),
                            d.abs().max()])

    return (stats(x - y), stats((x - y) / (x + y)),
            stats((x[1:] - x[:-1]) - (y[1:] - y[:-1])))


# ---------------------------------------------------------------------------
# HASPI v2 modulation chain, with a leading batch dimension
# ---------------------------------------------------------------------------

def env_filt_one(db: torch.Tensor, fcut: float = 320.0, fsub: float = 2560.0,
                 fsamp: int = FSAMP) -> torch.Tensor:
    """One signal's half of ebm_EnvFilt: [..., nchan, n] -> [..., nsub,
    nchan] (per signal, so the clean side can be cached), dense, so that a
    cached copy has its layout."""
    tfilt = 0.7 * 1000.0 / fcut
    nfilt = round(0.001 * tfilt * fsamp)
    nhalf = nfilt // 2
    nfilt = 2 * nhalf
    benv = np.hanning(nfilt)
    benv = benv / benv.sum()
    # np.convolve(x, benv)[nhalf : nhalf+nsamp]; benv is a palindrome, so
    # this is the correlation with pad_lo = nfilt-1-nhalf
    env = _corr_time(db, benv, nfilt - 1 - nhalf, nhalf)
    space = int(fsamp // fsub)
    return env[..., ::space].transpose(-1, -2).contiguous()


def env_filt(xdb: torch.Tensor, ydb: torch.Tensor, fcut: float = 320.0,
             fsub: float = 2560.0, fsamp: int = FSAMP):
    """320 Hz envelope LP filter + subsample (reference ebm_EnvFilt,
    pyhaspi2.py:378-414): [..., nchan, n] -> [..., nsub, nchan] each."""
    return (env_filt_one(xdb, fcut, fsub, fsamp),
            env_filt_one(ydb, fcut, fsub, fsamp))


def cep_coef(xdb: torch.Tensor, ydb: torch.Tensor, thr_cep: float = 2.5,
             thr_nerve: float = 0.1, nbasis: int = 6,
             generator: torch.Generator | None = None,
             noise_scale: float = 0.0):
    """Cepstral coefficients with silence-gated compaction (reference
    ebm_CepCoef, pyhaspi2.py:342-375).

    xdb, ydb: [..., nsub, nbands] -> (xcep, ycep [..., nsub, nbasis],
    count [...]): valid rows compacted to the front, zeros after."""
    nsub, nbands = xdb.shape[-2:]
    cepm = _const(_cep_basis(nbands, nbasis), xdb)
    xsum = 20.0 * torch.log10((10.0 ** (xdb / 20.0)).sum(-1) / nbands)
    valid = xsum > thr_cep                                # [..., nsub]
    # all-quiet signals keep one row, so the means stay finite
    count = torch.clamp_min(valid.sum(-1), 1)
    idx = _sorted_front(valid)[..., None].expand(xdb.shape)
    xv = torch.gather(xdb, -2, idx)
    yv = torch.gather(ydb, -2, idx)
    live = (torch.arange(nsub, device=xdb.device) < count[..., None]).to(
        xdb.dtype)[..., None]
    if noise_scale != 0.0:
        gn = noise_scale * thr_nerve
        xv = xv + bm_noise(xv.shape, gn, xv.dtype, xv.device, generator)
        yv = yv + bm_noise(yv.shape, gn, yv.dtype, yv.device, generator)
    xcep = (xv @ cepm) * live
    ycep = (yv @ cepm) * live
    cnt = count[..., None, None]
    xcep = (xcep - xcep.sum(-2, keepdim=True) / cnt) * live
    ycep = (ycep - ycep.sum(-2, keepdim=True) / cnt) * live
    return xcep, ycep, count


@functools.lru_cache(maxsize=None)
def _mod_filters(fsub: float):
    """Modulation filterbank design (reference ebm_ModFilt,
    pyhaspi2.py:275-318): band centers, Hann LP kernels, half-lengths."""
    cf = np.array([2, 6, 10, 16, 25, 40, 64, 100, 160, 256], float)
    nmod = len(cf)
    edge = np.zeros(nmod + 1)
    edge[1], edge[2] = 4.0, 8.0
    for k in range(3, nmod + 1):
        edge[k] = cf[k - 1] ** 2 / edge[k - 1]
    fnyq = 0.5 * fsub
    nmod = int((edge < fnyq).sum()) - 1
    cf = cf[:nmod]
    t = np.full(nmod, 0.24)
    t[2:] = 0.24 * cf[2] / cf[2:]
    nfir = (2 * np.floor(t * fsub / 2)).astype(int)
    kernels = []
    for k in range(nmod):
        b = np.hanning(nfir[k] + 1)
        kernels.append(b / b.sum())
    return cf, kernels, (nfir // 2).astype(int)


def mod_filt_corr(xcep: torch.Tensor, ycep: torch.Tensor, count,
                  fsub: float = 2560.0) -> torch.Tensor:
    """Modulation filterbank + envelope correlation (reference ebm_ModFilt
    + ebm_ModCorr, pyhaspi2.py:254-339): compacted [..., nsub, nbasis]
    tracks with `count` [...] valid rows -> aveCM [..., nmod].

    Every (band, signal, quadrature leg) FIR pass is one batched FFT
    convolution at a power-of-two size; each band's output offset
    K-1-nhalf is a static slice of the shared inverse transform."""
    nsub = xcep.shape[-2]
    dt, dev = xcep.dtype, xcep.device
    cf, kernels, nhalf = _mod_filters(fsub)
    nmod = len(cf)
    fnyq = 0.5 * fsub
    n = torch.arange(1, nsub + 1, dtype=dt, device=dev)
    live = (torch.arange(nsub, device=dev) < count[..., None]).to(dt)
    ph = (math.pi / fnyq) * _const(cf, xcep)[:, None] * n[None, :]
    co = torch.sqrt(torch.tensor(2.0, dtype=dt)) * torch.cos(ph)   # [M, ns]
    si = torch.sqrt(torch.tensor(2.0, dtype=dt)) * torch.sin(ph)
    co[0] = 1.0
    si[0] = 0.0
    need = nsub + max(int(k.shape[0]) for k in kernels)
    m = 1
    while m < need:
        m *= 2
    npdt = np.float64 if dt == torch.float64 else np.float32
    kf = np.stack([np.fft.rfft(k[::-1].astype(npdt), m) for k in kernels])
    kf_t = torch.as_tensor(kf, device=dev).to(
        torch.complex128 if dt == torch.float64 else torch.complex64)
    # only cepstral bases 1..5 reach the output
    xc5 = xcep[..., 1:6].transpose(-1, -2)[..., None, :, :]   # [..., 1, 5, ns]
    yc5 = ycep[..., 1:6].transpose(-1, -2)[..., None, :, :]
    c3, s3 = co[:, None, :], si[:, None, :]                    # [M, 1, ns]
    legs = torch.stack([xc5 * c3, -xc5 * s3, yc5 * c3, -yc5 * s3], -3)
    conv = torch.fft.irfft(torch.fft.rfft(legs, m)
                           * kf_t[:, None, None, :], m)   # [..., M, 4, 5, m]
    f = torch.stack([conv[..., k, :, :, int(kernels[k].shape[0]) - 1
                          - int(nhalf[k]):][..., :nsub]
                     for k in range(nmod)], -4).to(dt)   # [..., M, 4, 5, ns]
    lv = live[..., None, None, :]
    xf = (f[..., 0, :, :] * c3 - f[..., 1, :, :] * s3) * lv
    yf = (f[..., 2, :, :] * c3 - f[..., 3, :, :] * s3) * lv
    small = 1e-30
    cnt = count[..., None, None, None].to(dt)
    xf = (xf - xf.sum(-1, keepdim=True) / cnt) * lv
    yf = (yf - yf.sum(-1, keepdim=True) / cnt) * lv
    xs = (xf * xf).sum(-1)                                 # [..., M, 5]
    ys = (yf * yf).sum(-1)
    cm5 = torch.where((xs < small) | (ys < small), 0.0,
                      torch.abs((xf * yf).sum(-1))
                      / torch.sqrt(torch.clamp_min(xs * ys, small)))
    return cm5.mean(-1)
