"""Kates auditory (ear) model with 32 gammatone channels, batched.

Counterpart of `nelegan_tpu/metrics/haspi/ear_model.py` (reference:
pyHASPI/pyhaspi2.py:1155-1248 `eb_EarModel`).  Its spectral formulation is
kept as it is:

  * one shared FFT per side carries the middle ear as the closed-form
    rational response of its FIR, one-pole and biquad (pyhaspi2.py:833-841)
    and feeds all 32 channels;
  * each gammatone filter is a complex bandpass evaluated in closed form on
    the carrier-shifted DFT grid; one complex inverse FFT per filter gives
    the envelope (|w|) and the basilar-membrane motion (Re w);
  * the IHC adaptation circuit's two-exponential impulse response and the
    800 Hz gain smoother are applied by FFT convolution;
  * group delays are the gammatone's analytic DC group delay.

The reference package's `vmap`s over channels and sides are written out:
spectra are ``[B, channels, sides, m]``.  It runs at complex128 for float64
signals and complex64 for float32.  The scan form of the middle ear,
`middle_ear`, runs through `ops/iir` (the `linrec` kernel on the card); the
scoring path does not call it, and the card's smoke run holds it against
the spectral fold.  The stochastic basilar-membrane noise takes a
`torch.Generator`; ``noise_scale=0`` is the deterministic golden mode.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.metrics._framing import as_rows
from portbench.reference.iir import (_fft_len_ir, biquad, exp_sum_ir, fir,
                                       one_pole, one_pole_ir)

FSAMP = 24000
NCHAN = 32
EAR_Q = 9.26449
MIN_BW = 24.7
_AUD = (250.0, 500.0, 1000.0, 2000.0, 4000.0, 6000.0)
#: NAL-R insertion-gain corrections (dB) at _AUD (Byrne & Dillon 1986).
_NALR_CORR = (-17.0, -8.0, 1.0, -1.0, -2.0, -2.0)
# middle ear (pyhaspi2.py:833-841): 2-tap FIR, one-pole, biquad
_ME_FIR = 0.434173751206302
_ME_POLE = 0.131652497587396
_ME_B = (0.937260390269893, -1.874520780539785, 0.937260390269893)
_ME_A = (1.0, -1.870580640735279, 0.878460920344291)


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """np.interp for increasing xp, with jnp.interp's arithmetic."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    f = torch.where(dx == 0, fp[i], fp[i - 1] + ((x - xp[i - 1]) / dx) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def center_freq(nchan: int = NCHAN) -> np.ndarray:
    """ERB-scale center frequencies (reference pyhaspi2.py:753-777)."""
    low, high = 80.0, 8000.0
    k = EAR_Q * MIN_BW
    cf = -k + np.exp(np.arange(1, nchan) *
                     (-np.log(high + k) + np.log(low + k)) / (nchan - 1)
                     ) * (high + k)
    cf = np.concatenate(([high], cf))
    return cf[::-1].copy()


def loss_parameters(hl: torch.Tensor, cfreq: np.ndarray):
    """Hearing-loss parameterisation (reference pyhaspi2.py:779-807):
    (attn_ohc, bw, lowknee, cr, attn_ihc), each [nchan]."""
    dt, dev = hl.dtype, hl.device
    nfilt = len(cfreq)
    cf = torch.as_tensor(cfreq, dtype=dt, device=dev)
    fv = torch.cat([cf[:1], torch.tensor(_AUD, dtype=dt, device=dev),
                    cf[-1:]])
    hv = torch.cat([hl[:1], hl, hl[-1:]])
    loss = torch.clamp_min(_interp(cf, fv, hv), 0.0)
    cr = 1.25 + 2.25 * torch.arange(nfilt, dtype=dt, device=dev) / (nfilt - 1)
    max_ohc = 70.0 * (1.0 - 1.0 / cr)
    thr_ohc = 1.25 * max_ohc
    attn_ohc = torch.where(loss < thr_ohc, 0.8 * loss, 0.8 * thr_ohc)
    attn_ihc = torch.where(loss < thr_ohc, 0.2 * loss,
                           0.2 * thr_ohc + (loss - thr_ohc))
    bw = 1.0 + attn_ohc / 50.0 + 2.0 * (attn_ohc / 50.0) ** 6
    lowknee = attn_ohc + 30.0
    upamp = 30.0 + 70.0 / cr
    cr_out = (100.0 - lowknee) / (upamp + attn_ohc - lowknee)
    return attn_ohc, bw, lowknee, cr_out, attn_ihc


def nalr_fir(hl: torch.Tensor, nfir: int = 140,
             fsamp: int = FSAMP) -> torch.Tensor:
    """NAL-R prescription as a linear-phase FIR, [nfir + 1] taps (Kates'
    published eb_NALR: the reference's own is a stub): gain X + 0.31 HL +
    correction per audiometric band, X = 0.05 * (HL at 500, 1000, 2000 Hz),
    floored at 0 dB, on a 512-point frequency-sampling design with a
    Hamming window.  All-zero HL gives a pure nfir/2-sample delay."""
    dt, dev = hl.dtype, hl.device
    aud = torch.tensor(_AUD, dtype=dt, device=dev)
    fmax = 0.5 * fsamp
    x = 0.05 * (hl[1] + hl[2] + hl[3])
    gdb = torch.clamp_min(x + 0.31 * hl
                          + torch.tensor(_NALR_CORR, dtype=dt, device=dev),
                          0.0)
    fv = torch.cat([torch.zeros(1, dtype=dt, device=dev), aud,
                    torch.tensor([fmax], dtype=dt, device=dev)])
    gv = torch.cat([gdb[:1], gdb, gdb[-1:]])
    npt = 512
    grid = torch.linspace(0.0, fmax, npt + 1, dtype=torch.float64,
                          device=dev).to(dt)
    mag = 10.0 ** (_interp(grid, fv, gv) / 20.0)
    k = torch.arange(npt + 1, dtype=dt, device=dev)
    phase = torch.exp(-1j * math.pi * k.to(_complex_of(dt))
                      * (0.5 * nfir / npt))
    taps = torch.fft.irfft(mag * phase, 2 * npt)[: nfir + 1]
    taps = taps * torch.as_tensor(np.hamming(nfir + 1), dtype=dt, device=dev)
    delta = torch.zeros(nfir + 1, dtype=dt, device=dev)
    delta[nfir // 2] = 1.0
    return torch.where(hl.max() > 0.0, taps, delta)


def nalr_apply(x: torch.Tensor, hl: torch.Tensor, nfir: int = 140,
               fsamp: int = FSAMP) -> torch.Tensor:
    """Reference itype=1 input path (pyhaspi2.py:1176-1181): the full
    convolution with the NAL-R FIR, then the slice [nfir : nfir + n]."""
    n = x.shape[-1]
    taps = nalr_fir(hl, nfir, fsamp).to(x.dtype)
    lhs = F.pad(x.reshape(-1, 1, n), (nfir, nfir))
    full = F.conv1d(lhs, taps.flip(0)[None, None, :])
    return full.reshape(x.shape[:-1] + (-1,))[..., nfir:nfir + n]


def middle_ear(x: torch.Tensor) -> torch.Tensor:
    """2-stage middle-ear filter (reference pyhaspi2.py:833-841) along the
    last axis, as scans: a 2-tap FIR, a one-pole and a biquad."""
    y = fir(x, [_ME_FIR, _ME_FIR])
    y = one_pole(y, _ME_POLE)
    return biquad(y, _ME_B, _ME_A)


def middle_ear_response(m: int, dtype=torch.complex128, device=None
                        ) -> torch.Tensor:
    """The middle ear's closed-form rational response on the m-point DFT
    grid, u = e^{-j omega}: what `_ear_core` multiplies each side's
    spectrum by in place of `middle_ear`."""
    omega = 2.0 * math.pi * torch.arange(m, dtype=torch.float64,
                                         device=device) / m
    u = torch.exp(-1j * omega)
    h = ((_ME_FIR * (1.0 + u)) / (1.0 - _ME_POLE * u)
         * (_ME_B[0] + _ME_B[1] * u + _ME_B[2] * u * u)
         / (1.0 + _ME_A[1] * u + _ME_A[2] * u * u))
    return h.to(dtype)


def _masked_mean_sq(v: torch.Tensor, n_valid=None) -> torch.Tensor:
    """mean(v^2) over the last axis's valid prefix; n_valid [B] matches v's
    first dim (v [B, ..., n])."""
    if n_valid is None:
        return (v * v).mean(-1)
    shape = (-1,) + (1,) * (v.dim() - 1)
    nv = n_valid.reshape(shape)
    mask = (torch.arange(v.shape[-1], device=v.device) < nv).to(v.dtype)
    return (v * v * mask).sum(-1) / nv[..., 0].to(v.dtype)


def bw_adjust(control: torch.Tensor, bw_min, bw_max, level1: float,
              n_valid=None):
    """Level-adaptive bandwidth (reference pyhaspi2.py:971-980)."""
    c_rms = torch.sqrt(_masked_mean_sq(control, n_valid))
    c_db = 20.0 * torch.log10(torch.clamp_min(c_rms, 1e-30)) + level1
    frac = torch.clamp((c_db - 50.0) / 50.0, 0.0, 1.0)
    return bw_min + frac * (bw_max - bw_min)


@functools.lru_cache(maxsize=None)
def _ihc_eigen(delta: float = 2.0, fsamp: int = FSAMP):
    """Static eigendecomposition of the IHC adaptation circuit
    (reference pyhaspi2.py:1028-1078)."""
    tau1, tau2 = 0.002, 0.060
    r1 = 1.0 / delta
    r2 = 0.5 * (1.0 - r1)
    r3 = r2
    c1 = tau1 * (r1 + r2) / (r1 * r2)
    c2 = tau2 / ((r1 + r2) * r3)
    t = 1.0 / fsamp
    a11 = r1 + r2 + r1 * r2 * (c1 / t)
    a12 = -r1
    a21 = -r3
    a22 = r2 + r3 + r2 * r3 * (c2 / t)
    denom = 1.0 / (a11 * a22 - a21 * a12)
    r12c1 = r1 * r2 * (c1 / t)
    r23c2 = r2 * r3 * (c2 / t)
    m = denom * np.array([[a22 * r12c1, -a12 * r23c2],
                          [-a21 * r12c1, a11 * r23c2]])
    w = denom * np.array([a22 * r2, -a21 * r2])
    evals, p = np.linalg.eig(m)
    pinv_w = np.linalg.solve(p, w)
    return evals, p[0], pinv_w, 1.0 / r1


def _tpt_bw(bw, cf):
    erb = MIN_BW + cf / EAR_Q
    return bw * (2.0 * math.pi / FSAMP) * erb * 1.019


def _dc_group_delay(bw, cf):
    """Analytic DC group delay of (1 + 2a z^-1)^2 / (1 - a z^-1)^4,
    4a/(1+2a) + 4a/(1-a), rounded (reference pyhaspi2.py:1098-1121)."""
    tpt_bw = _tpt_bw(bw, cf)
    a = torch.exp(-tpt_bw)
    one_minus_a = -torch.expm1(-tpt_bw)
    return torch.round(4.0 * a / (1.0 + 2.0 * a) + 4.0 * a / one_minus_a)


def group_delay_comp(env: torch.Tensor, bw: torch.Tensor, cfreq
                     ) -> torch.Tensor:
    """Right-shift each channel so group delays align, the wrapped head
    zeroed (pyhaspi2.py:1098-1131).  env [..., nchan, n], bw [..., nchan]."""
    gd = _dc_group_delay(bw, torch.as_tensor(cfreq, dtype=env.dtype,
                                             device=env.device))
    correct = (gd.amax(-1, keepdim=True) - gd).to(torch.int64)  # [..., C]
    n = env.shape[-1]
    src = torch.arange(n, device=env.device) - correct[..., None]
    out = torch.gather(env, -1, torch.clamp_min(src, 0))
    return torch.where(src >= 0, out, torch.zeros((), dtype=env.dtype,
                                                  device=env.device))


def ave_sl(env, control, attn_ohc, thr_low, cr, attn_ihc, level1):
    """Average dB SL (reference pyhaspi2.py:1135-1152)."""
    small = 1e-30
    logenv = level1 + 20.0 * torch.log10(torch.clamp_min(control, small))
    logenv = torch.minimum(torch.maximum(logenv, thr_low),
                           torch.full_like(logenv, 100.0))
    gain = -attn_ohc - (logenv - thr_low) * (1.0 - 1.0 / cr)
    logenv2 = torch.clamp_min(
        level1 + 20.0 * torch.log10(torch.clamp_min(env, small)), 0.0)
    return torch.clamp_min(logenv2 + gain - attn_ihc, 0.0)


class EarOutputs(NamedTuple):
    xdb: torch.Tensor   # [..., nchan, n] reference envelope, dB SL
    xbm: torch.Tensor   # [..., nchan, n] reference BM motion
    ydb: torch.Tensor
    ybm: torch.Tensor
    xsl: torch.Tensor   # [..., nchan] average dB SL
    ysl: torch.Tensor


def bm_noise(shape, gn: float, dtype, device, generator=None
             ) -> torch.Tensor:
    """gn * N(0, 1) of `shape`, drawn from `generator` (on its device)."""
    gen_dev = generator.device if generator is not None else device
    z = torch.randn(shape, generator=generator, dtype=dtype, device=gen_dev)
    return gn * z.to(device)


def ear_model(x24: torch.Tensor, y24: torch.Tensor,
              hl: torch.Tensor | None = None, itype: int = 0,
              level1: float = 65.0, generator: torch.Generator | None = None,
              noise_scale: float = 0.0, n_valid=None) -> EarOutputs:
    """The binaural-input ear model of 24 kHz signals [n] or [B, n]
    (reference eb_EarModel, pyhaspi2.py:1155-1248).  `noise_scale` = 1 with
    `generator` adds the stochastic BM noise; 0 is the deterministic mode.
    With `n_valid` (per row), a zero-padded row's outputs on its valid
    prefix equal those of its trimmed signal, and the tail is zeroed."""
    xb, nv, single = as_rows(x24, n_valid)
    yb = y24[None] if single else y24
    dt, dev = xb.dtype, xb.device
    hl = (torch.zeros(6, dtype=dt, device=dev) if hl is None
          else torch.as_tensor(hl, dtype=dt, device=dev))
    cfreq = center_freq(NCHAN)
    hlx = 0.0 * hl if itype == 0 else hl
    if itype == 1:
        xb = nalr_apply(xb, hl)
    px = loss_parameters(hlx, cfreq)
    py = loss_parameters(hl, cfreq)
    # control path: HL=100 bandwidths; cfreq1 == cfreq (reference quirk)
    bw1 = loss_parameters(torch.full((6,), 100.0, dtype=dt, device=dev),
                          cfreq)[1]
    mids = torch.stack([xb, yb], 1)                        # [B, 2, n]
    # (bw_min, attn_ohc, lowknee, cr, attn_ihc), each [nchan, 2]
    side_params = tuple(torch.stack([px[i], py[i]], -1)
                        for i in (1, 0, 2, 3, 4))
    db, bm, ave, cave, bw_sig = _ear_core(mids, bw1, side_params, cfreq,
                                          level1, nv)
    xdb, ydb = db[:, :, 0], db[:, :, 1]
    xbm, ybm = bm[:, :, 0], bm[:, :, 1]
    bwx = bw_sig[:, :, 0]
    if noise_scale != 0.0:
        gn = noise_scale * 10.0 ** ((-10.0 - level1) / 20.0)
        xbm = xbm + bm_noise(xbm.shape, gn, dt, dev, generator)
        ybm = ybm + bm_noise(ybm.shape, gn, dt, dev, generator)
    # the reference uses BWx for all four group-delay compensations
    xdb, ydb, xbm, ybm = (group_delay_comp(v, bwx, cfreq)
                          for v in (xdb, ydb, xbm, ybm))
    if nv is not None:
        tail = (torch.arange(xdb.shape[-1], device=dev)
                < nv[:, None, None]).to(dt)
        xdb, ydb, xbm, ybm = xdb * tail, ydb * tail, xbm * tail, ybm * tail
    xsl = ave_sl(ave[..., 0], cave[..., 0], px[0], px[2], px[3], px[4],
                 level1)
    ysl = ave_sl(ave[..., 1], cave[..., 1], py[0], py[2], py[3], py[4],
                 level1)
    out = EarOutputs(xdb, xbm, ydb, ybm, xsl, ysl)
    return EarOutputs(*(v[0] for v in out)) if single else out


def _ear_core(mids: torch.Tensor, bw1, side_params, cfreq, level1: float,
              n_valid):
    """The periphery of every channel and side, shared by `ear_model` and
    the split clean/degraded HASPI paths.

    mids: [B, S, n] raw (RMS-normalised) side signals (the middle ear is
    applied spectrally inside); bw1 [nchan]; side_params: 5-tuple of
    [nchan, S] (bw_min, attn_ohc, lowknee, cr, attn_ihc); n_valid [B] or
    None.  Returns (db [B, nchan, S, n], bm [B, nchan, S, n], ave, cave,
    bw_sig [B, nchan, S]), before BM noise, group-delay compensation and
    tail masking."""
    n = mids.shape[-1]
    dt, dev = mids.dtype, mids.device
    cdt = _complex_of(dt)
    cf = torch.as_tensor(cfreq, dtype=dt, device=dev)     # [C]

    # impulse responses truncated at the float32 noise floor, each FFT
    # sized for its truncated linear convolution (the reference package's
    # sizes: gammatone tail(4096)/peak ~5e-12, IHC e^(-L/1440) at 24576,
    # smoother 0.81^512)
    l_gam, l_ihc, l_smo = min(n, 4096), min(n, 24576), min(n, 512)
    m_gam = m_smo = _fft_len_ir(n, l_gam)
    m_ihc = _fft_len_ir(n, l_ihc)

    evals, p0, pinv_w, r1_inv = _ihc_eigen()
    ihc_ir = exp_sum_ir(list(evals), [p0[i] * pinv_w[i] for i in range(2)],
                        l_ihc, dt, dev)
    ihc_f = torch.fft.rfft(ihc_ir, m_ihc)
    # 800 Hz compression-gain smoother: lfilter([c, c], [1, -d], .)
    c800, d800 = 0.095107983402496, 0.809784033195007
    op = one_pole_ir(d800, l_smo, dt, dev)
    smooth_ir = c800 * (op + torch.cat([torch.zeros_like(op[:1]), op[:-1]]))
    smooth_f = torch.fft.rfft(smooth_ir, m_smo)
    small = 1e-30

    # one FFT per side, the middle ear folded in
    x_full = torch.fft.fft(mids.to(cdt), m_gam) * middle_ear_response(
        m_gam, cdt, dev)                                  # [B, S, m]
    x_full = x_full[:, None]                              # [B, 1, S, m]
    # per-channel grid trigonometry, delta = w_r - w_c; 1 - a cos(delta) is
    # evaluated as (1-a) + 2a sin^2(delta/2) (both terms positive)
    omega = 2.0 * math.pi * torch.arange(m_gam, dtype=torch.float64,
                                         device=dev) / m_gam
    delta = omega[None, :] - 2.0 * math.pi * cf.double()[:, None] / FSAMP
    cosd = torch.cos(delta).to(dt)[:, None, :]            # [C, 1, m]
    sind = torch.sin(delta).to(dt)[:, None, :]
    s2h = torch.square(torch.sin(0.5 * delta)).to(dt)[:, None, :]

    def gfilter(bw):
        """bw [..., C, S] -> (gain [..., C, S], w [B, C, S, n])."""
        tpt_bw = _tpt_bw(bw, cf[:, None])
        a = torch.exp(-tpt_bw)
        one_minus_a = -torch.expm1(-tpt_bw)
        gain = 2.0 * one_minus_a ** 4 / (1.0 + 2.0 * a) ** 2
        a_, oma = a[..., None], one_minus_a[..., None]
        num = torch.complex(1.0 + 2.0 * a_ * cosd, -2.0 * a_ * sind)
        den1 = torch.complex(oma + 2.0 * a_ * s2h, a_ * sind)
        den2 = den1 * den1
        h = (num * num) / (den2 * den2)
        return gain, torch.fft.ifft(x_full * h)[..., :n]

    bw_min, aohc, lk, cr, aihc = side_params
    bw1c = bw1[:, None]                                   # [C, 1]
    g1, w1 = gfilter(bw1c)
    # 1e-20 inside the sqrts, as in the reference package
    ctl = g1[..., None] * torch.sqrt(w1.real * w1.real + w1.imag * w1.imag
                                     + 1e-20)
    bw_sig = bw_adjust(ctl, bw_min, bw1c, level1, n_valid)   # [B, C, S]
    gs, ws = gfilter(bw_sig)
    env = gs[..., None] * torch.sqrt(ws.real * ws.real + ws.imag * ws.imag
                                     + 1e-20)
    bm = gs[..., None] * ws.real
    ave = torch.sqrt(_masked_mean_sq(env, n_valid))
    cave = torch.sqrt(_masked_mean_sq(ctl, n_valid))

    # OHC compression with the smoothed gain
    logenv = level1 + 20.0 * torch.log10(torch.clamp_min(ctl, small))
    logenv = torch.minimum(torch.maximum(logenv, lk[..., None]),
                           torch.full_like(logenv, 100.0))
    gain_db = -aohc[..., None] - (logenv - lk[..., None]) * (
        1.0 - 1.0 / cr[..., None])
    gain = 10.0 ** (gain_db / 20.0)
    gain = torch.fft.irfft(torch.fft.rfft(gain, m_smo) * smooth_f,
                           m_smo)[..., :n]
    envc = gain * env
    bmc = gain * bm

    # dB SL conversion
    ydb_ = torch.clamp_min(level1 - aihc[..., None]
                           + 20.0 * torch.log10(envc + small), 0.0)
    bmc = bmc * (ydb_ + small) / (envc + small)

    # IHC adaptation: V1 is linear in the input; clamp and gain elementwise
    v1 = torch.fft.irfft(torch.fft.rfft(ydb_, m_ihc) * ihc_f, m_ihc)[..., :n]
    out = torch.clamp_min((ydb_ - v1) * r1_inv, 0.0)
    bm_out = bmc * (out + small) / (ydb_ + small)
    return out, bm_out, ave, cave, bw_sig
