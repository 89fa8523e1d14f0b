"""MMSE STFT speech estimators and IMCRA + MMSE-LSA enhancement.

Counterpart of `nelegan_tpu/dsp/mmse.py`, after the reference's
noise_est/ns.py (MMSE-LSA/PSD/STSA, the exponential-integral approximation,
SegSNR, pre-emphasis) and noise_est/imcra.py's enhancement loop.
`mmse_lsa_enhance` runs IMCRA with its own configuration (10 warm-up
frames, its alpha and xi_min) through `dsp.imcra.imcra_estimate_psd`: on a
CUDA tensor the `imcra_scan` kernel, one launch per call.
"""
from __future__ import annotations

import numpy as np
import torch

from nelegan_tpu_torch.config import ImcraConfig
from nelegan_tpu_torch.dsp.imcra import imcra_estimate_psd


def expint_approx(nu: torch.Tensor) -> torch.Tensor:
    """R. Martin's piecewise exponential-integral approximation
    (reference: noise_est/ns.py:202-213); its last branch overwrites the
    middle one for nu in (0.1, 1], as the reference's does."""
    out = torch.where(nu < 0.1, -2.31 * torch.log10(nu) - 0.6,
                      -1.544 * torch.log10(nu) + 0.166)
    return torch.where(nu > 0.1, 10.0 ** (-0.52 * nu - 0.26), out)


def mmse_lsa(mu: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """MMSE log-spectral-amplitude estimator (ns.py:123-133)."""
    nu = mu.abs() ** 2 / lam
    return mu * torch.exp(0.5 * expint_approx(nu))


def mmse_psd(mu: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """MMSE squared-amplitude estimator (ns.py:135-143)."""
    return mu.abs() ** 2 + lam


def mmse_stsa(mu: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """MMSE short-time spectral amplitude estimator (ns.py:145-173), with
    the exponentially scaled Bessel functions:
    gamma(1.5) sqrt(lam) ((1+nu) i0e(nu/2) + nu i1e(nu/2)); the Wiener
    approximation (mu itself) from nu = 1300 on, as the reference."""
    nu = mu.abs() ** 2 / lam
    gamma_15 = 0.8862269254527581
    stsa = gamma_15 * torch.sqrt(lam) * (
        (1.0 + nu) * torch.special.i0e(nu / 2.0)
        + nu * torch.special.i1e(nu / 2.0))
    return torch.where(nu >= 1300.0, mu, stsa.to(mu.dtype))


def preemphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """HTK-style pre-emphasis (ns.py:4-18)."""
    return torch.cat([x[..., :1] * (1.0 - coef),
                      x[..., 1:] - coef * x[..., :-1]], dim=-1)


def seg_snr(x: torch.Tensor, d: torch.Tensor, windowsize: int = 400,
            shift: int = 160) -> torch.Tensor:
    """Segmental SNR in dB (ns.py:175-200)."""
    nfr = (x.shape[-1] - windowsize) // shift + 1
    idx = torch.from_numpy(np.arange(nfr)[:, None] * shift
                           + np.arange(windowsize)[None, :]).to(x.device)
    se = torch.sum(x[..., idx] ** 2, -1)
    ne = torch.sum(d[..., idx] ** 2, -1)
    return 10.0 * torch.mean(torch.log10(se / torch.clamp_min(ne, 1e-30)),
                             -1)


def mmse_lsa_enhance(spec: torch.Tensor, alpha: float = 0.92,
                     xi_min: float = 10.0 ** (-25.0 / 20.0)) -> torch.Tensor:
    """IMCRA + MMSE-LSA enhancement of a noisy complex STFT [K, T] (the
    reference's `imcra_se.update` loop, noise_est/imcra.py:90-148): the
    IMCRA noise PSD, then the decision-directed gain recursion as a loop
    over frames, then the LSA estimator."""
    cfg = ImcraConfig(alpha_dd=alpha, xi_min=xi_min, is_frames=10)
    psd = imcra_estimate_psd(spec, cfg).T                 # [T, K]
    y2 = (spec.real ** 2 + spec.imag ** 2).T              # [T, K]
    lam_prev = torch.cat([torch.full_like(psd[:1], 1e-6), psd[:-1]], 0)
    g = torch.ones(y2.shape[-1], dtype=y2.dtype, device=y2.device)
    gamma_prev = torch.ones_like(g)
    gains = []
    for y2_l, lam_l in zip(y2, lam_prev):
        xi_g = g * g * gamma_prev
        gamma_prev = y2_l / torch.clamp_min(lam_l, 1e-30)
        xi_ml = torch.clamp_min(gamma_prev - 1.0, 1e-6)
        xi = torch.clamp_min(alpha * xi_g + (1 - alpha) * xi_ml, xi_min)
        g = xi / (1.0 + xi)
        gains.append(g)
    gains = torch.stack(gains).T                          # [K, T]
    return mmse_lsa(gains * spec, gains * lam_prev.T)
