"""HASPI v1 / v2 and HASQI v2.

Counterpart of `nelegan_tpu/metrics/haspi/__init__.py` (reference:
pyHASPI/pyhaspi2.py).  HASPI v2 (the scoring path) takes signals [n] or
[B, n] with a per-row `n_valid`; v1 and HASQI take one utterance.

Randomness: the reference injects unseeded Gaussian noise in two places
(BM noise, pyhaspi2.py:1091-1095; cepstral dither, :362-365).  Here both
draw from an explicit `torch.Generator`; ``noise_scale=0`` (the default) is
the deterministic mode of the committed goldens.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.resample import resample_poly
from portbench.reference.metrics._framing import as_rows
from portbench.reference.metrics.haspi import chains
from portbench.reference.metrics.haspi.ear_model import (
    NCHAN, _ear_core, center_freq, ear_model, group_delay_comp,
    loss_parameters)

HASPI_V2_WEIGHTS = np.array([1.361, 1.521, 1.164, 0.492, 0.436, 0.690,
                             1.142, 0.816, 1.576, 2.269])


def _rms_normalize_one(x: torch.Tensor, n_valid=None) -> torch.Tensor:
    """x [..., n] over its RMS (of the valid prefix, the tail zeroed, when
    n_valid [...] is given); an all-zero signal stays zero."""
    def _div(sig, rms):
        return sig / torch.where(rms > 0.0, rms, 1.0)[..., None]

    if n_valid is None:
        return _div(x, torch.sqrt((x * x).sum(-1) / x.shape[-1]))
    mask = (torch.arange(x.shape[-1], device=x.device)
            < n_valid[..., None]).to(x.dtype)
    nv = torch.clamp_min(n_valid.to(x.dtype), 1.0)
    return _div(x * mask, torch.sqrt((x * x * mask).sum(-1) / nv))


def _rms_normalize(x, y, n_valid=None):
    return _rms_normalize_one(x, n_valid), _rms_normalize_one(y, n_valid)


def resample_to_24k(x: torch.Tensor, fs: int) -> torch.Tensor:
    """Reference eb_Resamp24kHz (pyhaspi2.py:810-821): polyphase resample
    to 24 kHz with the RMS restored."""
    if fs == 24000:
        return x
    if fs > 24000:
        raise NotImplementedError("downsampling to 24k not supported")
    from math import gcd
    g = gcd(24000, fs)
    y = resample_poly(x, 24000 // g, fs // g)
    rx = torch.sqrt((x * x).mean(-1, keepdim=True))
    ry = torch.sqrt((y * y).mean(-1, keepdim=True))
    return (rx / ry) * y


def _weighted(avecm: torch.Tensor) -> torch.Tensor:
    return (torch.as_tensor(HASPI_V2_WEIGHTS, dtype=avecm.dtype,
                            device=avecm.device) * avecm).sum(-1)


def haspi_v2_24k(x24: torch.Tensor, y24: torch.Tensor, level1: float = 65.0,
                 generator: torch.Generator | None = None,
                 noise_scale: float = 0.0, n_valid=None, hl=None,
                 itype: int = 0):
    """HASPI version 2 of pre-aligned equal-length 24 kHz signals [n] or
    [B, n] (reference haspi_v2, pyhaspi2.py:76-107).  Returns (score,
    aveCM [..., 10]).  `hl`: the [6] audiogram at 250..6000 Hz (default
    normal hearing); itype=1 runs the NAL-R compensated reference input.
    With `n_valid` (per row), a zero-padded row scores as its trimmed
    signal."""
    xb, nv, single = as_rows(x24, n_valid)
    yb = y24[None] if single else y24
    xb, yb = _rms_normalize(xb, yb, nv)
    ear = ear_model(xb, yb, hl=hl, itype=itype, level1=level1,
                    generator=generator, noise_scale=noise_scale, n_valid=nv)
    xlp, ylp = chains.env_filt(ear.xdb, ear.ydb, 320.0, 2560.0)
    xcep, ycep, count = chains.cep_coef(xlp, ylp, 2.5, 0.1, 6,
                                        generator=generator,
                                        noise_scale=noise_scale)
    avecm = chains.mod_filt_corr(xcep, ycep, count, 2560.0)
    score = _weighted(avecm)
    return (score[0], avecm[0]) if single else (score, avecm)


def _single_side_ear(sig24: torch.Tensor, level1: float, n_valid):
    """One normal-hearing side of the ear model, sig24 [B, n] -> (db
    [B, nchan, n] before group delay, bw_sig [B, nchan])."""
    dt, dev = sig24.dtype, sig24.device
    cfreq = center_freq(NCHAN)
    attn_ohc, bw_min, lowknee, cr, attn_ihc = loss_parameters(
        torch.zeros(6, dtype=dt, device=dev), cfreq)
    bw1 = loss_parameters(torch.full((6,), 100.0, dtype=dt, device=dev),
                          cfreq)[1]
    side_params = tuple(a[:, None] for a in
                        (bw_min, attn_ohc, lowknee, cr, attn_ihc))
    db, _, _, _, bw_sig = _ear_core(sig24[:, None], bw1, side_params, cfreq,
                                    level1, n_valid)
    return db[:, :, 0], bw_sig[:, :, 0]


def _tail_mask(db: torch.Tensor, n_valid) -> torch.Tensor:
    if n_valid is None:
        return db
    return db * (torch.arange(db.shape[-1], device=db.device)
                 < n_valid[:, None, None]).to(db.dtype)


def haspi_v2_clean_24k(x24: torch.Tensor, level1: float = 65.0,
                       n_valid=None) -> dict:
    """Clean-side half of HASPI v2, a function of the reference signal only
    (cacheable across scoring calls).  Returns {"xlp": [..., nsub, nchan]
    2560 Hz envelopes, "bwx": [..., nchan] signal bandwidths (the reference
    compensates both ears' group delay with BWx, pyhaspi2.py:1238-1243)}."""
    xb, nv, single = as_rows(x24, n_valid)
    xb = _rms_normalize_one(xb, nv)
    xdb, bwx = _single_side_ear(xb, level1, nv)
    xdb = _tail_mask(group_delay_comp(xdb, bwx, center_freq(NCHAN)), nv)
    out = {"xlp": chains.env_filt_one(xdb, 320.0, 2560.0), "bwx": bwx}
    return {k: v[0] for k, v in out.items()} if single else out


def haspi_v2_from_clean_24k(y24: torch.Tensor, clean: dict,
                            level1: float = 65.0,
                            generator: torch.Generator | None = None,
                            noise_scale: float = 0.0, n_valid=None):
    """HASPI v2 of a degraded signal against a precomputed clean half
    (`haspi_v2_clean_24k`); equal to `haspi_v2_24k`, as the pair path's
    only coupling of the sides is BWx, which the cache carries.  Returns
    (score, aveCM)."""
    yb, nv, single = as_rows(y24, n_valid)
    c = {k: (v[None] if single else v) for k, v in clean.items()}
    yb = _rms_normalize_one(yb, nv)
    ydb, _ = _single_side_ear(yb, level1, nv)
    ydb = _tail_mask(group_delay_comp(ydb, c["bwx"], center_freq(NCHAN)), nv)
    ylp = chains.env_filt_one(ydb, 320.0, 2560.0)
    xcep, ycep, count = chains.cep_coef(c["xlp"], ylp, 2.5, 0.1, 6,
                                        generator=generator,
                                        noise_scale=noise_scale)
    avecm = chains.mod_filt_corr(xcep, ycep, count, 2560.0)
    score = _weighted(avecm)
    return (score[0], avecm[0]) if single else (score, avecm)


def _one_utterance(x24, y24, name):
    if x24.dim() != 1 or y24.dim() != 1:
        raise ValueError(f"{name} takes one utterance [n]")


def haspi_v1_24k(x24: torch.Tensor, y24: torch.Tensor, level1: float = 65.0,
                 generator: torch.Generator | None = None,
                 noise_scale: float = 0.0, n_valid=None):
    """HASPI version 1 of one utterance (reference haspi, pyhaspi2.py:
    109-157).  Returns (intelligibility in [0, 1], raw = [cepcorr,
    cov3...])."""
    _one_utterance(x24, y24, "haspi_v1_24k")
    nv = None if n_valid is None else torch.as_tensor(n_valid,
                                                      device=x24.device)
    x24, y24 = _rms_normalize(x24, y24, nv)
    ear = ear_model(x24, y24, itype=0, level1=level1, generator=generator,
                    noise_scale=noise_scale, n_valid=nv)
    xsm = chains.env_smooth(ear.xdb, 16)
    ysm = chains.env_smooth(ear.ydb, 16)
    cepcorr, _ = chains.melcor(xsm, ysm, 2.5)
    sigcov, msx, _ = chains.bm_covary(ear.xbm, ear.ybm, 16)
    cov3 = chains.three_level_covary(sigcov, msx, 2.5)
    bias, wgtcep = -9.047, 14.816
    wgtcov = torch.tensor([0.0, 0.0, 4.616], dtype=x24.dtype,
                          device=x24.device)
    arg = bias + wgtcep * cepcorr + (wgtcov * cov3).sum()
    intel = 1.0 / (1.0 + torch.exp(-arg))
    return intel, torch.cat([cepcorr[None], cov3])


def hasqi_v2_24k(x24: torch.Tensor, y24: torch.Tensor, level1: float = 65.0,
                 generator: torch.Generator | None = None,
                 noise_scale: float = 0.0, n_valid=None):
    """HASQI version 2 quality of one utterance (reference hasqi_v2,
    pyhaspi2.py:32-74).  Returns (combined, nonlin, linear, raw [4])."""
    _one_utterance(x24, y24, "hasqi_v2_24k")
    nv = None if n_valid is None else torch.as_tensor(n_valid,
                                                      device=x24.device)
    x24, y24 = _rms_normalize(x24, y24, nv)
    ear = ear_model(x24, y24, itype=2, level1=level1, generator=generator,
                    noise_scale=noise_scale, n_valid=nv)
    xsm = chains.env_smooth(ear.xdb, 16)
    ysm = chains.env_smooth(ear.ydb, 16)
    cepcorr, _ = chains.melcor(xsm, ysm, 2.5)
    dloud, _, dslope = chains.spect_diff(ear.xsl, ear.ysl)
    sigcov, msx, _ = chains.bm_covary(ear.xbm, ear.ybm, 16)
    _, syncov = chains.ave_covary2(sigcov, msx, 2.5, center_freq())
    bmsync5 = syncov[4]
    dl = torch.clamp(1.0 - dloud[1] / 2.5, 0.0, 1.0)
    ds = torch.clamp(1.0 - dslope[1], 0.0, 1.0)
    nonlin = cepcorr * cepcorr * bmsync5
    linear = 0.579 * dl + 0.421 * ds
    combined = nonlin * linear
    return combined, nonlin, linear, torch.stack([cepcorr, bmsync5, dl, ds])


def _to_24k(x, fs_x, y, fs_y):
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    n = min(x.shape[-1], y.shape[-1])
    return (resample_to_24k(x[..., :n], fs_x),
            resample_to_24k(y[..., :n], fs_y))


def haspi_v2(x, fs_x, y, fs_y, **kw):
    """Wrapper with the reference signature (16 kHz signals welcome)."""
    return haspi_v2_24k(*_to_24k(x, fs_x, y, fs_y), **kw)


def haspi_v1(x, fs_x, y, fs_y, **kw):
    return haspi_v1_24k(*_to_24k(x, fs_x, y, fs_y), **kw)


def hasqi_v2(x, fs_x, y, fs_y, **kw):
    return hasqi_v2_24k(*_to_24k(x, fs_x, y, fs_y), **kw)
