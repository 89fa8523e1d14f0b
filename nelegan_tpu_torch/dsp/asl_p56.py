"""ITU-T P.56 method-B active speech level.

Counterpart of `nelegan_tpu/dsp/asl_p56.py` and of the reference's
`asl_P56` (reference: asl_P56.py:23-94): an envelope of two cascaded
one-pole smoothers, 15 activity counters with hangover, and a bisection to
the crossing of the active level and the threshold.

  * Envelope: y[k] = (1-g) u[k] + g y[k-1], g = exp(-1/(fs * 0.03)), applied
    twice to |x|.  Torch has no scan, so the recurrence runs blocked in
    float64: each 128-sample block from a zero state as one product with
    the lower-triangular matrix g^(i-j), all blocks at once; the blocks'
    end values form the same recurrence with g^128, solved the same way one
    level up; each block then adds g^(i+1) times the carry it starts from.
    A few launches per level, not one per sample.
  * Counters, in closed form: a sample counts for threshold j when the
    envelope crosses c[j] there or crossed it at most `hang_max` samples
    before (the cumulative maximum of the last crossing's index).  The
    reference's early `break` over thresholds never changes a counter.
  * The reference's quirks are kept: the counters start at -1 and gain 2
    before use, and the bisection is bounded as the reference bounds it
    (its tolerance grows by 10% a step after 20 steps).  The bisection runs
    on the host, over scalars.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 2.220446049250313e-16
_BLOCK = 128


def _decay(a: float, n: int, dtype, device) -> torch.Tensor:
    """[n, n] lower-triangular matrix a^(i-j), zero above the diagonal."""
    i = torch.arange(n, dtype=dtype, device=device)
    d = i[:, None] - i[None, :]
    return torch.where(d >= 0, a ** torch.clamp_min(d, 0), 0.0)


def one_pole_scan(b: torch.Tensor, a: float) -> torch.Tensor:
    """y[..., k] = b[..., k] + a * y[..., k-1] from y[-1] = 0, along the
    last axis, blocked (no loop over samples)."""
    n = b.shape[-1]
    if n <= _BLOCK:
        return b @ _decay(a, n, b.dtype, b.device).T
    m = -(-n // _BLOCK)
    blocks = torch.nn.functional.pad(b, (0, m * _BLOCK - n)).reshape(
        b.shape[:-1] + (m, _BLOCK))
    z = blocks @ _decay(a, _BLOCK, b.dtype, b.device).T     # zero-state runs
    # state at each block's end: s_i = z_i[-1] + a^BLOCK s_{i-1}
    s = one_pole_scan(z[..., -1], a ** _BLOCK)
    carry = torch.nn.functional.pad(s[..., :-1], (1, 0))    # state entering
    ramp = a ** torch.arange(1, _BLOCK + 1, dtype=b.dtype, device=b.device)
    y = z + carry[..., None] * ramp
    return y.reshape(b.shape[:-1] + (m * _BLOCK,))[..., :n]


def _bisect(upcount, lwcount, upthr, lwthr, margin):
    """The reference's bounded bisection, as the reference package's
    `lax.while_loop` runs it."""
    e_up = abs(upcount - upthr - margin) < 0.5
    e_lw = abs(lwcount - lwthr - margin) < 0.5
    if e_up:
        return upcount, upthr
    if e_lw:
        return lwcount, lwthr
    midc, midt = (upcount + lwcount) / 2, (upthr + lwthr) / 2
    tol, it = 0.5, 1
    while abs(midc - midt - margin) > tol:
        diff = midc - midt - margin
        if it > 20:
            tol = tol * 1.1
        if diff > tol:
            midc, midt = (upcount + midc) / 2, (upthr + midt) / 2
        else:
            midc, midt = (midc + lwcount) / 2, (midt + lwthr) / 2
        it += 1
    return midc, midt


def asl_p56_rows(x: torch.Tensor, fs: int = 16000, nbits: int = 16):
    """P.56 over the rows of x [B, n] -> (asl_msq, actfact, c0), each a
    float64 numpy array [B]."""
    t_const, hang_s, margin = 0.03, 0.2, 15.9
    thres_no = nbits - 1
    hang_max = int(math.ceil(fs * hang_s))
    g = math.exp(-1.0 / (fs * t_const))
    xd = x.to(torch.float64)
    n = xd.shape[-1]
    c = 2.0 ** torch.arange(-15, thres_no - 15, dtype=torch.float64,
                            device=x.device)

    sq = torch.sum(xd * xd, dim=-1)
    q = one_pole_scan((1 - g) * one_pole_scan((1 - g) * xd.abs(), g), g)

    idx = torch.arange(n, device=x.device)
    active = q[..., :, None] >= c                                  # [B, n, J]
    marked = torch.where(active, idx[:, None], -(n + hang_max + 2))
    last = torch.cummax(marked, dim=-2).values
    counted = active | ((idx[:, None] - last) <= hang_max)
    a = counted.sum(dim=-2) - 1                # the reference starts at -1

    a, sq = a.cpu().numpy(), sq.cpu().numpy()
    cdb = 20.0 * np.log10(c.cpu().numpy() + _EPS)
    out = np.zeros((3, len(sq)))
    for r in range(len(sq)):
        no_activity = a[r, 0] == -1
        ar = a[r] + 2
        adb = 10.0 * np.log10(sq[r] / (ar + _EPS) + _EPS)
        delta = adb - cdb
        # a != 0 always holds here (min(a) is 1), kept as the reference has
        elig = (np.arange(thres_no) >= 1) & (ar != 0) & (delta <= margin)
        if not (elig.any() and not no_activity and delta[0] >= margin):
            continue
        j = int(np.argmax(elig))
        asl_log, cl0 = _bisect(adb[j], adb[j - 1], cdb[j], cdb[j - 1],
                               margin)
        msq = 10.0 ** (asl_log / 10.0)
        out[:, r] = (msq, (sq[r] / n) / max(msq, _EPS), 10.0 ** (cl0 / 20.0))
    return out[0], out[1], out[2]


def asl_p56(x: torch.Tensor, fs: int = 16000, nbits: int = 16):
    """(asl_msq, actfact, c0) of one signal x [n], like the reference's
    asl_P56, as 0-d tensors of x's dtype on its device."""
    vals = asl_p56_rows(x[None], fs, nbits)
    return tuple(torch.tensor(v[0], dtype=x.dtype, device=x.device)
                 for v in vals)
