"""IMCRA noise-PSD estimation as a plain frame loop in PyTorch.

A frozen copy of the port's plain IMCRA (its kernel dispatch removed): the
benchmark's reference for the noise PSD the IMCRA kernel computes.
The notes below are the original's.

Counterpart of `nelegan_tpu/dsp/imcra.py`, whose whole recursion runs as one
`lax.scan` (imcra.py:206-228).  Eager PyTorch has no such scan: the plain
version below is a Python loop over frames of dozens of small tensor ops,
which is the reference the kernel is held against and the path the CPU takes.
On a CUDA tensor `imcra_scan` launches `csrc/imcra.cu`, which runs the frame
loop inside one block per utterance.

Quirks of the reference recursion that both versions keep (reference:
noise_est/imcra.py, as listed at nelegan_tpu/dsp/imcra.py:13-23):

  * frame 0 initialises the smoothed buffers from itself and is then *also*
    processed by the warm-up branch;
  * during the IS warm-up frames only `lam` is smoothed; `ov_lam` keeps its
    frame-0 value until the main branch first runs;
  * the PSD emitted for frame l is `lam` *after* the update;
  * minimum tracking fires every V-th main-branch frame: the sub-window
    minimum is written to slot u while u < U, otherwise the U slots roll and
    the last is written, then the minimum is taken over min(u+1, U) slots;
  * the q == 1 guard of the speech-presence probability and the norm > 0
    guard of the second smoothing;
  * powers are promoted to at least float32.

Every scalar coefficient is rounded to the working dtype exactly as the
reference package rounds it (`_coefficients`), so the kernel and the plain
version do the same float32 operations in the same order.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.config import ImcraConfig
from portbench.reference.device import resolve_device

_TINY = 1e-30


class ImcraState(NamedTuple):
    """Carry of the recursion; every tensor has leading batch dims [...]."""
    s: torch.Tensor            # smoothed spectrogram, first iteration [..., K]
    ts: torch.Tensor           # smoothed spectrogram, second iteration [..., K]
    smin: torch.Tensor         # running minimum [..., K]
    tsmin: torch.Tensor
    smin_sw: torch.Tensor      # sub-window running minimum [..., K]
    tsmin_sw: torch.Tensor
    store: torch.Tensor        # minimum-tracking buffer [..., U, K]
    tstore: torch.Tensor
    ov_lam: torch.Tensor       # biased noise PSD [..., K]
    lam: torch.Tensor          # bias-corrected noise PSD [..., K]
    gain: torch.Tensor         # decision-directed Wiener gain [..., K]
    gamma: torch.Tensor        # a-posteriori SNR [..., K]
    j: torch.Tensor            # V-frame counter [...] int32
    u: torch.Tensor            # filled-buffer counter [...] int32


@functools.lru_cache(maxsize=None)
def _coefficients(cfg: ImcraConfig, dtype: torch.dtype) -> dict:
    """Scalar coefficients rounded as the reference package rounds them.

    `alpha_s` and `alpha_d` are arrays of the working dtype there, so their
    complements are computed in that dtype; every other constant is a
    Python float whose expression is evaluated in double and then rounded
    once to the working dtype."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64

    def r(v):
        return float(np_dt(v))

    a_s, a_d = np_dt(cfg.alpha_s), np_dt(cfg.alpha_d)
    return dict(
        alpha_s=float(a_s), one_m_alpha_s=float(np_dt(1.0) - a_s),
        alpha_d=float(a_d), one_m_alpha_d=float(np_dt(1.0) - a_d),
        alpha_dd=r(cfg.alpha_dd), one_m_alpha_dd=r(1.0 - cfg.alpha_dd),
        xi_min=r(cfg.xi_min), bmin=r(cfg.bmin), gamma0=r(cfg.gamma0),
        gamma1=r(cfg.gamma1), gamma1_m1=r(cfg.gamma1 - 1.0),
        zeta0=r(cfg.zeta0), beta=r(cfg.beta), p_upthr=r(cfg.p_upthr),
        q_max=r(1.0 - 1e-7), two_thirds=r(2.0 / 3.0), one_third=r(1.0 / 3.0),
        tiny=r(_TINY), xi_ml_floor=r(1e-6), lambda_init=r(cfg.lambda_init))


def _fsmooth(p: torch.Tensor, c: dict) -> torch.Tensor:
    """3-tap raised-cosine frequency smoothing [1/4, 1/2, 1/4]; the edge bins
    renormalise over their in-range taps to [2/3, 1/3]
    (reference: imcra.py:259-268, 335-336)."""
    up = F.pad(p[..., 1:], (0, 1))       # p[k+1]
    down = F.pad(p[..., :-1], (1, 0))    # p[k-1]
    s = 0.25 * down + 0.5 * p + 0.25 * up
    s[..., 0] = p[..., 0] * c["two_thirds"] + p[..., 1] * c["one_third"]
    s[..., -1] = p[..., -2] * c["one_third"] + p[..., -1] * c["two_thirds"]
    return s


def _min_track(buf: torch.Tensor, sw: torch.Tensor, u: torch.Tensor,
               n_u: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Push `sw` into the U-slot buffer; return (new buffer, min over the
    filled slots)."""
    slot = torch.arange(n_u, device=buf.device)[:, None]          # [U, 1]
    uu = u[..., None, None]
    pushed = torch.where(slot == uu, sw[..., None, :], buf)
    rolled = torch.cat([buf[..., 1:, :], sw[..., None, :]], dim=-2)
    buf = torch.where(uu < n_u, pushed, rolled)
    count = torch.clamp_max(u + 1, n_u)[..., None, None]
    masked = torch.where(slot < count, buf, torch.full_like(buf, np.inf))
    return buf, masked.amin(dim=-2)


def imcra_init(k: int, dtype: torch.dtype, cfg: ImcraConfig = ImcraConfig(),
               batch: tuple = (), device=None) -> ImcraState:
    """Fresh carry for `imcra_step` / `imcra_scan` (also a streaming state)
    on `device` (None: CUDA, raising without it)."""
    device = resolve_device(device)
    def z():
        return torch.zeros(batch + (k,), dtype=dtype, device=device)

    def zs():
        return torch.zeros(batch + (cfg.u_buffers, k), dtype=dtype,
                           device=device)

    zi = torch.zeros(batch, dtype=torch.int32, device=device)
    return ImcraState(
        s=z(), ts=z(), smin=z(), tsmin=z(), smin_sw=z(), tsmin_sw=z(),
        store=zs(), tstore=zs(), ov_lam=z(),
        lam=torch.full(batch + (k,), cfg.lambda_init, dtype=dtype,
                       device=device),
        gain=torch.ones(batch + (k,), dtype=dtype, device=device),
        gamma=torch.ones(batch + (k,), dtype=dtype, device=device),
        j=zi, u=zi.clone())


def imcra_step(st: ImcraState, y2_l: torch.Tensor, l: int,
               cfg: ImcraConfig = ImcraConfig()
               ) -> tuple[ImcraState, torch.Tensor]:
    """One frame: (state, |Y_l|^2 [..., K], absolute frame index l) ->
    (new state, noise PSD of frame l [..., K]).  `l` counts frames since the
    stream started; it drives the frame-0 init and the IS warm-up."""
    c = _coefficients(cfg, y2_l.dtype)
    tiny = c["tiny"]

    # frame-0 initialisation (reference imcra.py:338-361, 377-380)
    sf = _fsmooth(y2_l, c)
    if l == 0:
        s = ts = smin = tsmin = smin_sw = tsmin_sw = sf
        ov_lam = lam = y2_l
    else:
        s, ts, smin, tsmin = st.s, st.ts, st.smin, st.tsmin
        smin_sw, tsmin_sw = st.smin_sw, st.tsmin_sw
        ov_lam, lam = st.ov_lam, st.lam

    # outer decision-directed recursion (imcra.py:541-557)
    xi_g = st.gain * st.gain * st.gamma
    gamma = y2_l / torch.clamp_min(lam, tiny)
    xi_ml = torch.clamp_min(gamma - 1.0, c["xi_ml_floor"])
    xi = c["alpha_dd"] * xi_g + c["one_m_alpha_dd"] * xi_ml
    xi = torch.clamp_min(xi, c["xi_min"])
    gain = xi / (1.0 + xi)

    # smoothing shared by the warm-up and the main branch
    s = c["alpha_s"] * s + c["one_m_alpha_s"] * sf
    smin = torch.minimum(smin, s)
    smin_sw = torch.minimum(smin_sw, s)

    if l < cfg.is_frames:
        # warm-up branch (imcra.py:384-398): only lam is smoothed
        lam = c["alpha_d"] * lam + c["one_m_alpha_d"] * y2_l
        new = st._replace(s=s, ts=ts, smin=smin, tsmin=tsmin,
                          smin_sw=smin_sw, tsmin_sw=tsmin_sw,
                          ov_lam=ov_lam, lam=lam, gain=gain, gamma=gamma)
        return new, lam

    # main branch (imcra.py:400-448)
    gamma_min = y2_l / torch.clamp_min(c["bmin"] * smin, tiny)
    zeta = s / torch.clamp_min(c["bmin"] * smin, tiny)
    vad_i = ((gamma_min < c["gamma0"]) & (zeta < c["zeta0"])).to(y2_l.dtype)

    norm = _fsmooth(vad_i, c)
    tsf = _fsmooth(vad_i * y2_l, c)
    tsf = torch.where(norm > 0, tsf / torch.clamp_min(norm, tiny), tsf)
    ts = c["alpha_s"] * ts + c["one_m_alpha_s"] * tsf
    tsmin = torch.minimum(tsmin, ts)
    tsmin_sw = torch.minimum(tsmin_sw, ts)

    tgm = y2_l / torch.clamp_min(c["bmin"] * tsmin, tiny)
    tz = s / torch.clamp_min(c["bmin"] * tsmin, tiny)
    q = torch.zeros_like(y2_l)
    q = torch.where((tgm <= 1.0) & (tz < c["zeta0"]), 1.0, q)
    mid = (tgm > 1.0) & (tgm < c["gamma1"]) & (tz < c["zeta0"])
    q = torch.where(mid, (c["gamma1"] - tgm) / c["gamma1_m1"], q)

    # a-posteriori speech probability (imcra.py:22-36), capped at p_upthr
    nu = gamma * xi / (1.0 + xi)
    qs = torch.clamp_max(q, c["q_max"])   # guards the q == 1 division
    p = 1.0 / (1.0 + (qs / (1.0 - qs)) * (1.0 + xi) * torch.exp(-nu))
    p = torch.where(q < 1.0, p, 0.0)
    p = torch.clamp_max(p, c["p_upthr"])

    t_ad = c["alpha_d"] + c["one_m_alpha_d"] * p
    ov_lam = t_ad * ov_lam + (1.0 - t_ad) * y2_l
    lam = c["beta"] * ov_lam

    # minimum tracking every V-th main frame (imcra.py:450-481)
    j = st.j + 1
    fire = j == cfg.v_frames
    store, smin_new = _min_track(st.store, smin_sw, st.u, cfg.u_buffers)
    tstore, tsmin_new = _min_track(st.tstore, tsmin_sw, st.u, cfg.u_buffers)
    f1, f2 = fire[..., None], fire[..., None, None]
    new = ImcraState(
        s=s, ts=ts,
        smin=torch.where(f1, smin_new, smin),
        tsmin=torch.where(f1, tsmin_new, tsmin),
        smin_sw=torch.where(f1, s, smin_sw),
        tsmin_sw=torch.where(f1, ts, tsmin_sw),
        store=torch.where(f2, store, st.store),
        tstore=torch.where(f2, tstore, st.tstore),
        ov_lam=ov_lam, lam=lam, gain=gain, gamma=gamma,
        j=torch.where(fire, 0, j).to(torch.int32),
        u=torch.where(fire, st.u + 1, st.u).to(torch.int32))
    return new, lam


def imcra_scan_plain(y2: torch.Tensor, state: ImcraState | None = None,
                     l0: int = 0, cfg: ImcraConfig = ImcraConfig()
                     ) -> tuple[torch.Tensor, ImcraState]:
    """Plain frame loop: y2 [..., T, K] -> (psd [..., T, K], final state).
    `state` None starts a fresh recursion."""
    if state is None:
        state = imcra_init(y2.shape[-1], y2.dtype, cfg, y2.shape[:-2],
                           y2.device)
    out = []
    for t in range(y2.shape[-2]):
        state, lam = imcra_step(state, y2[..., t, :], l0 + t, cfg)
        out.append(lam)
    if not out:
        return torch.empty_like(y2), state
    return torch.stack(out, dim=-2), state


def imcra_psd(y2: torch.Tensor, cfg: ImcraConfig = ImcraConfig()
              ) -> torch.Tensor:
    """Noise PSD ``[B, T, K]`` of a fresh scan over ``y2 [B, T, K]``."""
    return imcra_scan_plain(y2, None, 0, cfg)[0]
