"""ITU-T P.862 (PESQ) perceptual model with a leading batch dimension.

Counterpart of `nelegan_tpu/metrics/pesq.py` (reference: intel.py:9,
142-160, the pypesq C extension run at 16 kHz): the complete P.862
perceptual and cognitive model, re-derived from the standard, stage by
stage:

  1.  level alignment to TARGET_POWER = 1e7 in the 350-3250 Hz band;
  2.  P.862.2's ~100 Hz high-pass, folded into the frames' power spectra;
  3.  32 ms Hann frames at 50 % overlap;
  4.  Bark warping to 49 bands (pitch power densities, scale Sp);
  5.  partial frequency-response compensation of the reference, the ratio
      clipped to [0.01, 100];
  6.  short-term gain compensation of the degraded signal, the per-frame
      audible power ratio clipped to [3e-4, 5] and smoothed 0.2/0.8 from a
      gain of 1 (`_smooth_gain`: one `ops.iir.linrec` call, the kernel
      `csrc/linrec.cu` on the card);
  7.  Zwicker loudness (exponent 0.23, low-band modification, scale Sl);
  8.  disturbance with a 0.25*min masking deadzone, asymmetry
      ((deg + 50) / (ref + 50))^1.2 in [3, 12];
  9.  frame pooling: band-width-weighted Lp over Bark bands, frame weight
      ((P_ref + 1e5) / 1e7)^0.04, clipped at 45;
  10. time pooling: L6 over 20-frame windows at 50 % overlap, then L2;
  11. raw PESQ = 4.5 - 0.1 d_sym - 0.0309 d_asym, and the P.862.2 wideband
      map to MOS-LQO.

Optional, eval-grade alignment, each flag implying those before it as in
the ITU flow: a global delay (`_global_align`), utterance splitting with a
per-utterance (and split-piece) delay (`_utterance_align`), and the
bad-interval re-alignment (`_bad_interval_realign`).

The reference package's `vmap` over utterances is a leading batch
dimension here: signals are ``[B, n]`` (or ``[n]``) with an optional
per-row ``n_valid``, and every reduction over frames, blocks or lags is
taken per row.  Per-row shifts are modular index gathers.  The function is
differentiable: `jnp.maximum`, `jnp.minimum` and `jnp.clip` give half the
gradient to each side of an exact tie, which `torch.maximum` and
`torch.minimum` on tensor operands do too (`torch.clamp` would not), and
`_safe_root` keeps the reference package's double `where`, so silent and
padded frames give finite gradients.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.stft import frame_signal, hann_periodic
from portbench.reference.metrics._framing import as_rows, const, on_device
from portbench.reference.iir import linrec

FS = 16000
N_FFT = 512          # 32 ms at 16 kHz (P.862 Nf for 16k mode)
HOP = 256            # 50 % overlap
N_BARK = 49          # P.862 16 kHz band count
SP_16K = 6.910853e-6     # P.862 power scale Sp (16 kHz mode)
SL_16K = 1.866055e-1     # P.862 loudness scale Sl (16 kHz mode)
TARGET_POWER = 1e7
ZWICKER_POWER = 0.23
D_WEIGHT, A_WEIGHT = 0.1, 0.0309
SYLLABLE = 20        # frames per "split second" pooling window
_EPS = 1e-12

BLK = 64             # 4 ms envelope blocks of the alignment stages
MAX_UTTS = 8         # static utterance slots for per-utterance alignment
UTT_GAP_MS = 200.0   # silence gap that splits utterances
MIN_PIECE_BLOCKS = 25    # min voting blocks per split piece, and the vote
#                          margin a split must gain to be accepted
SPLIT_WIN_BLOCKS = 40    # +-window (160 ms) for the local-delay vote
SPLIT_CONF = 0.5         # min normalised local correlation to cast a vote

BAD_FRAME_THRESHOLD = 30.0   # P.862 threshold_for_bad_frames
SMEAR_RANGE = 2              # P.862 bad-frame smear radius (gap closing)
MIN_BAD_FRAMES = 5           # minimum run length that forms a bad interval
MAX_BAD_INTERVALS = 8        # static re-alignment slots
MAX_DELTA = 2048             # +-128 ms per-interval delay search window
CORR_GATE = 0.5              # unreliable searches keep the original frames


def _hz_to_bark(f: np.ndarray) -> np.ndarray:
    """Zwicker/Terhardt critical-band rate (the P.862 warping curve family)."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


@functools.lru_cache(maxsize=None)
def _bark_tables():
    """(assignment matrix [49, 257], band widths in Bark [49], centre-of-band
    Bark [49], absolute threshold internal power [49], WB input-filter power
    gain [257]), float64: each rfft bin belongs to one of 49 uniform-width
    Bark bands spanning 0..bark(8000)."""
    n_bins = N_FFT // 2 + 1
    f = np.arange(n_bins) * (FS / N_FFT)
    zmax = _hz_to_bark(np.array([FS / 2.0]))[0]
    width = zmax / N_BARK
    z = _hz_to_bark(f)
    band = np.minimum((z / width).astype(np.int64), N_BARK - 1)
    m = np.zeros((N_BARK, n_bins), np.float64)
    m[band, np.arange(n_bins)] = 1.0
    widths = np.full(N_BARK, width)
    centres = (np.arange(N_BARK) + 0.5) * width

    # each band's centre in Hz; the Terhardt absolute threshold (dB SPL),
    # 79.8 dB SPL being internal power 1e7
    fg = np.linspace(0, FS / 2, 4097)
    centre_hz = np.interp(centres, _hz_to_bark(fg), fg)
    fk = np.maximum(centre_hz, 20.0) / 1000.0
    thr_db = (3.64 * fk ** -0.8
              - 6.5 * np.exp(-0.6 * (fk - 3.3) ** 2)
              + 1e-3 * fk ** 4)
    abs_thresh = 10.0 ** ((np.clip(thr_db, -10.0, 90.0) - 9.8) / 10.0)

    # P.862.2 wideband input filter: high-pass, -3 dB near 100 Hz (a 4th
    # order Butterworth magnitude response on the bin grid)
    fc = 100.0
    hp_gain = 1.0 / (1.0 + (fc / np.maximum(f, 1e-3)) ** 8)
    hp_gain[0] = 0.0
    return m, widths, centres, abs_thresh, hp_gain


@functools.lru_cache(maxsize=None)
def _zwicker_exponents() -> np.ndarray:
    """Per-band modified Zwicker exponent (low bands get a boosted power)."""
    _, _, centres, _, _ = _bark_tables()
    h = np.where(centres < 4.0, np.minimum(6.0 / (centres + 2.0), 2.0), 1.0)
    return ZWICKER_POWER * h ** 0.15


def _band_limited_msq(x: torch.Tensor, n_valid, lo_hz: float = 350.0,
                      hi_hz: float = 3250.0) -> torch.Tensor:
    """Mean-square power of each row of x [B, n] restricted to [lo, hi] Hz
    (the P.862 level band), over its n_valid samples (Parseval)."""
    n = x.shape[-1]
    spec = torch.fft.rfft(x)
    f = np.arange(n // 2 + 1) * (FS / n)
    sel = const(((f >= lo_hz) & (f <= hi_hz)).astype(np.float32), x)
    nv = const(float(n), x) if n_valid is None else n_valid.to(x.dtype)
    return 2.0 / (n * nv) * (spec.abs() ** 2 * sel).sum(-1)


def _safe_root(s: torch.Tensor, q: float) -> torch.Tensor:
    """s ** q with a finite gradient at s == 0 (value-exact): the power is
    taken on the positive branch only, so silent and padded frames, whose
    pooled disturbance is exactly 0, give no NaN gradient."""
    pos = s > 0
    safe = torch.where(pos, s, torch.ones_like(s))
    return torch.where(pos, safe ** q, torch.zeros_like(s))


def _maximum(x: torch.Tensor, v: float) -> torch.Tensor:
    """jnp.maximum(x, v): half the gradient at a tie."""
    return torch.maximum(x, const(v, x))


def _minimum(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.minimum(x, const(v, x))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi), which is minimum(maximum(x, lo), hi)."""
    return _minimum(_maximum(x, lo), hi)


def _pseudo_lp(d: torch.Tensor, widths: torch.Tensor, p: float
               ) -> torch.Tensor:
    """Band-width-weighted Lp pooling over Bark bands (P.862 pseudo_Lp):
    (sum_b (|d_b| w_b)^p / sum_b w_b)^(1/p) * sum_b w_b.  d: [..., 49]."""
    total_w = widths.sum()
    s = ((d.abs() * widths) ** p).sum(-1) / total_w
    return _safe_root(s, 1.0 / p) * total_w


def _lpq_weight(frame_d: torch.Tensor, frame_w: torch.Tensor,
                p_syl: float = 6.0, p_time: float = 2.0) -> torch.Tensor:
    """P.862 Lpq time pooling of each row of frame_d [B, T]: Lp over 20-frame
    windows stepping 10, then Lq over windows.  `frame_w` marks valid
    frames; fully invalid windows carry zero weight."""
    t = frame_d.shape[-1]
    step = SYLLABLE // 2
    n_win = max(1, -(-t // step))
    pad = n_win * step + SYLLABLE - t
    d = torch.nn.functional.pad(frame_d, (0, pad))
    w = torch.nn.functional.pad(frame_w, (0, pad))
    idx = torch.as_tensor(np.arange(n_win)[:, None] * step
                          + np.arange(SYLLABLE)[None, :],
                          device=frame_d.device)
    dw, ww = d[:, idx], w[:, idx]                     # [B, n_win, 20]
    cnt = ww.sum(-1)
    syl = _safe_root(((dw * ww) ** p_syl).sum(-1) / _maximum(cnt, 1.0),
                     1.0 / p_syl)
    win_w = _minimum(cnt, 1.0)
    total = ((syl * win_w) ** p_time).sum(-1) / _maximum(win_w.sum(-1), 1.0)
    return _safe_root(total, 1.0 / p_time)


def _smooth_gain(h: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """P.862's short-term gain memory g_t = 0.2 g_{t-1} + 0.8 h_t from
    g_{-1} = 1 along each row of h [B, T], h set to 1 on invalid frames:
    one `linrec` call (a = 0.2 a row, y0 = 1)."""
    h = torch.where(valid > 0, h, torch.ones_like(h))
    rows = h.shape[0]
    return linrec(h.new_full((rows,), 0.2), (0.8 * h).contiguous(),
                  h.new_ones(rows))


def _rows_roll(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """jnp.roll of each row of x [B, n] by its own shift [B]."""
    n = x.shape[-1]
    idx = (torch.arange(n, device=x.device)[None, :] - shift[:, None]) % n
    return x.gather(-1, idx)


def _lag_table(max_lag: int, device) -> torch.Tensor:
    """Lags 0..max_lag, then -max_lag..-1: the circular cross-correlation's
    order."""
    return torch.cat([torch.arange(max_lag + 1, device=device),
                      torch.arange(-max_lag, 0, device=device)])


def _circular_lags(xc: torch.Tensor, max_lag: int) -> torch.Tensor:
    """xc[..., :max_lag + 1] then xc[..., -max_lag:], in _lag_table's
    order (as the reference package slices, all of xc when max_lag is 0)."""
    return torch.cat([xc[..., :max_lag + 1], xc[..., -max_lag:]], -1)


def _pick(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx], an index past the end clamped as JAX's gathers clamp."""
    return table[idx.clamp_max(table.shape[0] - 1)]


def pesq_p862_16k(ref, deg, n_valid=None, align_global: bool = False,
                  align_utterances: bool = False,
                  align_bad_intervals: bool = False) -> torch.Tensor:
    """Raw P.862 PESQ (about [-0.5, 4.5]) of 16 kHz signals ref, deg [n] or
    [B, n], zero-padded beyond `n_valid` (optional, per row).

    align_global: search one global delay (+-128 ms) by envelope
      cross-correlation first.  align_utterances: P.862 utterance splitting
      with a per-utterance delay (implies the global search).
      align_bad_intervals: the P.862 bad-interval re-alignment (implies both
      stages above): high-disturbance frame runs get a fresh delay search
      and their disturbances are recomputed at the better delay."""
    ref, nv, single = as_rows(ref, n_valid)
    deg = deg[None] if single else deg
    dt, dev = ref.dtype, ref.device
    n = ref.shape[-1]
    if nv is not None:
        smask = (torch.arange(n, device=dev)[None, :]
                 < nv[:, None]).to(dt)
        ref = ref * smask
        deg = deg * smask

    if align_global or align_utterances or align_bad_intervals:
        deg = _global_align(ref, deg)
    if align_utterances or align_bad_intervals:
        deg = _utterance_align(ref, deg)

    # 1. level alignment
    ref = ref * torch.sqrt(TARGET_POWER / _maximum(
        _band_limited_msq(ref, nv), _EPS))[:, None]
    deg = deg * torch.sqrt(TARGET_POWER / _maximum(
        _band_limited_msq(deg, nv), _EPS))[:, None]

    # 3./2. frames -> power spectra, the WB high-pass folded in
    bark_m, widths_np, _, thresh_np, hp_np = _bark_tables()
    win = const(hann_periodic(N_FFT), ref)
    hp = const(hp_np, ref)
    pr = torch.fft.rfft(frame_signal(ref, N_FFT, HOP, center=False) * win,
                        dim=-1).abs() ** 2 * hp               # [B, T, 257]
    pd = torch.fft.rfft(frame_signal(deg, N_FFT, HOP, center=False) * win,
                        dim=-1).abs() ** 2 * hp
    t_frames = pr.shape[-2]
    if nv is None:
        fmask = torch.ones(ref.shape[0], t_frames, dtype=dt, device=dev)
    else:
        t_valid = torch.clamp_min((nv - N_FFT) // HOP + 1, 1)
        fmask = (torch.arange(t_frames, device=dev)[None, :]
                 < t_valid[:, None]).to(dt)

    # 4. Bark pitch power densities
    bark = const(bark_m, ref)
    widths = const(widths_np, ref)
    thresh = const(thresh_np, ref)
    ppr = SP_16K * (pr @ bark.T)                              # [B, T, 49]
    ppd = SP_16K * (pd @ bark.T)

    def audible(p):
        return torch.where(p > thresh, p, torch.zeros_like(p)).sum(-1)

    aud_ref = audible(ppr) * fmask
    aud_deg = audible(ppd) * fmask

    # 5. partial frequency-response compensation (of the reference)
    active = (aud_ref > 1e4).to(dt) * fmask
    n_act = _maximum(active.sum(-1), 1.0)[:, None]
    avg_r = (ppr * active[..., None]).sum(-2) / n_act
    avg_d = (ppd * active[..., None]).sum(-2) / n_act
    freq_comp = _clip((avg_d + 1000.0) / (avg_r + 1000.0), 0.01, 100.0)
    ppr = ppr * freq_comp[:, None, :]
    aud_ref_c = audible(ppr) * fmask

    # 6. short-term gain compensation (of the degraded)
    h = _clip((aud_ref_c + 5e3) / (aud_deg + 5e3), 3e-4, 5.0)
    gain = _smooth_gain(h, fmask)
    ppd = ppd * gain[..., None]

    # 7. Zwicker loudness
    zw = const(_zwicker_exponents(), ref)

    def loudness(p):
        s = ((thresh / 0.5) ** zw
             * ((0.5 + 0.5 * p / thresh) ** zw - 1.0))
        return SL_16K * _maximum(s, 0.0)

    lr = loudness(ppr)
    fw = ((aud_ref + 1e5) / 1e7) ** 0.04

    def frames_disturbance(ppd_g):
        """Stages 8-9 from a gain-compensated degraded pitch power density
        [B, T, 49], against the same compensated reference loudness and
        frame weights (the bad-interval stage recomputes shifted frames)."""
        ld = loudness(ppd_g)
        d = ld - lr
        dead = 0.25 * torch.minimum(lr, ld)
        d_sym = torch.sign(d) * _maximum(d.abs() - dead, 0.0)
        asym = ((ppd_g + 50.0) / (ppr + 50.0)) ** 1.2
        asym = torch.where(asym < 3.0, torch.zeros_like(asym),
                           _minimum(asym, 12.0))
        d_asym = d_sym * asym
        f_sym = _minimum(_pseudo_lp(d_sym, widths, 2.0) / fw, 45.0) * fmask
        f_asym = _minimum(_pseudo_lp(d_asym, widths, 1.0) / fw,
                          45.0) * fmask
        return f_sym, f_asym

    # 8./9. disturbance, asymmetry, frame pooling
    frame_sym, frame_asym = frames_disturbance(ppd)
    if align_bad_intervals:
        frame_sym, frame_asym = _bad_interval_realign(
            ref, deg, frame_sym, frame_asym, fmask, gain,
            frames_disturbance, win, hp, bark)

    # 10./11. time pooling -> raw PESQ
    d_ind = _lpq_weight(frame_sym, fmask)
    a_ind = _lpq_weight(frame_asym, fmask)
    out = 4.5 - D_WEIGHT * d_ind - A_WEIGHT * a_ind
    return out[0] if single else out


def _global_align(ref: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """One global delay per row (P.862's crude alignment, 4 ms envelope
    cross-correlation), applied as a roll of the degraded row."""
    rows = ref.shape[0]
    m = ref.shape[-1] // BLK
    if m == 0:
        return deg
    n = m * BLK
    er = torch.log1p((ref[:, :n].reshape(rows, m, BLK) ** 2).sum(-1))
    ed = torch.log1p((deg[:, :n].reshape(rows, m, BLK) ** 2).sum(-1))
    er = er - er.mean(-1, keepdim=True)
    ed = ed - ed.mean(-1, keepdim=True)
    fr = torch.fft.rfft(er, n=2 * m)
    fd = torch.fft.rfft(ed, n=2 * m)
    xc = torch.fft.irfft(fr * fd.conj(), n=2 * m)
    max_lag = min(m - 1, (FS // BLK) * 128 // 1000)          # +-128 ms
    delay = _pick(_lag_table(max_lag, ref.device),
                  _circular_lags(xc, max_lag).argmax(-1))
    return _rows_roll(deg, delay * BLK)


def _boxsum(x: torch.Tensor) -> torch.Tensor:
    """Window sums along axis 1 of x [B, m, ...], radius SPLIT_WIN_BLOCKS,
    by a padded cumulative sum."""
    m = x.shape[1]
    cs = torch.cat([torch.zeros_like(x[:, :1]), x.cumsum(1)], 1)
    ar = torch.arange(m, device=x.device)
    hi = torch.clamp_max(ar + SPLIT_WIN_BLOCKS + 1, m)
    lo = torch.clamp_min(ar - SPLIT_WIN_BLOCKS, 0)
    return cs[:, hi] - cs[:, lo]


def _row_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, ..., idx[b, ...]] along the last axis, idx one dim short of x
    or of x's rank: a gather of one element per index."""
    return x.gather(-1, idx[..., None])[..., 0]


def _utterance_align(ref: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """P.862-style utterance splitting with a per-utterance delay, per row.

    4 ms block energies -> a VAD 25 dB below each row's peak -> utterance
    starts where activity resumes after UTT_GAP_MS of silence, silence
    split at its midpoint -> per static slot, an envelope correlation that
    may split the slot into two pieces with their own delays when the local
    delay votes jump -> a waveform refinement per piece -> the degraded row
    rebuilt by one sample gather, each sample shifted by its piece's
    delay."""
    dt, dev = ref.dtype, ref.device
    rows, nfull = ref.shape
    m = nfull // BLK
    if m == 0:           # shorter than one 4 ms block: nothing to align
        return deg
    n = m * BLK
    er = (ref[:, :n].reshape(rows, m, BLK) ** 2).sum(-1)      # [B, M]
    ed = (deg[:, :n].reshape(rows, m, BLK) ** 2).sum(-1)
    er_db = 10.0 * torch.log10(er + _EPS)
    active = er_db > er_db.amax(-1, keepdim=True) - 25.0

    # utterance starts: an active block with no activity in the GAP blocks
    # before it (a cumulative-sum window)
    gap = int(UTT_GAP_MS * FS / 1000 / BLK)
    ar = torch.arange(m, device=dev)
    act_i = active.long()
    csum = torch.cat([torch.zeros_like(act_i[:, :1]), act_i.cumsum(-1)], -1)
    prev_any = (csum[:, :-1] - csum[:, torch.clamp_min(ar - gap, 0)]) > 0
    starts = active & ~prev_any
    uid = torch.clamp(starts.long().cumsum(-1) - 1, 0, MAX_UTTS - 1)
    # silence between utterances goes to the nearer one
    neg = torch.full_like(ar, -1)
    prev_act = torch.where(active, ar, neg).cummax(-1).values
    rev = active.flip(-1)
    next_act = m - 1 - torch.where(rev, ar, neg).cummax(-1).values.flip(-1)
    has_next = rev.long().cummax(-1).values.flip(-1).bool()
    use_next = has_next & ((prev_act < 0) | (next_act - ar < ar - prev_act))
    uid = torch.where(use_next, uid.gather(-1, next_act.clamp(0, m - 1)),
                      uid)

    # per-slot, split-aware delay: envelope correlations at every lag
    le = torch.log1p(er)
    ld_ = torch.log1p(ed)
    ld_ = ld_ - ld_.mean(-1, keepdim=True)
    max_lag = min(m - 1, (FS // BLK) * 128 // 1000)          # +-128 ms
    lags_b = torch.arange(-max_lag, max_lag + 1, device=dev)  # [L]
    n_lags = lags_b.shape[0]
    src_b = ar[:, None] - lags_b[None, :]                     # [M, L]
    src_c = src_b.clamp(0, m - 1)
    inside = (src_b >= 0) & (src_b < m)
    dmat = torch.where(inside, ld_[:, src_c],
                       torch.zeros((), dtype=dt, device=dev))  # [B, M, L]

    # local delay votes: each block's +-SPLIT_WIN_BLOCKS window of the
    # reference envelope against the degraded at every lag, normalised; a
    # confident block votes for its best lag
    le_c = le - le.mean(-1, keepdim=True)
    c_loc = _boxsum(le_c[..., None] * dmat)                   # [B, M, L]
    e_loc = _boxsum(le_c ** 2)                                # [B, M]
    b_loc = _boxsum(ld_ ** 2)
    bl = b_loc[:, src_c]                                      # [B, M, L]
    nc = c_loc / (torch.sqrt(e_loc[..., None] * bl) + _EPS)
    conf = nc.amax(-1)
    local_lag = nc.argmax(-1)
    votes = (torch.nn.functional.one_hot(local_lag, n_lags).to(dt)
             * (active & (conf > SPLIT_CONF))[..., None].to(dt))

    # the slots, [B, U, ...]: the unsplit coarse lag over the slot's extent,
    # and the best split of its votes into two contiguous pieces
    slots = torch.arange(MAX_UTTS, device=dev)
    msk = uid[:, None, :] == slots[None, :, None]             # [B, U, M]
    mskf = msk.to(dt)
    cnt = torch.clamp_min(msk.sum(-1), 1)[..., None]
    e = torch.where(msk, le[:, None, :] - (le[:, None, :] * mskf).sum(
        -1, keepdim=True) / cnt, torch.zeros((), dtype=dt, device=dev))
    total_x = (e[..., None] * dmat[:, None]).sum(-2)          # [B, U, L]
    d0 = lags_b[total_x.argmax(-1)]
    v = votes[:, None] * mskf[..., None]                      # [B, U, M, L]
    pre = torch.cat([torch.zeros_like(v[:, :, :1]), v.cumsum(-2)], -2)
    total_v = pre[:, :, -1]                                   # [B, U, L]
    suf = total_v[:, :, None] - pre
    explained = pre.amax(-1) + suf.amax(-1)                   # [B, U, M+1]
    vs = v.sum(-1)
    c = torch.cat([torch.zeros_like(vs[..., :1]), vs.cumsum(-1)], -1)
    ok = (c >= MIN_PIECE_BLOCKS) & (c[..., -1:] - c >= MIN_PIECE_BLOCKS)
    score = torch.where(ok, explained,
                        torch.full_like(explained, -float("inf")))
    s_star = score.argmax(-1)                                 # [B, U]
    unsplit_v = total_v.amax(-1)
    at = s_star[..., None, None].expand(-1, -1, 1, n_lags)
    d_l = lags_b[pre.gather(2, at)[:, :, 0].argmax(-1)]
    d_r = lags_b[suf.gather(2, at)[:, :, 0].argmax(-1)]
    do_split = (ok.any(-1)
                & (_row_take(score, s_star) >= unsplit_v + MIN_PIECE_BLOCKS)
                & (d_l != d_r))
    split_at = torch.where(do_split, s_star, torch.full_like(s_star, m))
    d_left = torch.where(do_split, d_l, d0)
    d_right = torch.where(do_split, d_r, d0)

    # sample-resolution refinement of each piece (2 a slot, [B, 2U]): the
    # waveform cross-correlation of its masked reference against the
    # degraded row, in a +-1-block window around the coarse delay
    fd_s = torch.fft.rfft(deg, n=2 * nfull)
    piece_u = slots.repeat_interleave(2)                      # [2U]
    left = (torch.arange(2 * MAX_UTTS, device=dev) % 2 == 0)[None, :, None]
    split_p = split_at[:, piece_u]                            # [B, 2U]
    in_side = torch.where(left, ar < split_p[..., None],
                          ar >= split_p[..., None])           # [B, 2U, M]
    pm = msk[:, piece_u] & active[:, None] & in_side
    coarse = torch.where(left[..., 0], d_left[:, piece_u],
                         d_right[:, piece_u]) * BLK           # [B, 2U]
    msk_s = torch.nn.functional.pad(pm.repeat_interleave(BLK, -1),
                                    (0, nfull - n))
    r_m = torch.where(msk_s, ref[:, None],
                      torch.zeros((), dtype=dt, device=dev))
    xs = torch.fft.irfft(torch.fft.rfft(r_m, n=2 * nfull)
                         * fd_s[:, None].conj(), n=2 * nfull)  # [B, 2U, 2n]
    k = torch.arange(2 * BLK + 1, device=dev)
    win = xs.gather(-1, (k - (BLK - coarse)[..., None]) % (2 * nfull))
    d = coarse + win.argmax(-1) - BLK
    delays = torch.where(pm.any(-1), d, torch.zeros_like(d))   # [B, 2U]

    # rebuild: sample i of the aligned row comes from deg[i - delay]
    side_b = (ar >= split_at.gather(-1, uid)).long()          # [B, M]
    shift_b = delays.gather(-1, 2 * uid + side_b)             # [B, M]
    shift = shift_b.repeat_interleave(BLK, -1)
    if nfull > n:        # a ragged tail keeps the last piece's delay
        shift = torch.cat([shift, shift_b[:, -1:].expand(-1, nfull - n)], -1)
    src = torch.arange(nfull, device=dev)[None, :] - shift
    gathered = deg.gather(-1, src.clamp(0, nfull - 1))
    valid = (src >= 0) & (src < nfull)
    return torch.where(valid, gathered, torch.zeros((), dtype=dt, device=dev))


def _bad_interval_realign(ref, deg, frame_sym, frame_asym, fmask, gain,
                          frames_disturbance, win, hp, bark):
    """P.862 bad-interval re-alignment (ITU source dsp.c flow, re-derived),
    per row: frames whose pooled disturbance exceeds 30 form runs (a
    smear closes gaps of up to 2 good frames); each of the first
    MAX_BAD_INTERVALS runs of >= 5 frames gets a delay search by waveform
    cross-correlation of the run's reference samples against the degraded
    row, gated by the correlation normalised with the energies of the
    windows it correlates; the run's frames are re-windowed at the new
    delay, pushed through the same loudness and disturbance stages with the
    stored gain, and the smaller per-frame disturbance wins."""
    dt, dev = ref.dtype, ref.device
    rows, t_frames = frame_sym.shape
    n = ref.shape[-1]
    valid_f = fmask > 0
    bad = (frame_sym > BAD_FRAME_THRESHOLD) & valid_f
    # a frame is (or stays) bad iff a bad frame lies within SMEAR_RANGE on
    # its left and within SMEAR_RANGE on its right
    badf = bad.to(torch.float32)
    span = SMEAR_RANGE + 1
    left = torch.nn.functional.pad(badf, (SMEAR_RANGE, 0)).unfold(
        -1, span, 1).sum(-1) > 0
    right = torch.nn.functional.pad(badf, (0, SMEAR_RANGE)).unfold(
        -1, span, 1).sum(-1) > 0
    bad = left & right & valid_f
    prev = torch.cat([torch.zeros_like(bad[:, :1]), bad[:, :-1]], -1)
    starts = bad & ~prev
    rid = torch.where(bad, starts.long().cumsum(-1) - 1,
                      torch.full_like(frame_sym, -1, dtype=torch.long))

    fd_s = torch.fft.rfft(deg, n=2 * n)
    max_delta = min(MAX_DELTA, n - 1)
    ar_n = torch.arange(n, device=dev)
    idx_f = torch.arange(t_frames, device=dev)
    ce_d = torch.cat([torch.zeros_like(deg[:, :1]), (deg * deg).cumsum(-1)],
                     -1)                                      # [B, n+1]

    # the slots, [B, S]
    slots = torch.arange(MAX_BAD_INTERVALS, device=dev)
    fm = rid[:, None, :] == slots[None, :, None]              # [B, S, T]
    qual = fm.sum(-1) >= MIN_BAD_FRAMES
    start = torch.where(fm, idx_f, torch.full_like(idx_f, t_frames)).amin(-1)
    stop = torch.where(fm, idx_f, torch.full_like(idx_f, -1)).amax(-1)
    msk_s = ((ar_n >= (start * HOP)[..., None])
             & (ar_n < (stop * HOP + N_FFT)[..., None]))      # [B, S, n]
    r_m = torch.where(msk_s, ref[:, None],
                      torch.zeros((), dtype=dt, device=dev))
    xs = torch.fft.irfft(torch.fft.rfft(r_m, n=2 * n) * fd_s[:, None].conj(),
                         n=2 * n)
    vals = _circular_lags(xs, max_delta)
    best = vals.argmax(-1)                                    # [B, S]
    lag = _pick(_lag_table(max_delta, dev), best)
    # the peak normalised by the energies of the windows it correlates: the
    # run's reference and the degraded window shifted by the lag
    e_r = (r_m ** 2).sum(-1)
    lo = torch.clamp(start * HOP - lag, 0, n)
    hi = torch.clamp(stop * HOP + N_FFT - lag, 0, n)
    e_d = ce_d.gather(-1, hi) - ce_d.gather(-1, lo)
    corr = _row_take(vals, best) / torch.sqrt(_maximum(e_r * e_d, _EPS))
    ok = qual & (corr > CORR_GATE)
    deltas = torch.where(ok, lag, torch.zeros_like(lag))
    in_slot = (rid >= 0) & (rid < MAX_BAD_INTERVALS)
    shift = torch.where(in_slot,
                        deltas.gather(-1, rid.clamp(0, MAX_BAD_INTERVALS - 1)),
                        torch.zeros_like(rid))                # [B, T]

    # the degraded frames re-windowed at each frame's shift: sample i comes
    # from deg[i - delta]
    base = (idx_f[:, None] * HOP
            + torch.arange(N_FFT, device=dev)[None, :])       # [T, 512]
    src = base[None] - shift[..., None]                       # [B, T, 512]
    valid = (src >= 0) & (src < n)
    fdg = torch.where(valid, deg.gather(
        -1, src.clamp(0, n - 1).reshape(rows, -1)).reshape(src.shape),
        torch.zeros((), dtype=dt, device=dev)) * win
    pd2 = torch.fft.rfft(fdg, dim=-1).abs() ** 2 * hp
    ppd2 = SP_16K * (pd2 @ bark.T) * gain[..., None]
    sym2, asym2 = frames_disturbance(ppd2)
    replace = (shift != 0) & (sym2 < frame_sym)
    return (torch.where(replace, sym2, frame_sym),
            torch.where(replace, asym2, frame_asym))


def mos_lqo_wb(raw_pesq):
    """P.862.2 wideband raw-score -> MOS-LQO mapping."""
    raw_pesq = torch.as_tensor(raw_pesq)
    return 0.999 + 4.0 / (1.0 + torch.exp(-1.3669 * raw_pesq + 3.8224))


def pesq_p862(ref, deg, fs: int = 16000, align_global: bool = False,
              align_utterances: bool = False,
              align_bad_intervals: bool = False, device=None):
    """Raw PESQ of ref, deg trimmed to equal length.  Tensors are scored
    where they lie, host arrays on `device` (None: CUDA)."""
    assert fs == FS, "pesq_p862 expects 16 kHz input"
    ref, deg = on_device(ref, device), on_device(deg, device)
    n = min(ref.shape[-1], deg.shape[-1])
    return pesq_p862_16k(ref[..., :n], deg[..., :n],
                         align_global=align_global,
                         align_utterances=align_utterances,
                         align_bad_intervals=align_bad_intervals)
