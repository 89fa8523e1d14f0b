"""Multi-metric GAN training steps over bucketed batches.

Counterpart of `nelegan_tpu/train/gan.py` (which re-architects the
reference's per-utterance loops, reference: train_nele.py:122-156 G step,
:342-426 D steps).  Semantics, as there:

  * G loss = MSE(D(enh, noise, clean), 1) + 0.5 * MSE(D_Qua(enh, clean), 1)
    (train_nele.py:152, weight_qua = 0.5), with row-masked means
    (`row_valid`) and per-column weights (`intel_cols`, `quality_cols`);
  * beta^2 utterance-level energy normalisation (train_nele.py:133-138);
  * the discriminators run in training mode during the G step, so their
    power iterations advance; no gradient reaches their parameters;
  * D and D_Qua train with separate Adam optimisers (train_nele.py:89-91).

Padded frames are masked exactly: the generator is causal, the band images
are zeroed past each utterance's frame count, and the discriminators' pool
skips every conv output whose receptive field reaches padding.

The reference package's steps are pure functions of an immutable state.
Here a `TrainState` holds torch modules and optimisers, and every step
updates it in place (and returns it, with its losses as device tensors, so
no step waits for the device).  Copy a state with `copy.deepcopy`.
Featurization runs without autograd through `pipeline.featurize_batch`,
whose noise PSD is the IMCRA kernel on a CUDA device (one launch a batch).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools

import numpy as np
import torch

from nelegan_tpu_torch.config import Config
from nelegan_tpu_torch.device import resolve_device
from nelegan_tpu_torch.dsp.erb import band_energy
from nelegan_tpu_torch.dsp.stft import stft
from nelegan_tpu_torch.models.discriminator import (IntelDiscriminator,
                                                    QualityDiscriminator)
from nelegan_tpu_torch.models.generator import Generator
from nelegan_tpu_torch.pipeline import (beta2_energy_norm, featurize_batch,
                                        frame_mask, pcm16_quantize,
                                        reflect_pad_device)


@dataclasses.dataclass
class TrainState:
    """The three models, their Adam optimisers and the step counters."""
    gen: Generator
    gen_opt: torch.optim.Adam
    d: IntelDiscriminator
    d_opt: torch.optim.Adam
    dq: QualityDiscriminator
    dq_opt: torch.optim.Adam
    step_g: int = 0
    step_d: int = 0

    @property
    def device(self) -> torch.device:
        return self.gen.fc1.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gen.fc1.weight.dtype

    def state_dict(self) -> dict:
        """Live references to every tensor of the state (module state dicts
        with u and v, optimiser state dicts) and the step counters."""
        return {"gen": self.gen.state_dict(), "d": self.d.state_dict(),
                "dq": self.dq.state_dict(),
                "gen_opt": self.gen_opt.state_dict(),
                "d_opt": self.d_opt.state_dict(),
                "dq_opt": self.dq_opt.state_dict(),
                "step_g": self.step_g, "step_d": self.step_d}

    def load_state_dict(self, sd: dict) -> None:
        """Copy `sd` into this state, cast to its device and dtype.  The
        optimiser states are copied first: `Optimizer.load_state_dict` would
        otherwise share a tensor already on the right device and dtype."""
        for name in ("gen", "d", "dq"):
            getattr(self, name).load_state_dict(sd[name], strict=True)
        for name in ("gen_opt", "d_opt", "dq_opt"):
            getattr(self, name).load_state_dict(copy.deepcopy(sd[name]))
        self.step_g = int(sd["step_g"])
        self.step_d = int(sd["step_d"])


def init_train_state(cfg: Config = Config(), seed: int = 0, device=None,
                     gen_state: dict | None = None,
                     dtype: torch.dtype = torch.float32) -> TrainState:
    """A fresh state on `device` (None: CUDA) in `dtype`: weights drawn on
    the CPU from a `torch.Generator` seeded with `seed` (the same models on
    every device), then G, D and D_Qua in that order; `gen_state`, a
    generator state dict, replaces G's draw."""
    dev = resolve_device(device)
    rng = torch.Generator().manual_seed(seed)
    # the constructors draw torch's default init from the global generator;
    # every tensor is drawn again below, so leave the caller's global
    # generator as it was
    with torch.random.fork_rng(devices=[]):
        gen = Generator.from_config(cfg.model)
        d = IntelDiscriminator.from_config(cfg.model)
        dq = QualityDiscriminator.from_config(cfg.model)
    for m in (gen, d, dq):
        m.reset_parameters(rng)
    if gen_state is not None:
        gen.load_state_dict(gen_state, strict=True)
    gen, d, dq = (m.to(device=dev, dtype=dtype) for m in (gen, d, dq))
    return TrainState(
        gen=gen, gen_opt=torch.optim.Adam(gen.parameters(), lr=cfg.train.lr_g),
        d=d, d_opt=torch.optim.Adam(d.parameters(), lr=cfg.train.lr_d),
        dq=dq, dq_opt=torch.optim.Adam(dq.parameters(), lr=cfg.train.lr_dqua))


def _as_device(x, dtype, dev: torch.device) -> torch.Tensor:
    """`x` (tensor or array) on `dev` in `dtype` (None keeps it).  A host
    array goes through pinned memory without blocking, so the upload of a
    step's small inputs (row masks, targets) does not wait for the device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.require(x, requirements=("C", "W")))
        if dev.type == "cuda":
            x = x.pin_memory()
    return x.to(device=dev, dtype=dtype, non_blocking=True)


@functools.lru_cache(maxsize=None)
def _col_weights(cols, n: int, dtype: torch.dtype,
                 dev: torch.device) -> torch.Tensor:
    """Per-column loss weights normalised to mean 1 over the active columns
    (None: all active).  A metric column that is not being scored carries
    no loss: its targets would be made up and G and D would fight over a
    dead output.  Cached: a constant of (cols, n, dtype, device), never
    written."""
    if cols is None:
        w = [1.0] * n
    else:
        w = [float(c) * n / max(float(sum(cols)), 1.0) for c in cols]
    return torch.tensor(w, dtype=dtype).to(dev)


def _row_weights(row_valid, b: int, dtype, dev):
    """(row weights [B], their sum clamped to >= 1): padding rows (0) carry
    no loss, so shape padding cannot reweight gradients."""
    rv = (torch.ones(b, dtype=dtype, device=dev) if row_valid is None
          else _as_device(row_valid, dtype, dev))
    return rv, torch.clamp_min(rv.sum(), 1.0)


def _masked_mse(score, target, rv, w, rden) -> torch.Tensor:
    return (torch.sum(rv[:, None] * w * (score - target) ** 2)
            / (rden * score.shape[-1]))


def _band_images(enh, noise, clean, fmask):
    """[B, T, 64] bands -> zero-padded NCHW images [B, 3, 64, T] (enhanced,
    noise, clean) and [B, 2, 64, T] (enhanced, clean)."""
    def img(b):
        return (b * fmask[..., None]).transpose(1, 2)
    e, c = img(enh), img(clean)
    return torch.stack([e, img(noise), c], dim=1), torch.stack([e, c], dim=1)


@contextlib.contextmanager
def _frozen(*modules):
    """No parameter of `modules` requires a gradient inside the block, so
    a forward there builds no graph to them."""
    params = [p for m in modules for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def g_step_bands(state: TrainState, clean_band, noise_band, frames,
                 cfg: Config = Config(), intel_cols: tuple | None = None,
                 quality_cols: tuple | None = None, row_valid=None):
    """One generator update from band features ``[B, T, 64]``.

    intel_cols / quality_cols: 0/1 tuples of the score columns that carry
    loss (None: all).  row_valid [B] 0/1: shape-padding rows carry none.
    Returns (state, loss), the loss a device scalar."""
    dev, dt = state.device, state.dtype
    clean_band = _as_device(clean_band, dt, dev)
    noise_band = _as_device(noise_band, dt, dev)
    frames = _as_device(frames, None, dev)
    p = cfg.train.p_power
    b, t = clean_band.shape[:2]
    fmask = frame_mask(frames, t).to(dt)
    wi = _col_weights(intel_cols, cfg.model.n_intel_scores, dt, dev)
    wq = _col_weights(quality_cols, cfg.model.n_quality_scores, dt, dev)
    rv, rden = _row_weights(row_valid, b, dt, dev)

    state.d.train()
    state.dq.train()
    mask = state.gen(clean_band, noise_band)
    beta2 = beta2_energy_norm(clean_band, mask, fmask, inv_p=cfg.train.inv_p)
    enh_band = clean_band * mask ** p * beta2 ** p
    img3, img2 = _band_images(enh_band, noise_band, clean_band, fmask)
    with _frozen(state.d, state.dq):
        score = state.d(img3, frames)
        score_q = state.dq(img2, frames)
    loss = (_masked_mse(score, 1.0, rv, wi, rden)
            + cfg.train.weight_qua * _masked_mse(score_q, 1.0, rv, wq, rden))
    state.gen_opt.zero_grad(set_to_none=True)
    loss.backward()
    state.gen_opt.step()
    state.step_g += 1
    return state, loss.detach()


def g_step(state: TrainState, feats, cfg: Config = Config(),
           intel_cols: tuple | None = None, quality_cols: tuple | None = None,
           row_valid=None):
    """`g_step_bands` on a `pipeline.BatchFeatures`."""
    return g_step_bands(state, feats.clean_band, feats.noise_band,
                        feats.frames, cfg, intel_cols, quality_cols, row_valid)


@torch.no_grad()
def featurize_bands(clean_padded, noise_padded, lengths,
                    cfg: Config = Config(), device=None):
    """(clean_band, noise_band, frames) of reflect-prepadded batches, the
    band cache's rows: one IMCRA launch on a CUDA device."""
    feats = featurize_batch(clean_padded, noise_padded, lengths,
                            cfg.train.p_power, cfg.imcra, device=device)
    return feats.clean_band, feats.noise_band, feats.frames


@torch.no_grad()
def speech_band(wav_padded, cfg: Config = Config(), device=None):
    """Band features [B, T, 64] of a reflect-prepadded speech batch (no
    IMCRA)."""
    wav = torch.as_tensor(wav_padded, device=resolve_device(device))
    spec = stft(wav, center=False)
    return band_energy(spec.abs().transpose(-1, -2)) ** cfg.train.p_power


@torch.no_grad()
def eband_from_enhanced(wav, out_lens, cfg: Config = Config(), device=None):
    """Band features of `enhance_batch`'s output as its PCM16 files hold
    it: quantized, reflect-padded per row on the device, then STFT bands,
    without a round trip through the disk."""
    wav = torch.as_tensor(wav, device=resolve_device(device))
    padded = reflect_pad_device(pcm16_quantize(wav), out_lens)
    return speech_band(padded, cfg, device=wav.device)


@torch.no_grad()
def d_images(eband, noise_band, clean_band, frames):
    """The discriminator images from band features [B, T, 64]."""
    t = eband.shape[1]
    fmask = frame_mask(frames.to(eband.device), t).to(eband.dtype)
    return _band_images(eband, noise_band, clean_band, fmask)


@torch.no_grad()
def featurize_triple(enh_padded, noise_padded, clean_padded, lengths,
                     cfg: Config = Config(), device=None):
    """An (enhanced, noise, clean) batch of reflect-prepadded wavs
    [B, n + 512] -> (img3, img2, frames) (reference: dataloader.py:54-84)."""
    feats = featurize_batch(clean_padded, noise_padded, lengths,
                            cfg.train.p_power, cfg.imcra, device=device)
    eband = speech_band(enh_padded, cfg, device=feats.frames.device)
    img3, img2 = d_images(eband, feats.noise_band, feats.clean_band,
                          feats.frames)
    return img3, img2, feats.frames


def d_step(state: TrainState, img3, img2, frames, targets, targets_q,
           cfg: Config = Config(), update_intel: bool = True,
           update_quality: bool = True, intel_cols: tuple | None = None,
           quality_cols: tuple | None = None, row_valid=None):
    """One discriminator update, the intelligibility head first, each head
    with its own optimiser.  A head with ``update_*=False`` is untouched
    (its power iteration too) and its loss is 0.  Returns (state, loss_d,
    loss_dq) with device-scalar losses."""
    dev, dt = state.device, state.dtype
    img3, img2 = _as_device(img3, dt, dev), _as_device(img2, dt, dev)
    frames = _as_device(frames, None, dev)
    wi = _col_weights(intel_cols, cfg.model.n_intel_scores, dt, dev)
    wq = _col_weights(quality_cols, cfg.model.n_quality_scores, dt, dev)
    rv, rden = _row_weights(row_valid, img3.shape[0], dt, dev)
    losses = []
    for update, model, opt, img, tgt, w in (
            (update_intel, state.d, state.d_opt, img3, targets, wi),
            (update_quality, state.dq, state.dq_opt, img2, targets_q, wq)):
        if not update:
            losses.append(torch.zeros((), dtype=dt, device=dev))
            continue
        model.train()
        loss = _masked_mse(model(img, frames), _as_device(tgt, dt, dev), rv,
                           w, rden)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    state.step_d += 1
    return state, losses[0], losses[1]


def d_step_bands(state: TrainState, eband, noise_band, clean_band, frames,
                 targets, targets_q, cfg: Config = Config(),
                 update_intel: bool = True, update_quality: bool = True,
                 intel_cols: tuple | None = None,
                 quality_cols: tuple | None = None, row_valid=None):
    """`d_step` from enhanced, noise and clean band features (the training
    loop's band pool)."""
    dev, dt = state.device, state.dtype
    frames = _as_device(frames, None, dev)
    img3, img2 = d_images(*(_as_device(x, dt, dev)
                            for x in (eband, noise_band, clean_band)), frames)
    return d_step(state, img3, img2, frames, targets, targets_q, cfg,
                  update_intel, update_quality, intel_cols, quality_cols,
                  row_valid)


def d_step_enhanced(state: TrainState, enh_padded, noise_band, clean_band,
                    frames, targets, targets_q, cfg: Config = Config(),
                    update_intel: bool = True, update_quality: bool = True,
                    intel_cols: tuple | None = None,
                    quality_cols: tuple | None = None, row_valid=None):
    """`d_step` from a reflect-prepadded enhanced-wav batch and the cached
    clean and noise bands."""
    eband = speech_band(enh_padded, cfg, device=state.device)
    return d_step_bands(state, eband, noise_band, clean_band, frames,
                        targets, targets_q, cfg, update_intel,
                        update_quality, intel_cols, quality_cols, row_valid)


def d_steps_scan(state: TrainState, eband, clean_band, noise_band, frames,
                 targets, targets_q, row_valid, group_valid,
                 cfg: Config = Config(), update_intel: bool = True,
                 update_quality: bool = True, intel_cols: tuple | None = None,
                 quality_cols: tuple | None = None):
    """Sequential D updates over G same-bucket groups: `d_step_bands` on
    each group in turn.

    Band inputs are flat ``[G*B, ...]``; targets [G, B, 3], targets_q
    [G, B, 2], row_valid [G, B].  group_valid [G] is a host bool array (a
    CUDA tensor is refused): a False group is shape padding, skipped on the
    host with no device sync, and leaves the state (step_d too) untouched.
    Returns (state, losses [G, 2] float32), zeros for a skipped group."""
    if (isinstance(group_valid, torch.Tensor)
            and group_valid.device.type != "cpu"):
        raise ValueError("d_steps_scan: group_valid must be a host array, "
                         f"not a tensor on {group_valid.device}")
    group_valid = np.asarray(group_valid, bool)
    g, b = tuple(targets.shape[:2])
    if group_valid.shape != (g,):
        raise ValueError(f"d_steps_scan: group_valid {group_valid.shape} "
                         f"for {g} groups")
    dev, dt = state.device, state.dtype
    eband, clean_band, noise_band = (_as_device(x, dt, dev)
                                     for x in (eband, clean_band, noise_band))
    frames = _as_device(frames, None, dev)
    targets, targets_q, row_valid = (_as_device(x, dt, dev)
                                     for x in (targets, targets_q, row_valid))
    losses = []
    for i in range(g):
        if not group_valid[i]:
            losses.append(torch.zeros(2, dtype=torch.float32, device=dev))
            continue
        rows = slice(i * b, (i + 1) * b)
        _, ld, lq = d_step_bands(
            state, eband[rows], noise_band[rows], clean_band[rows],
            frames[rows], targets[i], targets_q[i], cfg, update_intel,
            update_quality, intel_cols, quality_cols, row_valid[i])
        losses.append(torch.stack([ld, lq]).to(torch.float32))
    return state, torch.stack(losses)
