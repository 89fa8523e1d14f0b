"""Direct differentiable-metric optimisation of the generator.

Counterpart of `nelegan_tpu/train/direct.py`.  The reference can only
optimise metrics through the MetricGAN surrogate, as its true scores come
from CPU processes and binaries.  Here the metrics are torch functions end
to end, so the generator takes gradients through the metric itself:
enhancement -> resynthesis -> ESTOI (and HASPI v2, PESQ).

`direct_g_step` maximises the batch's differentiable ESTOI of (clean,
enhanced + noise), optionally plus HASPI v2 of the same pair and PESQ of
(clean, enhanced).  On a CUDA device PESQ's gain memory is one `linrec`
launch forward and one `linrec_bwd` launch backward a step.
"""
from __future__ import annotations

import torch

from nelegan_tpu_torch.config import Config
from nelegan_tpu_torch.dsp.erb import interp_band_gain
from nelegan_tpu_torch.dsp.resample import resample_poly
from nelegan_tpu_torch.metrics.estoi import estoi_10k
from nelegan_tpu_torch.metrics.haspi import haspi_v2_24k, resample_to_24k
from nelegan_tpu_torch.metrics.pesq import pesq_p862_16k
from nelegan_tpu_torch.models.generator import Generator
from nelegan_tpu_torch.pipeline import (HOP, BatchFeatures, beta2_energy_norm,
                                        frame_mask,
                                        istft_batch_tail_truncated)


def _enhance_wavs(gen: Generator, feats: BatchFeatures, cfg: Config):
    """Differentiable band-domain enhancement -> (waveforms [B, n], output
    lengths [B]).  Each row is scaled to `cfg.train.target_rms` over its
    `HOP * (frames - 1)` output samples."""
    t = feats.clean_band.shape[1]
    fmask = frame_mask(feats.frames, t).to(feats.clean_band.dtype)
    mask = gen(feats.clean_band, feats.noise_band)
    beta2 = beta2_energy_norm(feats.clean_band, mask, fmask,
                              inv_p=cfg.train.inv_p)
    gain = torch.sqrt(interp_band_gain(mask * beta2))
    spec = (torch.polar(feats.clean_mag, feats.clean_phase)
            * gain.transpose(-1, -2))
    wav = istft_batch_tail_truncated(spec, feats.frames)
    out_len = HOP * (feats.frames - 1)
    rms = torch.sqrt(torch.sum(wav * wav, dim=-1)
                     / torch.clamp_min(out_len, 1).to(wav.dtype))
    return wav / rms[:, None] * cfg.train.target_rms, out_len


def direct_metric_loss(gen: Generator, feats: BatchFeatures,
                       clean_wavs: torch.Tensor, noise_wavs: torch.Tensor,
                       cfg: Config = Config(), haspi_weight: float = 0.0,
                       pesq_weight: float = 0.0) -> torch.Tensor:
    """-mean differentiable metric of (clean, enhanced + noise): a scalar.

    `feats` on the generator's device; `clean_wavs`/`noise_wavs` the
    unpadded-layout [B, n] buffers (zero tails) aligned with them, tensors
    or arrays.  `haspi_weight` adds HASPI v2 of the same pair;
    `pesq_weight` adds the differentiable P.862 quality of (clean,
    enhanced), scaled from [-0.5, 4.5] to the unit range: the quality
    metrics hear the enhanced signal without noise (reference intel.py
    wrapper semantics)."""
    enh, out_len = _enhance_wavs(gen, feats, cfg)
    clean_wavs = torch.as_tensor(clean_wavs, device=enh.device)
    noise_wavs = torch.as_tensor(noise_wavs, device=enh.device)
    n = min(enh.shape[-1], clean_wavs.shape[-1])
    noisy = enh[:, :n] + noise_wavs[:, :n]
    ref = clean_wavs[:, :n]

    nv10 = -(-out_len * 5 // 8)
    est = estoi_10k(resample_poly(ref, 5, 8), resample_poly(noisy, 5, 8),
                    nv10)
    loss = -torch.mean(est)

    if haspi_weight > 0.0:
        nv24 = -(-out_len * 3 // 2)
        hasp = haspi_v2_24k(resample_to_24k(ref, 16000),
                            resample_to_24k(noisy, 16000), n_valid=nv24)[0]
        loss = loss - haspi_weight * torch.mean(hasp)

    if pesq_weight > 0.0:
        pq = pesq_p862_16k(ref, enh[:, :n], out_len)
        loss = loss - pesq_weight * torch.mean((pq - 1.0) / 3.5)
    return loss


def direct_g_step(gen: Generator, opt: torch.optim.Optimizer,
                  feats: BatchFeatures, clean_wavs, noise_wavs,
                  cfg: Config = Config(), haspi_weight: float = 0.0,
                  pesq_weight: float = 0.0) -> torch.Tensor:
    """One direct-metric gradient step on `gen`, in place.  `opt` is the
    generator's optimiser, `torch.optim.Adam(gen.parameters(), lr)` as the
    reference package's `optax.adam(lr)` (an optax state loads into it
    through `models.convert`).  Returns the loss before the step, a
    device scalar."""
    opt.zero_grad(set_to_none=True)
    loss = direct_metric_loss(gen, feats, clean_wavs, noise_wavs, cfg,
                              haspi_weight, pesq_weight)
    loss.backward()
    opt.step()
    return loss.detach()
