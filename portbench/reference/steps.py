"""The discriminator and generator updates, for the reference.

The mathematics of the port's `train/gan.py` steps (after the paper's
train_nele.py:122-156 and :342-426), on one device with every column
scored:

  * D step: the intelligibility head first, then the quality head, each
    ``mean_rows_valid(mean_cols((D(img) - target)^2))`` and its own Adam;
  * G step: ``MSE(D(enh, noise, clean), 1) + weight_qua * MSE(D_Qua(enh,
    clean), 1)`` with both discriminators in training mode (their power
    iterations advance) and no gradient to their weights, the enhanced
    bands ``clean * mask^p * beta2^p``;
  * images are the bands zeroed past each row's frame count, NCHW.
"""
from __future__ import annotations

import torch

from portbench.reference.pipeline import beta2_energy_norm, frame_mask


def masked_mse(score, target, rv):
    den = torch.clamp_min(rv.sum(), 1.0)
    return torch.sum(rv[:, None] * (score - target) ** 2) / (
        den * score.shape[-1])


def images(enh, noise, clean, frames):
    fmask = frame_mask(frames, enh.shape[1]).to(enh.dtype)

    def img(b):
        return (b * fmask[..., None]).transpose(1, 2)
    e, c = img(enh), img(clean)
    return torch.stack([e, img(noise), c], 1), torch.stack([e, c], 1)


def _step(opt, loss):
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return float(loss.detach())


def d_step(d, d_opt, dq, dq_opt, eband, noise_band, clean_band, frames,
           targets, targets_q, rv):
    """-> (intelligibility loss, quality loss)."""
    img3, img2 = images(eband, noise_band, clean_band, frames)
    d.train()
    ld = _step(d_opt, masked_mse(d(img3, frames), targets, rv))
    dq.train()
    lq = _step(dq_opt, masked_mse(dq(img2, frames), targets_q, rv))
    return ld, lq


def g_step(gen, gen_opt, d, dq, clean_band, noise_band, frames, rv,
           p_power: float, inv_p: float, weight_qua: float):
    """-> the generator's loss."""
    d.train()
    dq.train()
    fmask = frame_mask(frames, clean_band.shape[1]).to(clean_band.dtype)
    mask = gen(clean_band, noise_band)
    beta2 = beta2_energy_norm(clean_band, mask, fmask, inv_p=inv_p)
    enh = clean_band * mask ** p_power * beta2 ** p_power
    img3, img2 = images(enh, noise_band, clean_band, frames)
    frozen = [p for m in (d, dq) for p in m.parameters()]
    for p in frozen:
        p.requires_grad_(False)
    try:
        loss = (masked_mse(d(img3, frames), 1.0, rv)
                + weight_qua * masked_mse(dq(img2, frames), 1.0, rv))
    finally:
        for p in frozen:
            p.requires_grad_(True)
    return _step(gen_opt, loss)
