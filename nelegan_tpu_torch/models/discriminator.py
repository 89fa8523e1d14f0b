"""MetricGAN discriminators: spectral-norm conv trunks regressing metrics.

Counterpart of `nelegan_tpu/models/discriminator.py` and of the reference's
`Discriminator` / `Discriminator_Quality` (reference: model.py:101-166):
five spectral-norm Conv2d layers (kernels 1/3/5/7/9, VALID padding) with
LeakyReLU 0.3, a global average pool, and a spectral-norm MLP
64 -> 64 -> 16 -> n ending in a sigmoid.  The intelligibility head regresses
(SIIB, HASPI, ESTOI) from (enhanced, noise, clean) band images, the quality
head (PESQ, ViSQOL) from (enhanced, clean).

Layout is torch's NCHW, ``[B, C, 64 bands, T frames]`` (the reference
package's flax modules take NHWC ``[B, 64, T, C]``).  The module tree
(``layers.{0..4}``, ``fc1..fc3``) gives the reference's state-dict keys.

Variable-length batches: with ``frames`` given, the pool averages over each
utterance's valid output columns only, ``max(frames - shrink, 1)`` of them
(shrink = sum(k - 1) = 20), and over the trunk's full output height
(64 - 20 = 44): a conv output whose receptive field reaches a padded frame
never enters the mean.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from nelegan_tpu_torch.models.spectral_norm import SNConv2d, SNLinear


class _Discriminator(nn.Module):

    def __init__(self, in_ch: int, n_scores: int,
                 channels: Sequence[int] = (8, 16, 32, 48, 64),
                 kernels: Sequence[int] = (1, 3, 5, 7, 9),
                 leaky_slope: float = 0.3, compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r}: only the float32 policy "
                "is ported; the bfloat16 trunk is not yet")
        self.leaky_slope = leaky_slope
        self.shrink = sum(k - 1 for k in kernels)
        ins = [in_ch] + list(channels[:-1])
        self.layers = nn.ModuleList(SNConv2d(i, o, k)
                                    for i, o, k in zip(ins, channels, kernels))
        self.fc1 = SNLinear(channels[-1], 64)
        self.fc2 = SNLinear(64, 16)
        self.fc3 = SNLinear(16, n_scores)

    @classmethod
    def from_config(cls, model_cfg):
        return cls(channels=model_cfg.disc_channels,
                   kernels=model_cfg.disc_kernels,
                   leaky_slope=model_cfg.leaky_slope,
                   compute_dtype=model_cfg.compute_dtype,
                   n_scores=getattr(model_cfg, cls._scores_field))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Every layer's init (he-uniform, zero bias, u and v), drawn in
        layer order from `generator`."""
        for m in (*self.layers, self.fc1, self.fc2, self.fc3):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor,
                frames: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, C, 64, T] band images; frames [B] valid frame counts (None:
        every frame valid) -> scores [B, n_scores] in (0, 1)."""
        for layer in self.layers:
            x = F.leaky_relu(layer(x), self.leaky_slope)
        if frames is None:
            pooled = x.mean(dim=(2, 3))
        else:
            valid = torch.clamp_min(frames.to(x.device) - self.shrink, 1)
            cols = torch.arange(x.shape[-1], device=x.device)
            mask = (cols[None, :] < valid[:, None]).to(x.dtype)   # [B, T']
            denom = (x.shape[2] * valid).to(x.dtype)
            pooled = (torch.sum(x * mask[:, None, None, :], dim=(2, 3))
                      / denom[:, None])
        h = F.leaky_relu(self.fc1(pooled), self.leaky_slope)
        h = F.leaky_relu(self.fc2(h), self.leaky_slope)
        return torch.sigmoid(self.fc3(h))


class IntelDiscriminator(_Discriminator):
    """[B, 3, 64, T] (enhanced, noise, clean) band images -> [B, 3]
    predicted (SIIB, HASPI, ESTOI)."""

    _scores_field = "n_intel_scores"

    def __init__(self, n_scores: int = 3, **kw):
        super().__init__(3, n_scores, **kw)


class QualityDiscriminator(_Discriminator):
    """[B, 2, 64, T] (enhanced, clean) band images -> [B, 2] predicted
    (PESQ, ViSQOL)."""

    _scores_field = "n_quality_scores"

    def __init__(self, n_scores: int = 2, **kw):
        super().__init__(2, n_scores, **kw)
