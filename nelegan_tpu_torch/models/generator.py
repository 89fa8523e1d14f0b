"""Spectral-gain generator: causal Conv1d stack with cumulative LayerNorm.

Counterpart of `nelegan_tpu/models/generator.py` and of the reference's
`Generator_Conv1D_cLN` (reference: model.py:43-98).  The module tree
reproduces the reference's state-dict keys, so a reference `chkpt_GD.pt`
loads with `load_state_dict(strict=True)`:

    convolutions.{i}.0.conv.weight / .bias   ConvNorm's Conv1d [out, in, k]
    convolutions.{i}.1                       Chomp1d (no parameters)
    convolutions.{i}.2.gain0 / .bias0        cLN [1, C, 1]
    convolutions.{i}.3                       LeakyReLU
    fc1.weight / .bias, fc2.weight / .bias   Linear [out, in]

Inside, the trunk runs channels-first [B, C, T]; the public forward keeps
the band layout [B, T, 64].

Under a reduced mixed-precision policy (``compute_dtype="bfloat16"``) the
concatenated input, every causal conv and ``fc1``/``fc2`` compute in that
dtype (input, weight and bias cast, as flax's ``dtype=`` casts them); the
parameters, the cLN statistics and the output mask stay float32.  The
casts are explicit, not ``torch.autocast``, so they sit where the reference
package puts them on every device.

Sharded over a mesh's model axis (`parallel.mesh.shard_params`), each
causal conv, its cLN and ``fc1``/``fc2`` hold their output channels'
part and compute it from the whole input (`parallel.tensor.to_model`);
the cLN sums its channel sums over the model group, and the forward
gathers each block's and each dense layer's channels.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from nelegan_tpu_torch.config import policy_dtype
from nelegan_tpu_torch.models import draw
from nelegan_tpu_torch.parallel.tensor import (gather_from_model,
                                               reduce_in_model, to_model)


class CumulativeLayerNorm(nn.Module):
    """Causal (cumulative-over-time) layer norm on [B, C, T]
    (reference model.py:168-205).  Statistics are taken in at least float32
    with the reference package's formula
    ``var = (cum_pow - 2*mean*cum_sum)/cnt + mean^2``.  Sharded, the
    channel sums are summed over the model group."""

    MODEL_AXIS = {"gain0": 1, "bias0": 1}
    tp = None

    def __init__(self, features: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gain0 = nn.Parameter(torch.ones(1, features, 1))
        self.bias0 = nn.Parameter(torch.zeros(1, features, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sd = torch.promote_types(x.dtype, torch.float32)
        c, t = x.shape[1], x.shape[2]
        x32 = x.to(sd)
        s, p = x32.sum(dim=1), (x32 * x32).sum(dim=1)             # [B, T]
        if self.tp is not None:
            s, p = to_model(reduce_in_model(torch.stack([s, p]), self.tp),
                            self.tp)
            c *= self.tp.model_parallel
        cum_sum = torch.cumsum(s, dim=-1)
        cum_pow = torch.cumsum(p, dim=-1)
        cnt = (c * torch.arange(1, t + 1, device=x.device)).to(sd)
        mean = cum_sum / cnt
        var = (cum_pow - 2.0 * mean * cum_sum) / cnt + mean * mean
        inv_std = 1.0 / torch.sqrt(var + self.eps)
        y = (x32 - mean[:, None, :]) * inv_std[:, None, :]
        return (y * self.gain0 + self.bias0).to(x.dtype)


class CausalConv(nn.Module):
    """1-D causal conv on [B, C, T]: output frame t sees inputs t-k+1 .. t.
    The reference's ConvNorm(pad=k-1) + Chomp1d(k-1) (model.py:10-40) as
    one left-padded conv.  `compute_dtype` (None: no cast) is the dtype
    the input, weight and bias are cast to; the bias is added after the
    conv, in that dtype, as flax's `nn.Conv(dtype=...)` adds it."""

    MODEL_AXIS = {"conv.weight": 0, "conv.bias": 0}
    tp = None

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 w_gain: float = 1.0,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.kernel = kernel
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv1d(in_ch, out_ch, kernel)
        nn.init.xavier_uniform_(self.conv.weight, gain=w_gain)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(to_model(x, self.tp), (self.kernel - 1, 0))
        cd = self.compute_dtype
        if cd is None:
            return self.conv(x)
        y = F.conv1d(x.to(cd), self.conv.weight.to(cd))
        return y + self.conv.bias.to(cd)[:, None]


class _Dense(nn.Linear):
    """`nn.Linear` that `shard_params` can shard on its output features."""

    MODEL_AXIS = {"weight": 0, "bias": 0}
    tp = None


def _dense(fc: _Dense, x: torch.Tensor,
           cd: torch.dtype | None) -> torch.Tensor:
    """`fc(x)`, computed in `cd` (None: no cast) with the bias added after
    the product, as flax's `nn.Dense(dtype=...)` computes it."""
    x = to_model(x, fc.tp)
    if cd is None:
        return fc(x)
    return F.linear(x.to(cd), fc.weight.to(cd)) + fc.bias.to(cd)


class Generator(nn.Module):
    """clean/noise band features [B, T, 64] -> per-band energy gain mask
    alpha^2 [B, T, 64] in [exp(-mask_bound), exp(mask_bound)]
    (reference: model.py:83-98).  `compute_dtype` is the mixed-precision
    policy (`config.policy_dtype`); the mask is float32 (or float64) under
    every policy."""

    def __init__(self, hidden: int = 256, n_bands: int = 64,
                 n_blocks: int = 6, leaky_slope: float = 0.3,
                 mask_bound: float = 3.2, kernel_first: int = 5,
                 kernel_mid: int = 7, kernel_last: int = 5,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.compute_dtype = policy_dtype(compute_dtype)
        self.leaky_slope = leaky_slope
        self.mask_bound = mask_bound
        ins = [2 * n_bands] + [hidden] * (n_blocks - 1)
        outs = [hidden] * (n_blocks - 1) + [n_bands]
        ks = [kernel_first] + [kernel_mid] * (n_blocks - 2) + [kernel_last]
        gains = [5.0 / 3.0] * (n_blocks - 1) + [1.0]
        self._gains = gains
        self.convolutions = nn.ModuleList(
            nn.Sequential(CausalConv(i, o, k, g, self.compute_dtype),
                          nn.Identity(),
                          CumulativeLayerNorm(o), nn.LeakyReLU(leaky_slope))
            for i, o, k, g in zip(ins, outs, ks, gains))
        self.fc1 = _Dense(n_bands, n_bands)
        self.fc2 = _Dense(n_bands, n_bands)

    @classmethod
    def from_config(cls, model_cfg) -> "Generator":
        return cls(hidden=model_cfg.gen_hidden, n_bands=model_cfg.n_bands,
                   n_blocks=model_cfg.gen_blocks,
                   leaky_slope=model_cfg.leaky_slope,
                   mask_bound=model_cfg.mask_bound,
                   kernel_first=model_cfg.gen_kernel_first,
                   kernel_mid=model_cfg.gen_kernel_mid,
                   kernel_last=model_cfg.gen_kernel_last,
                   compute_dtype=model_cfg.compute_dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """The reference package's init, drawn on the CPU in float64 from
        `generator` and rounded once to the parameters' dtype
        (`models/draw.py`):
        xavier-uniform conv weights with the block's gain, lecun-normal
        (truncated at two deviations) dense weights, zero biases, unit cLN
        gains (`nelegan_tpu/models/generator.py:68-78`; flax's defaults)."""
        for block, gain in zip(self.convolutions, self._gains):
            w = block[0].conv.weight
            out_ch, in_ch, k = w.shape
            bound = gain * math.sqrt(6.0 / ((in_ch + out_ch) * k))
            w.copy_(draw.uniform(w.shape, -bound, bound, generator))
            block[0].conv.bias.zero_()
            block[2].gain0.fill_(1.0)
            block[2].bias0.zero_()
        for fc in (self.fc1, self.fc2):
            # flax's truncated normal keeps unit variance after truncation
            std = (1.0 / fc.in_features) ** 0.5 / 0.87962566103423978
            fc.weight.copy_(draw.truncated_normal(fc.weight.shape, std,
                                                  generator))
            fc.bias.zero_()

    def forward(self, clean: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = torch.cat([clean, noise], dim=-1).transpose(1, 2)     # [B, 128, T]
        if cd is not None:
            x = x.to(cd)
        for block in self.convolutions:
            x = gather_from_model(block(x), block[0].tp, 1)
        x = x.transpose(1, 2)                                     # [B, T, 64]
        x = gather_from_model(F.leaky_relu(_dense(self.fc1, x, cd),
                                           self.leaky_slope), self.fc1.tp, -1)
        x = gather_from_model(_dense(self.fc2, x, cd), self.fc2.tp, -1)
        # exp(bound*tanh) in >= float32: the mask feeds beta^2 energy sums
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return torch.exp(self.mask_bound * torch.tanh(x))
