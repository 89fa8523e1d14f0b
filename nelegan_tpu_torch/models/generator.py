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
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class CumulativeLayerNorm(nn.Module):
    """Causal (cumulative-over-time) layer norm on [B, C, T]
    (reference model.py:168-205).  Statistics are taken in at least float32
    with the reference package's formula
    ``var = (cum_pow - 2*mean*cum_sum)/cnt + mean^2``."""

    def __init__(self, features: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gain0 = nn.Parameter(torch.ones(1, features, 1))
        self.bias0 = nn.Parameter(torch.zeros(1, features, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sd = torch.promote_types(x.dtype, torch.float32)
        c, t = x.shape[1], x.shape[2]
        x32 = x.to(sd)
        cum_sum = torch.cumsum(x32.sum(dim=1), dim=-1)            # [B, T]
        cum_pow = torch.cumsum((x32 * x32).sum(dim=1), dim=-1)    # [B, T]
        cnt = (c * torch.arange(1, t + 1, device=x.device)).to(sd)
        mean = cum_sum / cnt
        var = (cum_pow - 2.0 * mean * cum_sum) / cnt + mean * mean
        inv_std = 1.0 / torch.sqrt(var + self.eps)
        y = (x32 - mean[:, None, :]) * inv_std[:, None, :]
        return (y * self.gain0 + self.bias0).to(x.dtype)


class CausalConv(nn.Module):
    """1-D causal conv on [B, C, T]: output frame t sees inputs t-k+1 .. t.
    The reference's ConvNorm(pad=k-1) + Chomp1d(k-1) (model.py:10-40) as
    one left-padded conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 w_gain: float = 1.0):
        super().__init__()
        self.kernel = kernel
        self.conv = nn.Conv1d(in_ch, out_ch, kernel)
        nn.init.xavier_uniform_(self.conv.weight, gain=w_gain)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (self.kernel - 1, 0)))


class Generator(nn.Module):
    """clean/noise band features [B, T, 64] -> per-band energy gain mask
    alpha^2 [B, T, 64] in [exp(-mask_bound), exp(mask_bound)]
    (reference: model.py:83-98)."""

    def __init__(self, hidden: int = 256, n_bands: int = 64,
                 n_blocks: int = 6, leaky_slope: float = 0.3,
                 mask_bound: float = 3.2, kernel_first: int = 5,
                 kernel_mid: int = 7, kernel_last: int = 5,
                 compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r}: only the float32 policy "
                "is ported; the bfloat16 trunk is not yet")
        self.leaky_slope = leaky_slope
        self.mask_bound = mask_bound
        ins = [2 * n_bands] + [hidden] * (n_blocks - 1)
        outs = [hidden] * (n_blocks - 1) + [n_bands]
        ks = [kernel_first] + [kernel_mid] * (n_blocks - 2) + [kernel_last]
        gains = [5.0 / 3.0] * (n_blocks - 1) + [1.0]
        self._gains = gains
        self.convolutions = nn.ModuleList(
            nn.Sequential(CausalConv(i, o, k, g), nn.Identity(),
                          CumulativeLayerNorm(o), nn.LeakyReLU(leaky_slope))
            for i, o, k, g in zip(ins, outs, ks, gains))
        self.fc1 = nn.Linear(n_bands, n_bands)
        self.fc2 = nn.Linear(n_bands, n_bands)

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
        """The reference package's init, drawn on the CPU from `generator`:
        xavier-uniform conv weights with the block's gain, lecun-normal
        (truncated at two deviations) dense weights, zero biases, unit cLN
        gains (`nelegan_tpu/models/generator.py:68-78`; flax's defaults)."""
        def draw(p, fill):
            cpu = torch.empty(p.shape, dtype=torch.float32, device="cpu")
            fill(cpu)
            p.copy_(cpu)

        for block, gain in zip(self.convolutions, self._gains):
            conv = block[0].conv
            draw(conv.weight, lambda w: nn.init.xavier_uniform_(
                w, gain=gain, generator=generator))
            conv.bias.zero_()
            block[2].gain0.fill_(1.0)
            block[2].bias0.zero_()
        for fc in (self.fc1, self.fc2):
            # flax's truncated normal keeps unit variance after truncation
            std = (1.0 / fc.in_features) ** 0.5 / 0.87962566103423978
            draw(fc.weight, lambda w: nn.init.trunc_normal_(
                w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator))
            fc.bias.zero_()

    def forward(self, clean: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        x = torch.cat([clean, noise], dim=-1).transpose(1, 2)     # [B, 128, T]
        for block in self.convolutions:
            x = block(x)
        x = x.transpose(1, 2)                                     # [B, T, 64]
        x = F.leaky_relu(self.fc1(x), self.leaky_slope)
        x = self.fc2(x)
        # exp(bound*tanh) in >= float32: the mask feeds beta^2 energy sums
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return torch.exp(self.mask_bound * torch.tanh(x))
