"""The generator and the two spectral-norm discriminators, for the reference.

Frozen copies of the port's `models/generator.py`, `models/discriminator.py`
and `models/spectral_norm.py` without their tensor-parallel paths: the same
layers, parameter names, initial draw (`reference/draw.py`, float64 on the
host from one `torch.Generator`, in the same order) and mixed-precision
casts.  `cast` is the one place an activation or weight enters the
policy's dtype, so the lower-precision control can round there too
(`set_cast`).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import draw
from portbench.reference.config import ModelConfig, policy_dtype

_EPS = 1e-12


def _default_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype)


_cast: Callable[[torch.Tensor, torch.dtype], torch.Tensor] = _default_cast


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` in the policy's dtype `dtype`."""
    return _cast(x, dtype)


def set_cast(fn: Optional[Callable[[torch.Tensor, torch.dtype],
                                   torch.Tensor]]) -> None:
    """Route every policy cast through `fn` (None: a plain `.to`)."""
    global _cast
    _cast = fn or _default_cast


def _l2norm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v), _EPS)


class _SpectralNorm(nn.Module):

    def __init__(self, weight_shape: tuple,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight_orig = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.empty(weight_shape[0]))
        self.register_buffer("weight_u", torch.empty(weight_shape[0]))
        self.register_buffer("weight_v",
                             torch.empty(math.prod(weight_shape[1:])))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        w = self.weight_orig
        limit = math.sqrt(6.0 / math.prod(w.shape[1:]))
        w64 = draw.uniform(w.shape, -limit, limit, generator)
        u64 = draw.l2norm(torch.empty(w.shape[0], dtype=torch.float64)
                          .normal_(generator=generator))
        v64 = draw.l2norm(draw.pairwise_sum(
            w64.reshape(w.shape[0], -1) * u64[:, None]))
        w.copy_(w64)
        self.bias.zero_()
        self.weight_u.copy_(u64)
        self.weight_v.copy_(v64)

    def normalized_weight(self) -> torch.Tensor:
        wmat = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        if self.training:
            with torch.no_grad():
                v = _l2norm(wmat.t() @ self.weight_u)
            wv = wmat @ v
            with torch.no_grad():
                u = _l2norm(wv.detach())
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        else:
            u, v = self.weight_u, self.weight_v
            wv = wmat @ v
        return self.weight_orig / torch.dot(u, wv)

    def _forward_with(self, op, x: torch.Tensor) -> torch.Tensor:
        w = self.normalized_weight()
        cd = self.compute_dtype
        if cd is None:
            return op(x, w, self.bias)
        y = op(cast(x, cd), cast(w, cd))
        return y + self.bias.to(cd).reshape(-1, *[1] * (y.dim() - 2))


class SNConv2d(_SpectralNorm):
    def __init__(self, in_ch, out_ch, kernel, compute_dtype=None):
        super().__init__((out_ch, in_ch, kernel, kernel), compute_dtype)

    def forward(self, x):
        return self._forward_with(F.conv2d, x)


class SNLinear(_SpectralNorm):
    def __init__(self, in_dim, out_dim, compute_dtype=None):
        super().__init__((out_dim, in_dim), compute_dtype)

    def forward(self, x):
        return self._forward_with(F.linear, x)


class _Discriminator(nn.Module):

    def __init__(self, in_ch: int, n_scores: int,
                 channels: Sequence[int], kernels: Sequence[int],
                 leaky_slope: float, compute_dtype: str):
        super().__init__()
        cd = policy_dtype(compute_dtype)
        self.leaky_slope = leaky_slope
        self.shrink = sum(k - 1 for k in kernels)
        ins = [in_ch] + list(channels[:-1])
        self.layers = nn.ModuleList(SNConv2d(i, o, k, cd)
                                    for i, o, k in zip(ins, channels, kernels))
        self.fc1 = SNLinear(channels[-1], 64)
        self.fc2 = SNLinear(64, 16)
        self.fc3 = SNLinear(16, n_scores)

    def reset_parameters(self, generator: torch.Generator):
        for m in (*self.layers, self.fc1, self.fc2, self.fc3):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = F.leaky_relu(layer(x), self.leaky_slope)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        valid = torch.clamp_min(frames.to(x.device) - self.shrink, 1)
        cols = torch.arange(x.shape[-1], device=x.device)
        mask = (cols[None, :] < valid[:, None]).to(x.dtype)
        denom = (x.shape[2] * valid).to(x.dtype)
        h = torch.sum(x * mask[:, None, None, :], dim=(2, 3)) / denom[:, None]
        for fc in (self.fc1, self.fc2):
            h = F.leaky_relu(fc(h), self.leaky_slope)
        return torch.sigmoid(self.fc3(h))


def discriminators(m: ModelConfig):
    """(intelligibility D [B,3,64,T] -> [B,3], quality D [B,2,64,T] ->
    [B,2])."""
    kw = dict(channels=m.disc_channels, kernels=m.disc_kernels,
              leaky_slope=m.leaky_slope, compute_dtype=m.compute_dtype)
    return (_Discriminator(3, m.n_intel_scores, **kw),
            _Discriminator(2, m.n_quality_scores, **kw))


class CumulativeLayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gain0 = nn.Parameter(torch.ones(1, features, 1))
        self.bias0 = nn.Parameter(torch.zeros(1, features, 1))

    def forward(self, x):
        sd = torch.promote_types(x.dtype, torch.float32)
        c, t = x.shape[1], x.shape[2]
        x32 = x.to(sd)
        cum_sum = torch.cumsum(x32.sum(dim=1), dim=-1)
        cum_pow = torch.cumsum((x32 * x32).sum(dim=1), dim=-1)
        cnt = (c * torch.arange(1, t + 1, device=x.device)).to(sd)
        mean = cum_sum / cnt
        var = (cum_pow - 2.0 * mean * cum_sum) / cnt + mean * mean
        inv_std = 1.0 / torch.sqrt(var + self.eps)
        y = (x32 - mean[:, None, :]) * inv_std[:, None, :]
        return (y * self.gain0 + self.bias0).to(x.dtype)


class CausalConv(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, compute_dtype=None):
        super().__init__()
        self.kernel = kernel
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv1d(in_ch, out_ch, kernel)

    def forward(self, x):
        x = F.pad(x, (self.kernel - 1, 0))
        cd = self.compute_dtype
        if cd is None:
            return self.conv(x)
        y = F.conv1d(cast(x, cd), cast(self.conv.weight, cd))
        return y + self.conv.bias.to(cd)[:, None]


def _dense(fc: nn.Linear, x, cd):
    if cd is None:
        return fc(x)
    return F.linear(cast(x, cd), cast(fc.weight, cd)) + fc.bias.to(cd)


class Generator(nn.Module):
    """clean/noise bands [B, T, 64] -> gain mask [B, T, 64]."""

    def __init__(self, m: ModelConfig):
        super().__init__()
        self.compute_dtype = policy_dtype(m.compute_dtype)
        self.leaky_slope = m.leaky_slope
        self.mask_bound = m.mask_bound
        nb, hid, n = m.n_bands, m.gen_hidden, m.gen_blocks
        ins = [2 * nb] + [hid] * (n - 1)
        outs = [hid] * (n - 1) + [nb]
        ks = ([m.gen_kernel_first] + [m.gen_kernel_mid] * (n - 2)
              + [m.gen_kernel_last])
        self._gains = [5.0 / 3.0] * (n - 1) + [1.0]
        self.convolutions = nn.ModuleList(
            nn.Sequential(CausalConv(i, o, k, self.compute_dtype),
                          nn.Identity(), CumulativeLayerNorm(o),
                          nn.LeakyReLU(m.leaky_slope))
            for i, o, k in zip(ins, outs, ks))
        self.fc1 = nn.Linear(nb, nb)
        self.fc2 = nn.Linear(nb, nb)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for block, gain in zip(self.convolutions, self._gains):
            w = block[0].conv.weight
            out_ch, in_ch, k = w.shape
            bound = gain * math.sqrt(6.0 / ((in_ch + out_ch) * k))
            w.copy_(draw.uniform(w.shape, -bound, bound, generator))
            block[0].conv.bias.zero_()
            block[2].gain0.fill_(1.0)
            block[2].bias0.zero_()
        for fc in (self.fc1, self.fc2):
            std = (1.0 / fc.in_features) ** 0.5 / 0.87962566103423978
            fc.weight.copy_(draw.truncated_normal(fc.weight.shape, std,
                                                  generator))
            fc.bias.zero_()

    def forward(self, clean, noise):
        cd = self.compute_dtype
        x = torch.cat([clean, noise], dim=-1).transpose(1, 2)
        if cd is not None:
            x = cast(x, cd)
        for block in self.convolutions:
            x = block(x)
        x = x.transpose(1, 2)
        x = F.leaky_relu(_dense(self.fc1, x, cd), self.leaky_slope)
        x = _dense(self.fc2, x, cd)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return torch.exp(self.mask_bound * torch.tanh(x))


def draw_models(m: ModelConfig, seed: int, device, dtype=torch.float32):
    """(G, D, D_Qua) drawn from `seed` in the port's order, on `device`."""
    rng = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        gen = Generator(m)
        d, dq = discriminators(m)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for mod in (gen, d, dq):
            mod.reset_parameters(rng)
    finally:
        torch.set_num_threads(threads)
    return tuple(mod.to(device=device, dtype=dtype) for mod in (gen, d, dq))
