"""Spectral-norm layers with torch's power iteration and state-dict keys.

Counterpart of `nelegan_tpu/models/spectral_norm.py`.  The reference wraps
every discriminator layer in `torch.nn.utils.spectral_norm` (reference:
model.py:105-116, 139-150); these modules hold the same tensors under the
same names, so a reference state dict loads with ``strict=True``:

    weight_orig   the unnormalised weight (parameter)
    bias          (parameter)
    weight_u      the power iteration's left vector [out] (buffer)
    weight_v      its right vector [in * kh * kw] (buffer)

Semantics, as in torch and the reference package:

  * the weight is flattened to ``[out, -1]`` in (in, kh, kw) order;
  * a forward in training mode runs one power-iteration step and stores
    the new (u, v) (l2 normalisation with eps 1e-12); an eval forward reuses
    the stored pair;
  * the layer computes with ``weight / sigma``, ``sigma = u . (W v)``, the
    gradient passing through W only (u and v are constants).

Unlike `torch.nn.utils.spectral_norm` the initial v is ``l2norm(W^T u)``,
one half step from u, as the reference package initialises it; weights are
he-uniform and biases zero (`nelegan_tpu/models/spectral_norm.py:75-77`).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

_EPS = 1e-12


def _l2norm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v), _EPS)


class _SpectralNorm(nn.Module):
    """Parameters, buffers and power iteration shared by both layers."""

    def __init__(self, weight_shape: tuple):
        super().__init__()
        out_dim = weight_shape[0]
        in_dim = math.prod(weight_shape[1:])
        self.weight_orig = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.register_buffer("weight_u", torch.empty(out_dim))
        self.register_buffer("weight_v", torch.empty(in_dim))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """he-uniform weight, zero bias, u a normal draw normalised, and
        v = l2norm(W^T u).  Draws come from `generator` (the global one when
        None) on the CPU, so a seed gives the same layer on every device."""
        w = self.weight_orig
        fan_in = math.prod(w.shape[1:])
        limit = math.sqrt(6.0 / fan_in)
        cpu = torch.empty(w.shape, dtype=torch.float32, device="cpu")
        cpu.uniform_(-limit, limit, generator=generator)
        w.copy_(cpu)
        self.bias.zero_()
        u = torch.empty(w.shape[0], dtype=torch.float32, device="cpu")
        u.normal_(generator=generator)
        self.weight_u.copy_(_l2norm(u))
        self.weight_v.copy_(_l2norm(self._wmat().t() @ self.weight_u))

    def _wmat(self) -> torch.Tensor:
        return self.weight_orig.reshape(self.weight_orig.shape[0], -1)

    def normalized_weight(self) -> torch.Tensor:
        """weight_orig / sigma; in training mode after one power-iteration
        step that updates the stored (u, v)."""
        wmat = self._wmat()
        if self.training:
            with torch.no_grad():
                v = _l2norm(wmat.t() @ self.weight_u)
                u = _l2norm(wmat @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        else:
            u, v = self.weight_u, self.weight_v
        sigma = torch.dot(u, wmat @ v)
        return self.weight_orig / sigma


class SNConv2d(_SpectralNorm):
    """Conv2d on NCHW input, VALID padding, spectral-normalised weight
    [out, in, k, k]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__((out_ch, in_ch, kernel, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.normalized_weight(), self.bias)


class SNLinear(_SpectralNorm):
    """Linear layer (weight [out, in]) with a spectral-normalised weight."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__((out_dim, in_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.normalized_weight(), self.bias)
