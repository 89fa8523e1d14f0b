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

Under a reduced mixed-precision policy (`compute_dtype`, e.g.
torch.bfloat16) the weight, bias, u, v and sigma stay in the parameters'
dtype (sigma divides the whole kernel, and (u, v) drift would compound
across steps); only after ``weight / sigma`` are the input, the normalised
weight and the bias cast to it, the bias added after the product
(`nelegan_tpu/models/spectral_norm.py:55-109`).

Sharded over a mesh's model axis (`parallel.mesh.shard_params`), a layer
holds rows of ``weight_orig`` and of ``bias``, its output channels, while
u and v stay whole on every rank.  The power iteration runs on the rows:
v = l2norm(sum_i W_i^T u_i), one all-reduce over the model group;
u = l2norm(gather(W_i v)), and sigma = u . gather(W_i v), the whole
matrix's.  sigma enters each rank's rows through `parallel.tensor.to_model`,
so its gradient sums every rank's; the layer's input enters the same way.
The layer returns its own channels; the model gathers them.

Unlike `torch.nn.utils.spectral_norm` the initial v is ``l2norm(W^T u)``,
one half step from u, as the reference package initialises it; weights are
he-uniform and biases zero (`nelegan_tpu/models/spectral_norm.py:75-77`).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from nelegan_tpu_torch.models import draw
from nelegan_tpu_torch.parallel.tensor import gather_from_model, to_model

_EPS = 1e-12


def _l2norm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v), _EPS)


class _SpectralNorm(nn.Module):
    """Parameters, buffers and power iteration shared by both layers."""

    MODEL_AXIS = {"weight_orig": 0, "bias": 0}   # output rows
    tp = None                                    # the mesh, once sharded

    def __init__(self, weight_shape: tuple,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
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
        v = l2norm(W^T u): drawn and computed on the CPU in float64 from
        `generator` (the global one when None), each rounded once to the
        parameters' dtype (`models/draw.py`), so a seed gives the same
        layer on every device and CPU."""
        w = self.weight_orig
        fan_in = math.prod(w.shape[1:])
        limit = math.sqrt(6.0 / fan_in)
        w64 = draw.uniform(w.shape, -limit, limit, generator)
        u64 = draw.l2norm(torch.empty(w.shape[0], dtype=torch.float64)
                          .normal_(generator=generator))
        # W^T u as products summed in a fixed order, not a BLAS GEMV
        v64 = draw.l2norm(draw.pairwise_sum(
            w64.reshape(w.shape[0], -1) * u64[:, None]))
        w.copy_(w64)
        self.bias.zero_()
        self.weight_u.copy_(u64)
        self.weight_v.copy_(v64)

    def _wmat(self) -> torch.Tensor:
        return self.weight_orig.reshape(self.weight_orig.shape[0], -1)

    def normalized_weight(self) -> torch.Tensor:
        """weight_orig / sigma (this rank's rows of it, sharded); in
        training mode after one power-iteration step that updates the
        stored (u, v)."""
        wmat, tp = self._wmat(), self.tp
        if self.training:
            with torch.no_grad():
                u = self.weight_u
                if tp is None:
                    v = _l2norm(wmat.t() @ u)
                else:
                    u = u[tp.model_slice(u.numel())]
                    v = _l2norm(tp.model_all_reduce(wmat.t() @ u))
            wv = gather_from_model(wmat @ v, tp, 0)
            with torch.no_grad():
                u = _l2norm(wv.detach())
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        else:
            u, v = self.weight_u, self.weight_v
            wv = gather_from_model(wmat @ v, tp, 0)
        sigma = to_model(torch.dot(u, wv), tp)
        return self.weight_orig / sigma

    def _forward_with(self, op, x: torch.Tensor) -> torch.Tensor:
        """`op(x, w_sn, bias)`; under a reduced policy `op(x, w_sn)` in that
        dtype, then the bias in it.  Sharded, this rank's channels."""
        w = self.normalized_weight()
        x = to_model(x, self.tp)
        cd = self.compute_dtype
        if cd is None:
            return op(x, w, self.bias)
        y = op(x.to(cd), w.to(cd))
        return y + self.bias.to(cd).reshape(-1, *[1] * (y.dim() - 2))


class SNConv2d(_SpectralNorm):
    """Conv2d on NCHW input, VALID padding, spectral-normalised weight
    [out, in, k, k], computed in `compute_dtype` (None: no cast)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__((out_ch, in_ch, kernel, kernel), compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward_with(F.conv2d, x)


class SNLinear(_SpectralNorm):
    """Linear layer (weight [out, in]) with a spectral-normalised weight,
    computed in `compute_dtype` (None: no cast)."""

    def __init__(self, in_dim: int, out_dim: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__((out_dim, in_dim), compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward_with(F.linear, x)
