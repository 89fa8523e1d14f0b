"""Column-parallel layers over the mesh's model axis.

The reference package shards every parameter's output axis over "model"
(`nelegan_tpu/parallel/mesh.py:56-63`) and leaves the collectives to XLA.
Here a layer that `shard_params` sharded computes its own output
channels and the model group exchanges tensors through three
`torch.autograd.Function`s, each a no-op without a mesh:

  * `to_model`: the identity forward; backward, the gradient summed over
    the model group.  A whole (replicated) tensor that a sharded
    computation consumes passes through it: each rank's gradient holds
    only its channels' part;
  * `gather_from_model`: the ranks' channels concatenated forward;
    backward, this rank's slice of the gradient, which every rank holds
    whole (what follows a gather runs the same on every rank);
  * `reduce_in_model`: a sum over the model group forward, the identity
    backward (its output is whole on every rank).

So a column-parallel layer takes its whole input through `to_model`,
computes its channels, and its model gathers them.  Each collective is
counted on the mesh, `tp:gather` and `tp:reduce` (a sum in either
direction).  Under gloo, CUDA tensors are staged through the host.
"""
from __future__ import annotations

import torch


class _ToModel(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.model_all_reduce(grad), None


class _GatherFromModel(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.cut = (dim, mesh.model_rank * x.shape[dim], x.shape[dim])
        return mesh.model_all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(*ctx.cut).contiguous(), None, None


class _ReduceInModel(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x`, whose gradient is summed over `mesh`'s model group."""
    return x if mesh is None else _ToModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The model group's `x` concatenated on `dim`, in model order."""
    return x if mesh is None else _GatherFromModel.apply(x, mesh, dim)


def reduce_in_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` summed over `mesh`'s model group."""
    return x if mesh is None else _ReduceInModel.apply(x, mesh)
