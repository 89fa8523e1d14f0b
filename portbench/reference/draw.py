"""Seeded initial draws whose bits depend on the seed alone.

Every initial tensor of a seeded state is drawn on the CPU in float64 from
one `torch.Generator`, in a fixed order, and rounded once to float32 when
it is copied into its parameter or buffer.  Each step gives the same bits
at every ATen CPU capability (DEFAULT, AVX2, AVX512), thread count and
moment of the process:

  * `uniform_()` on [0, 1): 53 random bits times 2**-53, exact, drawn
    serially;
  * `normal_()` at its defaults (mean 0, std 1: no scaling to fuse),
    drawn serially on the calling thread;
  * a tensor times a scalar, a tensor plus a scalar, as separate
    operations, each rounded once, in whatever thread.  ATen's
    `uniform_(lo, hi)` computes ``u * (hi - lo) + lo`` in one expression,
    which its AVX2 and AVX512 builds round once (a fused multiply-add)
    and its DEFAULT build twice (torch 2.13);
  * the truncated normal's inverse CDF in Python floats on the calling
    thread (`statistics.NormalDist.inv_cdf`), not ATen's `erfinv_`: that
    kernel splits even a [64, 64] tensor over two threads, and as the
    first parallel region of a CLI process it returned one half of
    `gen.fc1.weight` up to 1e-5 off, in 3 of 166 runs beside other
    processes on the card's host (ROADMAP section 3);
  * sums in a fixed pairwise order of elementwise additions
    (`pairwise_sum`), where torch's reductions and BLAS split the work by
    thread and vector width.

A difference left in a float64 result's last bit changes the float32
weight only where it straddles a rounding boundary.
"""
from __future__ import annotations

from statistics import NormalDist

import torch

_EPS = 1e-12
_UNIT = NormalDist()


def uniform(shape, lo: float, hi: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """float64 U(lo, hi) of `shape` on the CPU."""
    u = torch.empty(shape, dtype=torch.float64).uniform_(generator=generator)
    return u.mul_(hi - lo).add_(lo)


def truncated_normal(shape, std: float,
                     generator: torch.Generator | None) -> torch.Tensor:
    """float64 N(0, std**2) truncated at +-2 std, by the inverse CDF (flax's
    and jax.random's algorithm): one uniform draw an element."""
    p = uniform(shape, _UNIT.cdf(-2.0), _UNIT.cdf(2.0), generator)
    x = torch.tensor([_UNIT.inv_cdf(v) for v in p.reshape(-1).tolist()],
                     dtype=torch.float64).reshape(shape)
    return x.mul_(std).clamp_(-2.0 * std, 2.0 * std)


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over dim 0 by a fixed tree of elementwise additions
    (neighbours first), the same on every CPU path and thread count."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros((1, *x.shape[1:]))])
        x = x[0::2] + x[1::2]
    return x[0]


def l2norm(v: torch.Tensor) -> torch.Tensor:
    """v / max(||v||, 1e-12) of a vector, the norm summed by
    `pairwise_sum`."""
    norm = torch.sqrt(pairwise_sum(v * v))
    return v / torch.clamp_min(norm, _EPS)
