"""The FLOP and byte reckonings against counts made another way at small
shapes: torch's own FLOP counter over the reference's models, and the
IMCRA kernel's bytes by hand."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops
from portbench.reference import models
from portbench.reference.config import ModelConfig

SMALL = ModelConfig(n_bands=16, gen_hidden=24, gen_blocks=3,
                    gen_kernel_first=3, gen_kernel_mid=5, gen_kernel_last=3,
                    disc_channels=(4, 6, 8, 10, 12),
                    disc_kernels=(1, 3, 3, 5, 3))


def counted(fn):
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("frames", [9, 40])
def test_generator_forward_flops(frames):
    gen, _, _ = models.draw_models(SMALL, 1, "cpu")
    x = torch.rand(3, frames, SMALL.n_bands)
    got = counted(lambda: gen(x, x))
    want = 3 * flops.generator_forward_flops(dataclasses.asdict(SMALL),
                                             frames)
    assert got == want


@pytest.mark.parametrize("frames", [20, 57])
def test_discriminator_forward_flops(frames):
    _, d, dq = models.draw_models(SMALL, 1, "cpu")
    fr = torch.full((2,), frames)
    got = counted(lambda: (d(torch.rand(2, 3, 16, frames), fr),
                           dq(torch.rand(2, 2, 16, frames), fr)))
    want = 2 * flops.d_pair_forward_flops(dataclasses.asdict(SMALL), frames)
    assert got == want


def test_imcra_bytes_and_roofline_by_hand():
    assert flops.imcra_bytes(64, 193) == 2 * 4 * 64 * 193 * 257
    nbytes, ops = flops.imcra_bytes(2, 10), flops.imcra_ops(2, 10)
    assert flops.roofline_seconds(ops, nbytes) == max(nbytes / 3.35e12,
                                                      ops / 67e12)


def test_step_flops_compose_the_forwards():
    m = dataclasses.asdict(SMALL)
    g, d = flops.generator_forward_flops(m, 30), flops.d_pair_forward_flops(
        m, 30)
    assert flops.g_step_flops(m, 4, 30) == 4 * (3 * g + 2 * d)
    assert flops.d_step_flops(m, 4, 30) == 4 * 3 * d
