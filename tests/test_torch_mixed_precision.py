"""The port's mixed-precision policy (ModelConfig.compute_dtype="bfloat16")
against the reference package's, from the same parameters carried across
with models/convert.py; the port of tests/test_mixed_precision.py.

The policy computes the generator's and the discriminators' trunks in
bfloat16 while parameters, cLN statistics, spectral-norm power iteration,
pool reductions and outputs stay float32, so the parameter tree (and so the
checkpoint format) is the same under both policies.

Bars: the bfloat16 mask against the port's float32 within the reference
package's own bars (mean relative difference under 0.03, max under 0.25);
against the reference package's bfloat16 mask, a mean relative difference
below the reference package's own bfloat16-vs-float32 mean on the same
input (XLA on the CPU keeps more precision between some bfloat16 operations
than torch does, so the two bfloat16 masks differ by bfloat16 rounding,
though less than either differs from float32); discriminator scores within
0.02.  One bfloat16 G step and one D step at the reference package's small
config: losses within LOSS_BAR of the reference package's bfloat16 steps.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nelegan_tpu.config import Config as JaxConfig
from nelegan_tpu.config import ModelConfig as JaxModelConfig
from nelegan_tpu.models.discriminator import IntelDiscriminator as JaxIntel
from nelegan_tpu.models.generator import Generator as JaxGenerator
from nelegan_tpu.train import gan as jgan
from nelegan_tpu_torch.cli import train as train_cli
from nelegan_tpu_torch.config import Config, ModelConfig, policy_dtype
from nelegan_tpu_torch.models.convert import (
    discriminator_state_dict_from_jax, generator_state_dict_from_jax,
    train_state_from_jax)
from nelegan_tpu_torch.models.discriminator import (IntelDiscriminator,
                                                    QualityDiscriminator)
from nelegan_tpu_torch.models.generator import Generator
from nelegan_tpu_torch.train import gan

MEAN_BAR, MAX_BAR = 0.03, 0.25   # tests/test_mixed_precision.py:68-69
SCORE_BAR = 0.02                 # tests/test_mixed_precision.py:83
# one bf16 G and D step's losses against the reference package's bf16
# steps: the two place bf16 rounding apart in places (see above), which
# moves these losses by 3e-6 to 9e-6 of their value; ten times that
LOSS_BAR = 1e-4
BF16 = dict(compute_dtype="bfloat16")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bands():
    """tests/test_mixed_precision.py's inputs: [4, 96, 64] bands."""
    rng = np.random.default_rng(0)
    b, t = 4, 96
    cb = (np.abs(rng.standard_normal((b, t, 64))) * 0.1).astype(np.float32)
    nb = (np.abs(rng.standard_normal((b, t, 64))) * 0.05).astype(np.float32)
    return cb, nb, np.full((b,), t, np.int32)


def _masks(cb, nb, params):
    """The reference package's float32 and bfloat16 masks of one params
    tree, one jitted program each."""
    c32 = JaxModelConfig()
    c16 = dataclasses.replace(c32, **BF16)
    return [np.asarray(jax.jit(JaxGenerator.from_config(c).apply)(
        {"params": params}, cb, nb)) for c in (c32, c16)]


def test_policy_dtype():
    assert policy_dtype("float32") is None
    assert policy_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        policy_dtype("int8")


def test_state_dicts_identical_across_policies():
    """The same seed gives the same float32 tensors under both policies,
    for the generator and both discriminators."""
    for cls in (Generator, IntelDiscriminator, QualityDiscriminator):
        mods = []
        for kw in ({}, BF16):
            m = (cls.from_config(ModelConfig(**kw)) if cls is Generator
                 else cls(**kw))
            m.reset_parameters(torch.Generator().manual_seed(0))
            mods.append(m.state_dict())
        assert mods[0].keys() == mods[1].keys()
        for k, v in mods[0].items():
            assert v.dtype == mods[1][k].dtype == torch.float32, k
            assert torch.equal(v, mods[1][k]), k


def test_generator_bf16_near_f32_and_the_reference(bands):
    cb, nb, _ = bands
    params = jax.jit(JaxGenerator.from_config(JaxModelConfig()).init)(
        jax.random.PRNGKey(0), cb, nb)["params"]
    j32, j16 = _masks(cb, nb, params)
    sd = generator_state_dict_from_jax(params)
    out = {}
    for name, kw in (("f32", {}), ("bf16", BF16)):
        gen = Generator.from_config(ModelConfig(**kw))
        gen.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out[name] = gen(torch.from_numpy(cb),
                            torch.from_numpy(nb)).numpy()
    assert out["bf16"].dtype == np.float32
    rel = np.abs(out["bf16"] - out["f32"]) / out["f32"]
    assert rel.mean() < MEAN_BAR and rel.max() < MAX_BAR, (rel.mean(),
                                                            rel.max())
    ref_bar = float(np.mean(np.abs(j16 - j32) / j32))
    near = float(np.mean(np.abs(out["bf16"] - j16) / j16))
    assert near < ref_bar, (near, ref_bar)
    # the float32 policy is the reference package's float32 generator
    np.testing.assert_allclose(out["f32"], j32, rtol=1e-4, atol=0)


def test_discriminator_bf16_runs_f32_head(bands):
    _, _, frames = bands
    img = (np.random.default_rng(1).standard_normal(
        (4, 64, 96, 3)).astype(np.float32) * 0.1)
    v = jax.jit(JaxIntel.from_config(JaxModelConfig()).init)(
        jax.random.PRNGKey(1), img)
    j16 = np.asarray(jax.jit(JaxIntel.from_config(
        JaxModelConfig(**BF16)).apply)(v, img, frames))
    sd = discriminator_state_dict_from_jax(v)
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    out = {}
    for name, kw in (("f32", {}), ("bf16", BF16)):
        d = IntelDiscriminator(**kw).eval()
        d.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out[name] = d(x, torch.from_numpy(frames)).numpy()
    assert out["bf16"].dtype == np.float32
    assert np.abs(out["bf16"] - out["f32"]).max() < SCORE_BAR
    assert np.abs(out["bf16"] - j16).max() < SCORE_BAR


def test_f32_policy_is_bit_equal_to_no_policy(bands):
    cb, nb, frames = bands
    rng = torch.Generator().manual_seed(3)
    gen, gen32 = Generator(), Generator(compute_dtype="float32")
    gen.reset_parameters(rng)
    gen32.load_state_dict(gen.state_dict())
    x = [torch.from_numpy(a) for a in (cb, nb)]
    assert torch.equal(gen(*x), gen32(*x))
    d, d32 = IntelDiscriminator(), IntelDiscriminator(compute_dtype="float32")
    d32.load_state_dict(d.state_dict())
    img = torch.from_numpy(np.stack([cb, nb, cb], 1).transpose(0, 1, 3, 2)
                           .copy())
    f = torch.from_numpy(frames)
    assert torch.equal(d.eval()(img, f), d32.eval()(img, f))


def test_bf16_gan_steps_train_like_the_reference():
    """One G step and one D step under the bfloat16 policy at the small
    config, from one JAX state: finite losses near the reference package's;
    the parameters and the spectral u and v float32, finite, and moved."""
    jcfg = JaxConfig(model=JaxModelConfig(
        gen_hidden=32, gen_blocks=2, disc_channels=(4, 8),
        disc_kernels=(1, 3), **BF16))
    cfg = Config(model=ModelConfig(
        gen_hidden=32, gen_blocks=2, disc_channels=(4, 8),
        disc_kernels=(1, 3), **BF16))
    rng = np.random.default_rng(0)
    b, t = 2, 40
    cb = (np.abs(rng.standard_normal((b, t, 64))) * 0.1).astype(np.float32)
    nb = (np.abs(rng.standard_normal((b, t, 64))) * 0.05).astype(np.float32)
    frames = np.full((b,), t, np.int32)
    tg = np.full((b, 3), 0.7, np.float32)
    tq = np.full((b, 2), 0.7, np.float32)

    js = jax.tree.map(np.asarray, jax.jit(
        lambda key: jgan.init_train_state(key, jcfg))(jax.random.PRNGKey(0)))
    state = train_state_from_jax(js, cfg, device="cpu")
    origin = copy.deepcopy(state)
    js, jgl = jgan.g_step_bands(js, cb, nb, frames, jcfg)
    img3, img2 = jgan.d_images(jnp.asarray(cb), jnp.asarray(nb),
                               jnp.asarray(cb), jnp.asarray(frames))
    _, jdl, jql = jgan.d_step(js, img3, img2, frames, tg, tq, jcfg)
    state, gl = gan.g_step_bands(state, cb, nb, frames, cfg)
    state, dl, ql = gan.d_step_bands(state, cb, nb, cb, frames, tg, tq, cfg)
    for got, want in ((gl, jgl), (dl, jdl), (ql, jql)):
        assert np.isfinite(float(got))
        assert abs(float(got) - float(want)) <= LOSS_BAR * abs(float(want))
    moved = False
    for m in ("gen", "d", "dq"):
        for k, v in getattr(state, m).state_dict().items():
            assert v.dtype == torch.float32, k
            assert torch.isfinite(v).all(), k
            moved |= not torch.equal(v, getattr(origin, m).state_dict()[k])
    assert moved


def test_train_cli_takes_bf16():
    args = train_cli.build_parser().parse_args(
        ["--train-clean", "c", "--train-noise", "n", "--test-clean", "tc",
         "--test-noise", "tn", "--compute-dtype", "bfloat16"])
    assert args.compute_dtype == "bfloat16"
