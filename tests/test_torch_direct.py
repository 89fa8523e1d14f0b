"""The port's direct-metric G step (nelegan_tpu_torch.train.direct) against
the reference package's (nelegan_tpu/train/direct.py), at float64: a small
generator (hidden 32, 2 blocks) carried across with models/convert.py, two
rows cut from tests/goldens/features.npz (20480 and 16384 samples, the
second padded), featurized once by the reference package and given to
both.

Bars: the loss within LOSS_BAR relative; each parameter's gradient within
GRAD_BAR relative in norm (tests/test_torch_pesq.py's); after three
direct_g_step steps from the same params and optax state, every parameter
and loss within STEP_BAR (tests/test_torch_gan.py's G-step bar).  Both
sides do the same float64 arithmetic in other orders.

A row padded past one ESTOI segment of silence (13000 of 20480 samples)
gives the reference package a NaN gradient (ROADMAP.md section 3); the
port's is finite there, and is held to float64 central differences along
seeded directions (FD_BAR) instead.
"""
import functools

import jax
import numpy as np
import optax
import pytest
import torch

from nelegan_tpu import pipeline as jpipe
from nelegan_tpu.config import Config as JaxConfig
from nelegan_tpu.config import ModelConfig as JaxModelConfig
from nelegan_tpu.models.generator import Generator as JaxGenerator
from nelegan_tpu.train import direct as jdirect
from nelegan_tpu_torch import kernels
from nelegan_tpu_torch.config import Config, ModelConfig
from nelegan_tpu_torch.dsp import erb
from nelegan_tpu_torch.models.convert import (_load_adam,
                                              generator_state_dict_from_jax)
from nelegan_tpu_torch.models.generator import Generator
from nelegan_tpu_torch.pipeline import BatchFeatures
from nelegan_tpu_torch.train import direct

LOSS_BAR = 1e-9
GRAD_BAR = 1e-7
STEP_BAR = 1e-9
FD_BAR = 1e-7
N = 20480
JCFG = JaxConfig(model=JaxModelConfig(gen_hidden=32, gen_blocks=2))
CFG = Config(model=ModelConfig(gen_hidden=32, gen_blocks=2))
CASES = {"estoi": (0.0, 0.0), "estoi_haspi_pesq": (0.5, 0.5)}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(haspi_weight, pesq_weight):
    """One jitted reference program per case (shapes are the same for
    every input here)."""
    return jax.jit(lambda p, f, c, n: jax.value_and_grad(
        jdirect.direct_metric_loss)(p, f, c, n, JCFG, haspi_weight,
                                    pesq_weight))


def _inputs(goldens, short: int):
    """Rows of N and `short` samples cut from the golden speech and noise,
    featurized by the reference package, as float64: (reference features,
    port features, clean rows, noise rows), the rows zero past their
    lengths."""
    g = goldens("features")
    clean, noise = g["clean"], g["noise"]
    cs = [clean[:N], 0.8 * clean[9000:9000 + short]]
    ns = [noise[:N], 1.3 * noise[5000:5000 + short]]
    cp, lens = jpipe.reflect_pad_batch(cs)
    npd, _ = jpipe.reflect_pad_batch(ns)
    jf = jpipe.featurize_batch(cp, npd, lens)
    jf = type(jf)(*(np.asarray(x, np.float64) if np.asarray(x).dtype.kind
                    == "f" else np.asarray(x) for x in jf))
    tf = BatchFeatures(*(torch.from_numpy(np.array(x)) for x in jf))
    wc, wn = np.zeros((2, N)), np.zeros((2, N))
    for i, (c, n) in enumerate(zip(cs, ns)):
        wc[i, :c.size], wn[i, :n.size] = c, n
    return jf, tf, wc, wn


@pytest.fixture(scope="module")
def params():
    p = jax.jit(JaxGenerator.from_config(JCFG.model).init)(
        jax.random.PRNGKey(0), np.zeros((1, 8, 64)), np.zeros((1, 8, 64)))
    return jax.tree.map(lambda a: np.asarray(a, np.float64), p["params"])


@pytest.fixture(scope="module")
def batch(goldens):
    return _inputs(goldens, 16384)


def _port_generator(params) -> Generator:
    gen = Generator.from_config(CFG.model).double()
    gen.load_state_dict(generator_state_dict_from_jax(params), strict=True)
    return gen


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradient_match_jax(case, params, batch):
    hw, pw = CASES[case]
    jf, tf, wc, wn = batch
    jl, jg = _jax_value_and_grad(hw, pw)(params, jf, wc, wn)
    gen = _port_generator(params)
    kernels.reset_launches()
    loss = direct.direct_metric_loss(gen, tf, wc, wn, CFG, hw, pw)
    loss.backward()
    assert kernels.launches["linrec"] == 0      # the CPU takes the loop
    assert abs(loss.item() - float(jl)) <= LOSS_BAR * abs(float(jl))
    want = generator_state_dict_from_jax(jg)
    for name, p in gen.named_parameters():
        w = want[name].double()
        assert torch.isfinite(p.grad).all(), name
        rel = float((p.grad - w).norm() / w.norm())
        assert rel < GRAD_BAR, (name, rel)


def test_three_direct_g_steps_match_jax(params, batch):
    jf, tf, wc, wn = batch
    opt_state = optax.adam(5e-4).init(params)
    gen = _port_generator(params)
    opt = torch.optim.Adam(gen.parameters(), lr=5e-4)
    _load_adam(opt, gen, opt_state[0], generator_state_dict_from_jax)
    jp, jl, tl = params, [], []
    for _ in range(3):
        jp, opt_state, loss = jdirect.direct_g_step(jp, opt_state, jf, wc,
                                                    wn, JCFG)
        jl.append(float(loss))
        tl.append(float(direct.direct_g_step(gen, opt, tf, wc, wn, CFG)))
    np.testing.assert_allclose(tl, jl, rtol=STEP_BAR, atol=0)
    assert tl[-1] < tl[0]
    want = generator_state_dict_from_jax(jax.tree.map(np.asarray, jp))
    for name, p in gen.named_parameters():
        w = want[name].double()
        err = float((p.detach() - w).abs().max())
        assert err <= STEP_BAR * float(w.abs().max()), (name, err)


def test_padded_row_gradient_finite_unlike_jax(params, goldens):
    """A row padded by 7480 samples: the reference package's ESTOI
    gradient is NaN (sqrt's derivative at a silent segment's zero norm,
    ROADMAP.md section 3); the port's is finite and agrees with float64
    central differences along three seeded directions."""
    jf, tf, wc, wn = _inputs(goldens, 13000)
    _, jg = _jax_value_and_grad(0.0, 0.0)(params, jf, wc, wn)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jg))
    gen = _port_generator(params)
    direct.direct_metric_loss(gen, tf, wc, wn, CFG).backward()
    named = list(gen.named_parameters())
    grads = [p.grad.clone() for _, p in named]
    assert all(torch.isfinite(g).all() for g in grads)
    rng = np.random.RandomState(5)
    h = 1e-5
    for _ in range(3):
        dirs = [torch.from_numpy(rng.standard_normal(p.shape))
                for _, p in named]
        scale = float(sum((d * d).sum() for d in dirs)) ** 0.5
        dirs = [d / scale for d in dirs]
        losses = []
        for sign in (1.0, -1.0):
            moved = _port_generator(params)
            with torch.no_grad():
                for (_, p), d in zip(moved.named_parameters(), dirs):
                    p.add_(sign * h * d)
                losses.append(float(direct.direct_metric_loss(
                    moved, tf, wc, wn, CFG)))
        fd = (losses[0] - losses[1]) / (2 * h)
        an = float(sum((g * d).sum() for g, d in zip(grads, dirs)))
        assert abs(fd - an) <= FD_BAR * abs(an), (fd, an)


def test_band_matrix_first_built_in_inference_mode_serves_autograd():
    """The band matrix cache filled under torch.inference_mode (serving and
    scoring run there) still serves the direct step's backward."""
    erb._matrix.cache_clear()
    with torch.inference_mode():
        erb.interp_band_gain(torch.ones(1, 2, 64, dtype=torch.float64))
    x = torch.ones(1, 2, 64, dtype=torch.float64, requires_grad=True)
    erb.interp_band_gain(x).sum().backward()
    assert torch.isfinite(x.grad).all()
