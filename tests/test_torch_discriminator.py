"""Port spectral-norm layers and discriminators (nelegan_tpu_torch.models)
against the flax modules of the reference package from the same
parameters, carried across with discriminator_state_dict_from_jax.  The
heads' flax variables come from the reference package's own converter of a
seeded port head (its JAX init costs seconds to compile; a flax-initialised
state is carried across in test_torch_gan.py).

Bars: float64 rtol 1e-9 (the reference package's discriminator bar,
COMPONENTS.md:13-14), float32 rtol 1e-4 (its generator bar, COMPONENTS.md:10),
each with an absolute term a thousandth of the relative one for outputs
near zero."""
import functools

import jax
import numpy as np
import pytest
import torch

from nelegan_tpu.models.convert import torch_discriminator_to_flax
from nelegan_tpu.models.discriminator import (
    IntelDiscriminator as JaxIntel, QualityDiscriminator as JaxQuality)
from nelegan_tpu.models.spectral_norm import SNConv2D, SNDense
from nelegan_tpu_torch.config import ModelConfig
from nelegan_tpu_torch.models.convert import discriminator_state_dict_from_jax
from nelegan_tpu_torch.models.discriminator import (IntelDiscriminator,
                                                    QualityDiscriminator)
from nelegan_tpu_torch.models.spectral_norm import SNConv2d, SNLinear

HEADS = {"intel": (JaxIntel, IntelDiscriminator, 3),
         "quality": (JaxQuality, QualityDiscriminator, 2)}
BARS = {np.float64: 1e-9, np.float32: 1e-4}


def _tdt(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


def _close(got, want, dtype):
    rtol = BARS[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * 1e-3)


@functools.lru_cache(maxsize=None)
def _jax_head(head):
    """float32 flax variables of a seeded head and the jitted flax apply."""
    jax_cls, cls, _ = HEADS[head]
    seeded = cls()
    seeded.reset_parameters(torch.Generator().manual_seed(1))
    var = torch_discriminator_to_flax(seeded.state_dict())
    apply = jax.jit(jax_cls().apply, static_argnames=("update_sn", "mutable"))
    return jax.tree.map(np.asarray, var), apply


def _port_head(head, var, dtype):
    _, cls, _ = HEADS[head]
    d = cls()
    d.load_state_dict(discriminator_state_dict_from_jax(var), strict=True)
    return d.to(_tdt(dtype))


def _images(c, dtype, seed=0):
    """[3, 64, 36, c] NHWC images and ragged frame counts."""
    rng = np.random.RandomState(seed)
    return (rng.rand(3, 64, 36, c).astype(dtype),
            np.array([36, 29, 24], np.int32))


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_head_eval_forward_matches_flax(head, dtype):
    """Eval forwards of the port in `dtype` against flax in float64 on the
    same (float32-representable) parameters and images."""
    var, apply = _jax_head(head)
    var = jax.tree.map(lambda a: a.astype(dtype), var)
    d = _port_head(head, var, dtype).eval()
    x, frames = _images(HEADS[head][2], dtype)
    want = np.asarray(apply(jax.tree.map(lambda a: a.astype(np.float64), var),
                            x.astype(np.float64), frames))
    with torch.no_grad():
        got = d(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                torch.from_numpy(frames)).numpy()
    assert got.dtype == dtype and got.shape == (3, HEADS[head][2])
    _close(got, want.astype(dtype), dtype)
    # an eval forward leaves u and v alone
    sd = discriminator_state_dict_from_jax(var)
    for k, v in d.state_dict().items():
        if k.endswith(("weight_u", "weight_v")):
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy())


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_train_forward_advances_power_iteration_like_flax(head):
    """Two training forwards at float64: scores, and every layer's u and v
    after each, against flax with update_sn=True."""
    var, apply = _jax_head(head)
    var = jax.tree.map(lambda a: a.astype(np.float64), var)
    d = _port_head(head, var, np.float64).train()
    for seed in (0, 1):
        x, frames = _images(HEADS[head][2], np.float64, seed)
        want, upd = apply(var, x, frames, update_sn=True,
                          mutable=("spectral",))
        var = {"params": var["params"],
               "spectral": jax.tree.map(np.asarray, upd["spectral"])}
        with torch.no_grad():
            got = d(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                    torch.from_numpy(frames)).numpy()
        _close(got, np.asarray(want), np.float64)
        sd = discriminator_state_dict_from_jax(var)
        for k, v in d.state_dict().items():
            if k.endswith(("weight_u", "weight_v")):
                _close(v.numpy(), sd[k].numpy(), np.float64)


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_sn_layer_matches_flax(kind):
    """One layer alone at float64: eval forward, train forward, and the
    stored (u, v) after the update."""
    rng = np.random.RandomState(3)
    if kind == "conv":
        mod, x = SNConv2D(8, 3), rng.rand(2, 10, 12, 4)
        layer = SNConv2d(4, 8, 3)
        to_t, from_t = (lambda a: a.transpose(0, 3, 1, 2),
                        lambda a: a.transpose(0, 2, 3, 1))
        w_layout = (3, 2, 0, 1)
    else:
        mod, x = SNDense(16), rng.rand(5, 64)
        layer = SNLinear(64, 16)
        to_t = from_t = lambda a: a
        w_layout = (1, 0)
    var = jax.tree.map(np.asarray, jax.jit(mod.init)(jax.random.PRNGKey(2), x))
    apply = jax.jit(mod.apply, static_argnames=("update_sn", "mutable"))
    layer = layer.double()
    layer.load_state_dict({
        "weight_orig": torch.from_numpy(
            var["params"]["weight_orig"].transpose(w_layout).copy()),
        "bias": torch.from_numpy(var["params"]["bias"].copy()),
        "weight_u": torch.from_numpy(var["spectral"]["u"].copy()),
        "weight_v": torch.from_numpy(var["spectral"]["v"].copy())},
        strict=True)
    with torch.no_grad():
        got = from_t(layer.eval()(torch.from_numpy(to_t(x))).numpy())
        _close(got, np.asarray(apply(var, x)), np.float64)
        want, upd = apply(var, x, update_sn=True, mutable=("spectral",))
        got = from_t(layer.train()(torch.from_numpy(to_t(x))).numpy())
    _close(got, np.asarray(want), np.float64)
    _close(layer.weight_u.numpy(), np.asarray(upd["spectral"]["u"]),
           np.float64)
    _close(layer.weight_v.numpy(), np.asarray(upd["spectral"]["v"]),
           np.float64)


def test_state_dict_from_jax_has_reference_layout():
    var, _ = _jax_head("intel")
    sd = discriminator_state_dict_from_jax(var)
    d = IntelDiscriminator()
    assert set(sd) == set(d.state_dict())
    assert tuple(sd["layers.4.weight_orig"].shape) == (64, 48, 9, 9)
    assert tuple(sd["layers.4.weight_v"].shape) == (48 * 9 * 9,)
    assert tuple(sd["fc3.weight_orig"].shape) == (3, 16)
    d.load_state_dict(sd, strict=True)
    del sd["fc2.weight_u"]
    with pytest.raises(RuntimeError, match="weight_u"):
        IntelDiscriminator().load_state_dict(sd, strict=True)


def test_masked_pool_equals_unpadded_runs():
    """A zero-padded batch with frame counts scores each row as the row
    alone at its own length."""
    torch.manual_seed(0)
    d = IntelDiscriminator().double().eval()
    rng = np.random.RandomState(4)
    a, b = rng.rand(1, 3, 64, 30), rng.rand(1, 3, 64, 41)
    batch = np.zeros((2, 3, 64, 41))
    batch[0, ..., :30] = a[0]
    batch[1] = b[0]
    with torch.no_grad():
        got = d(torch.from_numpy(batch), torch.tensor([30, 41])).numpy()
        one = d(torch.from_numpy(a)).numpy()
        two = d(torch.from_numpy(b)).numpy()
    _close(got[0], one[0], np.float64)
    _close(got[1], two[0], np.float64)


def test_init_and_config():
    """Seeded init: he-uniform weights, zero biases, unit u and
    v = l2norm(W^T u); from_config takes the widths; under the bfloat16
    policy the trunk convolutions compute in bfloat16, the heads do not, and
    the parameters stay float32."""
    mc = ModelConfig(disc_channels=(4, 8), disc_kernels=(1, 3))
    a = QualityDiscriminator.from_config(mc)
    b = QualityDiscriminator.from_config(mc)
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(7))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert [tuple(m.weight_orig.shape) for m in a.layers] == [(4, 2, 1, 1),
                                                              (8, 4, 3, 3)]
    assert a.shrink == 2 and a.fc3.weight_orig.shape == (2, 16)
    for m in (*a.layers, a.fc1, a.fc2, a.fc3):
        w = m.weight_orig.detach()
        wmat = w.reshape(w.shape[0], -1)
        assert float(w.abs().max()) <= (6.0 / wmat.shape[1]) ** 0.5
        assert float(m.bias.detach().abs().max()) == 0.0
        assert abs(float(m.weight_u.norm()) - 1.0) < 1e-6
        v = wmat.t() @ m.weight_u
        torch.testing.assert_close(m.weight_v, v / v.norm())
    bf16 = IntelDiscriminator(compute_dtype="bfloat16")
    assert all(m.compute_dtype is torch.bfloat16 for m in bf16.layers)
    assert all(m.compute_dtype is None for m in (bf16.fc1, bf16.fc2,
                                                  bf16.fc3))
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
