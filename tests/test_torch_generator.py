"""Port generator (nelegan_tpu_torch.models) against the flax Generator from
the same parameters, carried across with generator_state_dict_from_jax."""
import functools
import io

import jax
import numpy as np
import pytest
import torch

from nelegan_tpu.models.generator import Generator as JaxGenerator
from nelegan_tpu_torch.models.convert import (generator_state_dict_from_jax,
                                              load_reference_checkpoint)
from nelegan_tpu_torch.models.generator import Generator

# (hidden, blocks, T): a narrow stack, and the full width on a short T
SIZES = [(32, 3, 23), (256, 6, 12)]


@functools.lru_cache(maxsize=None)
def _flax(hidden, blocks):
    jg = JaxGenerator(hidden=hidden, n_blocks=blocks)
    z = np.zeros((1, 4, 64), np.float32)
    params = jax.jit(jg.init)(jax.random.PRNGKey(0), z, z)["params"]
    return jax.jit(jg.apply), params


def _pair(hidden, blocks, dtype):
    apply, params = _flax(hidden, blocks)
    tg = Generator(hidden=hidden, n_blocks=blocks).to(dtype)
    tg.load_state_dict(generator_state_dict_from_jax(params), strict=True)
    return apply, params, tg.eval()


def _inputs(t, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(2, t, 64).astype(dtype) + 0.1,
            rng.rand(2, t, 64).astype(dtype) + 0.1)


@pytest.mark.parametrize("hidden,blocks,t", SIZES)
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-9),
                                        (np.float32, 1e-4)])
def test_generator_matches_flax(hidden, blocks, t, dtype, rtol):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    apply, params, tg = _pair(hidden, blocks, tdt)
    clean, noise = _inputs(t, dtype)
    want = np.asarray(apply({"params": params}, clean, noise))
    with torch.no_grad():
        got = tg(torch.from_numpy(clean), torch.from_numpy(noise)).numpy()
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * 1e-1)


def test_generator_is_causal():
    _, _, tg = _pair(32, 3, torch.float64)
    clean, noise = _inputs(40, np.float64, seed=1)
    clean2 = clean.copy()
    clean2[:, 25:] = 9.9
    with torch.no_grad():
        a = tg(torch.from_numpy(clean), torch.from_numpy(noise)).numpy()
        b = tg(torch.from_numpy(clean2), torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(a[:, :25], b[:, :25])
    assert np.abs(a[:, 25:] - b[:, 25:]).max() > 1e-3


def test_reference_checkpoint_loads_strict(tmp_path):
    """A chkpt_GD.pt in the reference format loads with strict=True and
    gives the same generator."""
    _, params, tg = _pair(256, 6, torch.float32)
    path = tmp_path / "chkpt_GD.pt"
    torch.save({"enhance-model": tg.state_dict()}, path)
    sd = load_reference_checkpoint(str(path))
    assert "convolutions.5.2.gain0" in sd and sd["fc2.weight"].shape == (64, 64)
    g2 = Generator()
    g2.load_state_dict(sd, strict=True)
    clean, noise = _inputs(9, np.float32)
    with torch.no_grad():
        np.testing.assert_array_equal(
            g2(torch.from_numpy(clean), torch.from_numpy(noise)).numpy(),
            tg(torch.from_numpy(clean), torch.from_numpy(noise)).numpy())
    torch.save({"intel-model": {}}, buf := io.BytesIO())
    bad = tmp_path / "bad.pt"
    bad.write_bytes(buf.getvalue())
    with pytest.raises(KeyError):
        load_reference_checkpoint(str(bad))


def test_bfloat16_policy_raises():
    """The bfloat16 policy is ported: it builds, with float32 parameters;
    any other policy raises."""
    gen = Generator(compute_dtype="bfloat16")
    assert gen.compute_dtype is torch.bfloat16
    assert all(p.dtype == torch.float32 for p in gen.parameters())
    with pytest.raises(ValueError):
        Generator(compute_dtype="int8")
