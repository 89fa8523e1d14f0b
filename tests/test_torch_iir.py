"""The port's ops/iir against the JAX package's, float64 on the CPU, at the
JAX package's own bars (tests/test_iir.py), and the plain recurrence with
an initial state against a numpy loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from nelegan_tpu.ops import iir as jiir
from nelegan_tpu_torch.ops import iir

BQ_B = [0.937260390269893, -1.874520780539785, 0.937260390269893]
BQ_A = [1.0, -1.870580640735279, 0.878460920344291]


def _both(fn, x, *args, **kw):
    """The JAX function jitted around its static arguments (one compilation
    in place of op-by-op dispatch of the associative scan), and the port's."""
    want = np.asarray(jax.jit(lambda v: getattr(jiir, fn)(v, *args, **kw))(
        jnp.asarray(x)))
    got = getattr(iir, fn)(torch.from_numpy(x), *args, **kw).numpy()
    return got, want


_jax_one_pole = jax.jit(jiir.one_pole)
_jax_blocked = jax.jit(jiir.one_pole_blocked)


@pytest.mark.parametrize("a", [0.5, 0.99, -0.3])
def test_one_pole_matches_jax(a):
    x = np.random.RandomState(0).randn(4000)
    want = np.asarray(_jax_one_pole(jnp.asarray(x), jnp.asarray(a)))
    got = iir.one_pole(torch.from_numpy(x), a).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, lfilter([1.0], [1.0, -a], x),
                               rtol=1e-9, atol=1e-12)


def test_one_pole_per_channel_and_axis():
    """a per row (constant along the axis) and the recurrence on axis 0."""
    rng = np.random.RandomState(6)
    x = rng.randn(3, 700)
    a = np.array([[0.2], [0.9], [-0.5]])
    got = iir.one_pole(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    want = np.stack([lfilter([1.0], [1.0, -a[i, 0]], x[i]) for i in range(3)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    got0 = iir.one_pole(torch.from_numpy(x.T.copy()), 0.7, axis=0).numpy()
    np.testing.assert_allclose(got0.T, lfilter([1.0], [1.0, -0.7], x),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", [1000, 4097])
def test_one_pole_blocked_matches_jax(n):
    x = np.random.RandomState(1).randn(n)
    for a in (0.99, 0.5):
        want = np.asarray(_jax_blocked(jnp.asarray(x), jnp.asarray(a)))
        got = iir.one_pole_blocked(torch.from_numpy(x), a).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("blocked", [False, True])
def test_one_pole_cascade_matches_jax(blocked):
    x = np.random.RandomState(3).randn(3000)
    got, want = _both("one_pole_cascade", x, 0.97, 4, blocked=blocked)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)


def test_biquad_matches_jax():
    x = np.random.RandomState(4).randn(3000)
    got, want = _both("biquad", x, BQ_B, BQ_A)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    # real poles: two real one-poles
    got, want = _both("biquad", x, [1.0, 0.5], [1.0, -0.9, 0.2])
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_fir_matches_jax():
    x = np.random.RandomState(5).randn(300)
    got, want = _both("fir", x, [0.4, -0.2, 0.1])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_linear_recurrence_2x2_matches_jax():
    rng = np.random.RandomState(7)
    m = rng.randn(400, 2, 2) * 0.5
    v = rng.randn(400, 2)
    want = np.asarray(jax.jit(jiir.linear_recurrence_2x2)(jnp.asarray(m),
                                                          jnp.asarray(v)))
    got = iir.linear_recurrence_2x2(torch.from_numpy(m),
                                    torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("per_step", [False, True])
@pytest.mark.parametrize("complex_rows", [False, True])
def test_linrec_plain_with_initial_state(per_step, complex_rows):
    """y[n] = a[n] y[n-1] + b[n] from y[-1] = y0, the form PESQ's gain
    memory takes, against a numpy loop."""
    rng = np.random.RandomState(8)
    rows, n = 3, 500
    shape = (rows, n) if per_step else (rows,)
    a = rng.uniform(-0.95, 0.95, shape)
    b = rng.randn(rows, n)
    y0 = rng.randn(rows)
    if complex_rows:
        a = a * np.exp(1j * rng.uniform(-np.pi, np.pi, shape))
        b = b + 1j * rng.randn(rows, n)
        y0 = y0 + 1j * rng.randn(rows)
    want = np.empty_like(b)
    s = y0.copy()
    for i in range(n):
        s = (a[:, i] if per_step else a) * s + b[:, i]
        want[:, i] = s
    got = iir.linrec(*(torch.from_numpy(v) for v in (a, b, y0))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    zero = iir.linrec(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    a_full = a if per_step else np.repeat(a[:, None], n, 1)
    want0 = want - np.cumprod(a_full, 1) * y0[:, None]
    np.testing.assert_allclose(zero, want0, rtol=1e-10, atol=1e-10)


def test_linrec_refuses_bad_inputs():
    b = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="linrec expects"):
        iir.linrec(torch.zeros(3), b)
    with pytest.raises(TypeError, match="dtype"):
        iir.linrec(torch.zeros(2, dtype=torch.float64), b)


def test_fft_helpers_match_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 1500)
    np.testing.assert_allclose(
        iir.one_pole_fft(torch.from_numpy(x), 0.9).numpy(),
        np.asarray(jax.jit(jiir.one_pole_fft)(jnp.asarray(x), 0.9)),
        rtol=1e-9, atol=1e-9)
    for fn, args in (("one_pole_ir", (-0.8, 300)),
                     ("gammatone_ir", (0.97, 300)),
                     ("exp_sum_ir", ([0.9, -0.5], [1.0, 2.0], 300))):
        got = getattr(iir, fn)(*args, dtype=torch.float64).numpy()
        want = np.asarray(jax.jit(lambda: getattr(jiir, fn)(
            *args, dtype=jnp.float64))())
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    assert [iir._fft_len(n) for n in (5, 100, 4097)] == [
        jiir._fft_len(n) for n in (5, 100, 4097)]
    assert iir._fft_len_ir(55296, 4096) == jiir._fft_len_ir(55296, 4096)
