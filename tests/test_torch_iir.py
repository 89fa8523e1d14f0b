"""The port's ops/iir against the JAX package's, float64 on the CPU, at the
JAX package's own bars (tests/test_iir.py), and the plain recurrence with
an initial state against a numpy loop; `linrec`'s gradients by gradcheck
and against `jax.grad` of the JAX package's filters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from nelegan_tpu.metrics.haspi.ear_model import middle_ear as jax_middle_ear
from nelegan_tpu.ops import iir as jiir
from nelegan_tpu_torch.metrics.haspi.ear_model import middle_ear
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


# ---------------------------------------------------------------- gradients
def _rand(rng, shape, complex_rows):
    v = rng.randn(*shape)
    return v + 1j * rng.randn(*shape) if complex_rows else v


def _linrec_inputs(rows, n, per_step, complex_rows, seed):
    rng = np.random.RandomState(seed)
    a = 0.45 * _rand(rng, (rows, n) if per_step else (rows,), complex_rows)
    return (torch.from_numpy(a), torch.from_numpy(_rand(rng, (rows, n),
                                                        complex_rows)),
            torch.from_numpy(_rand(rng, (rows,), complex_rows)))


@pytest.mark.parametrize("with_y0", [False, True])
@pytest.mark.parametrize("per_step", [False, True])
@pytest.mark.parametrize("complex_rows", [False, True])
def test_linrec_gradcheck(per_step, complex_rows, with_y0):
    """The CPU path of linrec's autograd Function (the plain loops the
    kernel is held against) against finite differences, in torch's
    convention for complex gradients."""
    a, b, y0 = (t.requires_grad_() for t in _linrec_inputs(
        3, 17, per_step, complex_rows, 10))
    y0 = y0 if with_y0 else None
    assert type(iir.linrec(a, b, y0).grad_fn).__name__ == "_LinrecBackward"
    assert torch.autograd.gradcheck(iir.linrec, (a, b, y0))


@pytest.mark.parametrize("per_step", [False, True])
@pytest.mark.parametrize("complex_rows", [False, True])
def test_linrec_backward_plain_matches_loop_autograd(per_step, complex_rows):
    """The plain adjoint (the card's formulas) against autograd through the
    raw forward loop."""
    a, b, y0 = (t.requires_grad_() for t in _linrec_inputs(
        4, 60, per_step, complex_rows, 11))
    g = torch.from_numpy(_rand(np.random.RandomState(12), (4, 60),
                               complex_rows))
    y = iir.linrec_plain(a, b, y0)
    want = torch.autograd.grad(y, (b, a, y0), g)
    got = iir.linrec_backward_plain(a.detach(), g, y.detach(), y0.detach())
    for w, v in zip(want, got):
        np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("name", ["one_pole", "biquad", "middle_ear"])
def test_filter_gradients_match_jax(name):
    """d sum(w * f(x)) / dx through linrec's adjoint against jax.grad of
    the JAX package's scans, [2, 300] float64."""
    jax_fn, torch_fn = {
        "one_pole": (lambda x: jiir.one_pole(x, 0.9),
                     lambda x: iir.one_pole(x, 0.9)),
        "biquad": (lambda x: jiir.biquad(x, BQ_B, BQ_A),
                   lambda x: iir.biquad(x, BQ_B, BQ_A)),
        "middle_ear": (jax_middle_ear, middle_ear)}[name]
    rng = np.random.RandomState(13)
    x, w = rng.randn(2, 300), rng.randn(2, 300)
    want = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(jnp.asarray(w) * jax_fn(v))))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (torch.from_numpy(w) * torch_fn(xt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("per_step", [False, True])
def test_one_pole_grad_of_a_matches_jax(per_step):
    """d sum(w * one_pole(x, a)) / da through linrec's adjoint (its da) with
    `a` per row and per step, against jax.grad of the JAX package's
    one_pole, [2, 300] float64."""
    rng = np.random.RandomState(15)
    x, w = rng.randn(2, 300), rng.randn(2, 300)
    a = rng.uniform(-0.9, 0.9, (2, 300) if per_step else (2, 1))
    want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(
        jnp.asarray(w) * jiir.one_pole(jnp.asarray(x), v))))(jnp.asarray(a)))
    at = torch.from_numpy(a).requires_grad_()
    (torch.from_numpy(w) * iir.one_pole(torch.from_numpy(x), at)).sum(
    ).backward()
    np.testing.assert_allclose(at.grad.numpy(), want, rtol=1e-10, atol=1e-10)


def test_linear_recurrence_2x2_refuses_grad_of_m_off_cpu():
    """Off the CPU m is eigendecomposed on the host, so a gradient with
    respect to it would be lost: it raises (the meta device stands in for
    the card here)."""
    with pytest.raises(ValueError, match="requires grad"):
        iir.linear_recurrence_2x2(torch.eye(2, requires_grad=True),
                                  torch.zeros(5, 2, device="meta"))
