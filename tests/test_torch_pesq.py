"""The port's PESQ (metrics/pesq.py) against the JAX package's, float64 on
the CPU: plain, with all three alignment stages, rows of different n_valid
in one batch, the MOS map, the gradient with respect to the degraded
signal, and the port's float32 against its float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nelegan_tpu.metrics import pesq as jpesq
from nelegan_tpu_torch import kernels
from nelegan_tpu_torch.metrics import pesq

# The port against the JAX package at float64, relative: the two run the
# same operations, so they differ by float64 round-off (the FFTs' and the
# gain memory's: a scan with y0 = 1 here, the scan from 0 plus 0.2^(t+1)
# there).
JAX_BAR = 1e-9
# The gradient with respect to deg, against jax.grad, relative to the
# gradient's norm.
GRAD_BAR = 1e-7
N = 20000                # 1.25 s at 16 kHz


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(goldens):
    """A crop of the golden speech and a noisy, rescaled copy, float64."""
    g = goldens("features")
    ref = g["clean"][2000:2000 + N].astype(np.float64)
    deg = 0.9 * ref + 0.3 * g["noise"][5000:5000 + N].astype(np.float64)
    return ref, deg


def _burst_train(rng, n_bursts=10, burst_len=1920, gap_len=2880):
    """tests/test_pesq.py's rectangular bursts with sub-utterance gaps."""
    sig = []
    for _ in range(n_bursts):
        sig.append(0.3 * rng.standard_normal(burst_len))
        sig.append(0.003 * rng.standard_normal(gap_len))
    return np.concatenate(sig)


@pytest.fixture(scope="module")
def two_jumps():
    """tests/test_pesq.py's two-jump stimulus: the middle section delayed
    by 1900 samples (delay 0 -> d -> 0), which the utterance stage cannot
    fit and the bad-interval stage repairs."""
    base = _burst_train(np.random.default_rng(0))
    p = 1920 + 2880
    a, b, j = 3 * p, 7 * p, 1900
    deg = np.concatenate([base[:a], np.zeros(j), base[a:b - j], base[b:]])
    return base, deg


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def test_pesq_matches_jax(pair):
    ref, deg = pair
    want = float(jpesq.pesq_p862_16k(jnp.asarray(ref), jnp.asarray(deg)))
    got = pesq.pesq_p862(torch.from_numpy(ref), torch.from_numpy(deg))
    assert got.dtype == torch.float64 and got.shape == ()
    assert _rel(got, want) < JAX_BAR, (float(got), want)


def test_pesq_all_alignment_stages_match_jax(two_jumps):
    """align_bad_intervals runs the global, utterance (split-aware) and
    bad-interval stages; on this stimulus the last one changes the score
    (tests/test_pesq.py: 1.73 without it, 2.53 with it)."""
    ref, deg = two_jumps
    want = float(jpesq.pesq_p862(ref, deg, align_bad_intervals=True))
    got = float(pesq.pesq_p862(torch.from_numpy(ref), torch.from_numpy(deg),
                               align_bad_intervals=True))
    assert _rel(got, want) < JAX_BAR, (got, want)
    utt = float(pesq.pesq_p862(torch.from_numpy(ref), torch.from_numpy(deg),
                               align_utterances=True))
    assert got > utt + 0.3, (utt, got)


def test_pesq_rows_of_different_lengths(pair):
    """One batch of zero-padded rows with their n_valid: each row equals
    the same row scored alone, and the JAX package's score of it; the
    alignment stages reduce per row too."""
    ref, deg = pair
    lens = [N, 15000, 9001]
    r = np.zeros((3, N))
    d = np.zeros((3, N))
    for j, m in enumerate(lens):
        r[j, :m], d[j, :m] = ref[:m], deg[:m]
        d[j, :m] = np.roll(d[j, :m], 64 * j)     # a delay per row
    nv = np.array(lens)
    jfn = jax.jit(jpesq.pesq_p862_16k)
    for flag in (False, True):
        got = pesq.pesq_p862_16k(torch.from_numpy(r), torch.from_numpy(d),
                                 torch.from_numpy(nv), align_global=flag)
        assert got.shape == (3,)
        for j in range(3):
            alone = pesq.pesq_p862_16k(torch.from_numpy(r[j]),
                                       torch.from_numpy(d[j]), int(nv[j]),
                                       align_global=flag)
            assert float(got[j]) == pytest.approx(float(alone), rel=1e-12)
            if not flag:
                want = float(jfn(r[j], d[j], nv[j]))
                assert _rel(got[j], want) < JAX_BAR, (j, float(got[j]), want)
    # the global delay is found per row: with it the delayed rows score
    # higher than without
    assert (pesq.pesq_p862_16k(torch.from_numpy(r), torch.from_numpy(d),
                               torch.from_numpy(nv), align_global=True)[1:]
            > pesq.pesq_p862_16k(torch.from_numpy(r), torch.from_numpy(d),
                                 torch.from_numpy(nv))[1:]).all()


def test_mos_lqo_wb_matches_jax():
    x = np.linspace(-0.5, 4.5, 11)
    np.testing.assert_allclose(pesq.mos_lqo_wb(torch.from_numpy(x)).numpy(),
                               np.asarray(jpesq.mos_lqo_wb(jnp.asarray(x))),
                               rtol=1e-14)


def test_pesq_gradient_matches_jax(pair):
    """d PESQ / d deg on a padded row (n_valid short of the buffer, so the
    padded frames sit at the ties of maximum, minimum and clip, and at
    _safe_root's zero) against jax.grad; finite everywhere."""
    ref, deg = pair
    n, nv = 12000, 10000
    r, d = ref[:n].copy(), deg[:n].copy()
    r[nv:] = d[nv:] = 0.0
    want = np.asarray(jax.grad(lambda x: jpesq.pesq_p862_16k(
        jnp.asarray(r), x, jnp.asarray(nv)))(jnp.asarray(d)))
    x = torch.from_numpy(d).requires_grad_()
    kernels.reset_launches()
    pesq.pesq_p862_16k(torch.from_numpy(r), x, nv).backward()
    got = x.grad.numpy()
    assert np.isfinite(got).all()
    assert (np.linalg.norm(got - want) / np.linalg.norm(want)) < GRAD_BAR
    assert not got[nv:].any() and not want[nv:].any()
    assert kernels.launches["linrec"] == 0       # the CPU takes the loop


def test_pesq_float32_near_float64(pair):
    """The port's float32 against its float64, |f32 - f64| / max(|f64|, 1):
    under 1e-5 (the card's float32 bar in chip_smoke.py is set from this)."""
    ref, deg = pair
    want = float(pesq.pesq_p862(torch.from_numpy(ref),
                                torch.from_numpy(deg)))
    got = pesq.pesq_p862(torch.from_numpy(ref).float(),
                         torch.from_numpy(deg).float())
    assert got.dtype == torch.float32
    assert abs(float(got) - want) / max(abs(want), 1.0) < 1e-5
