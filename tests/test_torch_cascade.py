"""Port gammatone cascade (plain version, the CPU path of
nelegan_tpu_torch.ops.cascade) against lfilter and the Pallas kernel."""
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from nelegan_tpu_torch.ops.cascade import gammatone_cascade


def _ref(x, a):
    den = np.convolve(np.convolve([1, -a], [1, -a]),
                      np.convolve([1, -a], [1, -a]))
    return lfilter([1.0], den, x.astype(np.float64))


@pytest.mark.parametrize("n,a", [(5000, 0.97), (36000, 0.991), (1024, 0.5)])
def test_cascade_matches_lfilter(n, a):
    rng = np.random.RandomState(0)
    x = rng.randn(1, n).astype(np.float32)
    ours = gammatone_cascade(torch.from_numpy(x),
                             torch.tensor([a], dtype=torch.float32)).numpy()
    assert ours.dtype == np.float32
    ref = _ref(x[0], np.float32(a))
    rel = np.abs(ours[0] - ref).max() / np.abs(ref).max()
    assert rel < 2e-5, (n, a, rel)


def test_cascade_per_row_pole():
    rng = np.random.RandomState(1)
    xs = rng.randn(4, 3000).astype(np.float32)
    aa = np.array([0.9, 0.95, 0.8, 0.99], np.float32)
    outs = gammatone_cascade(torch.from_numpy(xs), torch.from_numpy(aa))
    for i in range(4):
        ref = _ref(xs[i], float(aa[i]))
        rel = np.abs(outs[i].numpy() - ref).max() / np.abs(ref).max()
        assert rel < 2e-5, (i, rel)


def test_cascade_matches_pallas_interpret():
    import jax
    import jax.numpy as jnp
    from nelegan_tpu.ops.pallas_scan import gammatone_cascade_pallas

    rng = np.random.RandomState(2)
    xs = rng.randn(2, 3000).astype(np.float32)
    aa = np.array([0.97, 0.6], np.float32)
    f = jax.vmap(lambda v, c: gammatone_cascade_pallas(v, c, interpret=True))
    want = np.asarray(f(jnp.asarray(xs), jnp.asarray(aa)))
    got = gammatone_cascade(torch.from_numpy(xs), torch.from_numpy(aa)).numpy()
    for i in range(2):
        rel = np.abs(got[i] - want[i]).max() / np.abs(want[i]).max()
        assert rel < 2e-5, (i, rel)


def test_cascade_rejects_bad_shapes():
    with pytest.raises(ValueError):
        gammatone_cascade(torch.zeros(2, 8), torch.zeros(3))
