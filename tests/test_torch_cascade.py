"""Port gammatone cascade (plain version, the CPU path of
nelegan_tpu_torch.ops.cascade) against lfilter and the Pallas kernel, and a
float32 emulation of the CUDA kernel's chunked scan (csrc/cascade.cu), which
runs only on the card, against both."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from nelegan_tpu_torch.ops.cascade import gammatone_cascade

_SRC = (Path(__file__).resolve().parents[1] / "nelegan_tpu_torch" / "csrc"
        / "cascade.cu").read_text()
THREADS = int(re.search(r"kThreads = (\d+);", _SRC).group(1))
SEGMENT = THREADS * int(re.search(r"kSegment = kThreads \* (\d+);",
                                  _SRC).group(1))


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


# ---------------------------------------------------------------------------
# csrc/cascade.cu's arithmetic, emulated in float32: per segment (the whole
# row up to 54272 samples), chunks of an odd length L run from zero (z), F_L
# from a unit state and its squares, the warp / block / warp scan of
# carries, and the rerun from each chunk's carry.  Vectorised over the
# kernel's threads.

def _step(c, x, a):
    c[..., 0] = x + a * c[..., 0]
    c[..., 1] = c[..., 0] + a * c[..., 1]
    c[..., 2] = c[..., 1] + a * c[..., 2]
    c[..., 3] = c[..., 2] + a * c[..., 3]


def _apply_add(f, x, z):
    """F x + z with F lower-triangular Toeplitz, first column f."""
    y = np.empty_like(x)
    y[..., 0] = z[..., 0] + f[0] * x[..., 0]
    y[..., 1] = z[..., 1] + (f[1] * x[..., 0] + f[0] * x[..., 1])
    y[..., 2] = z[..., 2] + (f[2] * x[..., 0] + f[1] * x[..., 1]
                             + f[0] * x[..., 2])
    y[..., 3] = z[..., 3] + (f[3] * x[..., 0] + f[2] * x[..., 1]
                             + f[1] * x[..., 2] + f[0] * x[..., 3])
    return y


def _warp_scan(v, pw):
    """Inclusive Hillis-Steele scan over the last-but-one axis (32 lanes)."""
    v = v.copy()
    for d in range(5):
        s = 1 << d
        v[..., s:, :] = _apply_add(pw[d], v[..., :-s, :], v[..., s:, :])
    return v


def chunk_length(n_segment: int) -> int:
    """The kernel's L for a segment of n samples: odd, 1024 chunks or
    fewer."""
    return -(-n_segment // THREADS) | 1


def chunked_cascade_f32(x: np.ndarray, a: float) -> np.ndarray:
    x = x.astype(np.float32)
    a = np.float32(a)
    y = np.empty_like(x)
    seg = np.zeros(4, np.float32)
    zero = np.zeros(4, np.float32)
    for s0 in range(0, x.size, SEGMENT):
        xs = x[s0:s0 + SEGMENT]
        L = chunk_length(xs.size)
        nch = -(-xs.size // L)
        f = np.array([1, 0, 0, 0], np.float32)
        for _ in range(L):
            _step(f, np.float32(0), a)
        pw = [f]
        for _ in range(9):
            pw.append(_apply_add(pw[-1], pw[-1], zero))
        xc = np.zeros(THREADS * L, np.float32)
        xc[:xs.size] = xs
        xc = xc.reshape(THREADS, L)
        valid = (np.arange(THREADS * L) < xs.size).reshape(THREADS, L)

        def run(c, out=None):
            for j in range(L):
                nxt = c.copy()
                _step(nxt, xc[:, j], a)
                c = np.where(valid[:, j:j + 1], nxt, c)
                if out is not None:
                    out[:, j] = c[:, 3]
            return c

        z = run(np.zeros((THREADS, 4), np.float32))
        warps = z.reshape(THREADS // 32, 32, 4)
        tot = _warp_scan(warps, pw)[:, 31].copy()
        tot[0] = _apply_add(pw[5], seg, tot[0])
        tot = _warp_scan(tot, pw[5:])
        cw = np.concatenate([seg[None], tot[:-1]])
        zz = warps.copy()
        zz[:, 0] = _apply_add(pw[0], cw, zz[:, 0])
        out = _warp_scan(zz, pw)
        cin = np.concatenate([cw[:, None], out[:, :-1]], 1).reshape(THREADS, 4)
        yc = np.zeros((THREADS, L), np.float32)
        c = run(cin, yc)
        y[s0:s0 + xs.size] = yc.reshape(-1)[:xs.size]
        seg = c[nch - 1].copy()
    return y


def test_kernel_chunk_length_is_odd_and_fits():
    """At n = 36000 a thread takes 37 samples: odd, so a warp's reads of
    smem[c*L + j] fall on 32 banks, and 1024 chunks cover the row."""
    assert chunk_length(36000) == 37
    for n in (1, 1024, 36000, 36001, SEGMENT - 1, SEGMENT):
        L = chunk_length(n)
        assert L % 2 == 1 and THREADS * L >= n and L <= SEGMENT // THREADS


@pytest.mark.parametrize("n,a", [(36000, 0.5), (36000, 0.97), (36000, 0.991),
                                 (36001, 0.991), (100000, 0.991),
                                 (100000, 0.5), (250000, 0.991), (1, 0.991),
                                 (1024, 0.991)])
def test_kernel_chunked_scan_emulation_matches_lfilter(n, a):
    x = np.random.RandomState(7).randn(n).astype(np.float32)
    got = chunked_cascade_f32(x, a)
    ref = _ref(x, np.float32(a))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 2e-5, (n, a, rel)


def test_kernel_chunked_scan_emulation_matches_pallas_interpret():
    import jax
    import jax.numpy as jnp
    from nelegan_tpu.ops.pallas_scan import gammatone_cascade_pallas

    xs = np.random.RandomState(8).randn(3, 3000).astype(np.float32)
    aa = np.array([0.5, 0.97, 0.991], np.float32)
    f = jax.vmap(lambda v, c: gammatone_cascade_pallas(v, c, interpret=True))
    want = np.asarray(f(jnp.asarray(xs), jnp.asarray(aa)))
    for i in range(3):
        got = chunked_cascade_f32(xs[i], aa[i])
        rel = np.abs(got - want[i]).max() / np.abs(want[i]).max()
        assert rel < 2e-5, (aa[i], rel)
