"""The port's HASPI v1/v2, HASQI v2 and ear model against the committed
goldens (captured from the reference), at the JAX package's own bars
(tests/test_haspi.py), with no JAX: the deterministic mode, the seeded
noise mode by its statistics, the clean-side split, padded rows, and the
middle ear's scan form against its spectral fold."""
import numpy as np
import pytest
import torch

from nelegan_tpu_torch.metrics.haspi import (haspi_v1_24k, haspi_v2_24k,
                                             haspi_v2_clean_24k,
                                             haspi_v2_from_clean_24k,
                                             hasqi_v2_24k)
from nelegan_tpu_torch.metrics.haspi import chains
from nelegan_tpu_torch.metrics.haspi.ear_model import (
    ear_model, middle_ear, middle_ear_response, nalr_fir)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(mine, ref):
    return np.abs(np.asarray(mine) - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads: the CPU time of more is not repaid in wall time
    at these sizes, and the test run shares its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scores(goldens):
    return goldens("haspi_scores")


@pytest.fixture(scope="module")
def ear(scores):
    """The ear model of the haspi_scores signals, deterministic."""
    return ear_model(_t(scores["x24"]), _t(scores["y24"]))


def test_ear_model_golden(goldens):
    g = goldens("ear_model")
    out = ear_model(_t(g["x24"]), _t(g["y24"]))
    for mine, key in [(out.xdb, "xdB"), (out.ydb, "ydB"), (out.xbm, "xBM"),
                      (out.ybm, "yBM")]:
        assert _rel(mine, g[key]) < 1e-6, key      # goldens stored f32
    np.testing.assert_allclose(out.xsl.numpy(), g["xSL"], rtol=1e-6,
                               atol=1e-6)


def test_ear_model_hl_golden(goldens):
    g = goldens("ear_model_hl")
    out = ear_model(_t(g["x24"]), _t(g["y24"]), hl=_t(g["hl"]))
    for mine, key in [(out.xdb, "xdB"), (out.ydb, "ydB"), (out.ybm, "yBM")]:
        assert _rel(mine, g[key]) < 1e-6, key
    np.testing.assert_allclose(out.xsl.numpy(), g["xSL"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(out.ysl.numpy(), g["ySL"], rtol=1e-6,
                               atol=1e-6)
    v2, avecm = haspi_v2_24k(_t(g["x24"]), _t(g["y24"]), hl=_t(g["hl"]))
    np.testing.assert_allclose(float(v2), float(g["haspi_v2"]), rtol=1e-7)
    np.testing.assert_allclose(avecm.numpy(), g["haspi_v2_raw"], rtol=1e-6,
                               atol=1e-8)


def test_haspi_scores_golden(scores):
    x, y = _t(scores["x24"]), _t(scores["y24"])
    v2, avecm = haspi_v2_24k(x, y)
    np.testing.assert_allclose(float(v2), float(scores["haspi_v2"]),
                               rtol=1e-7)
    np.testing.assert_allclose(avecm.numpy(), scores["haspi_v2_raw"],
                               rtol=1e-6, atol=1e-8)
    v1, raw = haspi_v1_24k(x, y)
    np.testing.assert_allclose(float(v1), float(scores["haspi_v1"]),
                               rtol=1e-6)
    np.testing.assert_allclose(raw.numpy(), scores["haspi_v1_raw"],
                               rtol=1e-6, atol=1e-8)
    q, _, _, qraw = hasqi_v2_24k(x, y)
    np.testing.assert_allclose(float(q), float(scores["hasqi_v2"]),
                               rtol=1e-6)
    np.testing.assert_allclose(qraw.numpy(), scores["hasqi_raw"], rtol=1e-6,
                               atol=1e-8)


def test_haspi_v2_chain_golden(goldens, ear):
    """The v2 chain's stages: 2560 Hz envelopes, compacted cepstra and the
    modulation correlations."""
    g = goldens("haspi_v2_chain")
    xlp, ylp = chains.env_filt(ear.xdb, ear.ydb)
    assert _rel(xlp, g["xLP"]) < 1e-6 and _rel(ylp, g["yLP"]) < 1e-6
    xcep, ycep, count = chains.cep_coef(xlp, ylp)
    k = int(count)
    assert k == g["xcep"].shape[0]
    assert _rel(xcep[:k], g["xcep"]) < 1e-6 and _rel(ycep[:k],
                                                     g["ycep"]) < 1e-6
    assert float(xcep[k:].abs().max()) == 0.0
    np.testing.assert_allclose(chains.mod_filt_corr(xcep, ycep,
                                                    count).numpy(),
                               g["avecm"], rtol=1e-6, atol=1e-8)


def test_haspi_v2_f32(scores):
    """float32: the JAX package's bar against the golden (2e-3), and the
    port's own float32 against its float64 within 5e-5 relative."""
    v2, _ = haspi_v2_24k(_t(scores["x24"].astype(np.float32)),
                         _t(scores["y24"].astype(np.float32)))
    assert v2.dtype == torch.float32
    assert abs(float(v2) - float(scores["haspi_v2"])) < 2e-3
    assert abs(float(v2) / float(scores["haspi_v2"]) - 1.0) < 5e-5


def test_noise_mode_statistics(scores, ear):
    """The stochastic mode draws from a torch.Generator: the BM noise has
    the reference's level, 10^((-10 - 65) / 20), zero mean, and the same
    seed repeats it; HASPI (BM noise and cepstral dither) moves by less
    than the JAX package's 0.05."""
    x, y = _t(scores["x24"]), _t(scores["y24"])
    gn = 10.0 ** ((-10.0 - 65.0) / 20.0)
    out = ear_model(x, y, generator=torch.Generator().manual_seed(1),
                    noise_scale=1.0)
    assert torch.equal(out.xdb, ear.xdb)            # noise reaches BM only
    for noisy, clean in ((out.xbm, ear.xbm), (out.ybm, ear.ybm)):
        d = (noisy - clean)[noisy != clean]         # past the delay heads
        assert d.numel() > 0.9 * clean.numel()
        assert abs(float(d.std()) / gn - 1.0) < 0.01
        assert abs(float(d.mean())) < 0.01 * gn
    xs, ys = x[:12000], y[:12000]
    det = float(haspi_v2_24k(xs, ys)[0])
    a, b, c = (float(haspi_v2_24k(xs, ys, noise_scale=1.0,
                                  generator=torch.Generator().manual_seed(k)
                                  )[0]) for k in (1, 2, 1))
    assert a != b and a == c
    assert abs(a - det) < 0.05


def test_clean_side_split_and_padded_rows(scores):
    """haspi_v2_clean_24k + haspi_v2_from_clean_24k equal the pair path
    (float64 round-off, 1e-12), also for a batch of padded rows; a padded
    row scores as its trimmed signal within the JAX package's bucketed bar
    (5e-3: the padded run transforms at another FFT length)."""
    x, y = scores["x24"][:20000], scores["y24"][:20000]
    pair, _ = haspi_v2_24k(_t(x), _t(y))
    split, _ = haspi_v2_from_clean_24k(_t(y), haspi_v2_clean_24k(_t(x)))
    assert abs(float(split) - float(pair)) < 1e-12 * abs(float(pair))
    lens = [20000, 15001]
    xp = np.zeros((2, 24576))
    yp = np.zeros((2, 24576))
    for j, m in enumerate(lens):
        xp[j, :m], yp[j, :m] = x[:m], y[:m]
    nv = torch.tensor(lens)
    pad, _ = haspi_v2_24k(_t(xp), _t(yp), n_valid=nv)
    cache = haspi_v2_clean_24k(_t(xp), n_valid=nv)
    pad_split, _ = haspi_v2_from_clean_24k(_t(yp), cache, n_valid=nv)
    np.testing.assert_allclose(pad_split.numpy(), pad.numpy(), rtol=1e-12)
    for j, m in enumerate(lens):
        trimmed = float(haspi_v2_24k(_t(x[:m]), _t(y[:m]))[0])
        assert abs(float(pad[j]) - trimmed) < 5e-3 * max(abs(trimmed), 1.0)


def test_middle_ear_scan_against_golden_and_fold(goldens):
    """The scan-form middle ear (FIR, one-pole, biquad through ops/iir's
    linrec) against the reference's middle-ear output, and against the
    closed-form response the ear model folds into its spectrum."""
    g = goldens("ear_components")
    x = _t(g["x24"][:12000])                 # causal: a prefix suffices
    mid = middle_ear(x)
    assert _rel(mid, g["mid"][:12000]) < 1e-10
    m = 16384                       # >= n + the biquad's decay to 1e-16
    fold = torch.fft.ifft(torch.fft.fft(x.to(torch.complex128), m)
                          * middle_ear_response(m))[:x.shape[0]].real
    assert _rel(mid, fold.numpy()) < 1e-9


def test_nalr_fir_and_itype1():
    """NAL-R (Kates' eb_NALR; the reference's own is a stub): linear phase,
    the prescription at the audiometric frequencies, a pure delay at zero
    loss; the itype=1 path runs and moves the score."""
    hl = np.array([30.0, 30.0, 40.0, 50.0, 60.0, 65.0])
    taps = nalr_fir(_t(hl)).numpy()
    assert taps.shape == (141,)
    np.testing.assert_allclose(taps, taps[::-1], atol=1e-4)
    x = 0.05 * (hl[1] + hl[2] + hl[3])
    want = np.maximum(x + 0.31 * hl
                      + np.array([-17.0, -8.0, 1.0, -1.0, -2.0, -2.0]), 0.0)
    freqs = np.array([250.0, 500.0, 1000.0, 2000.0, 4000.0, 6000.0])
    resp = [np.abs(np.sum(taps * np.exp(-2j * np.pi * f / 24000.0)
                          ** np.arange(141))) for f in freqs]
    np.testing.assert_allclose(20.0 * np.log10(resp), want, atol=2.0)
    t0 = nalr_fir(torch.zeros(6, dtype=torch.float64)).numpy()
    assert t0[70] == 1.0 and np.abs(np.delete(t0, 70)).max() == 0.0
    rng = np.random.RandomState(0)
    xs = rng.randn(12000) * 0.1
    ys = xs + rng.randn(12000) * 0.02
    v_plain, _ = haspi_v2_24k(_t(xs), _t(ys), hl=_t(hl))
    v_nalr, _ = haspi_v2_24k(_t(xs), _t(ys), hl=_t(hl), itype=1)
    assert np.isfinite(float(v_plain)) and np.isfinite(float(v_nalr))
    assert float(v_plain) != float(v_nalr)
