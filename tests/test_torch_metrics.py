"""The port's metric slice (resampling, ESTOI, SIIB, calibration, scoring)
against the JAX package's on seeded 1-s triples, float64 on the CPU, and
the port's float32 against float64; the config and device repairs; the
five metrics through score_pair and score_corpus."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import lapack
import torch

from nelegan_tpu.config import Config as JaxConfig
from nelegan_tpu.config import MetricCalibration as JaxCalibration
from nelegan_tpu.config import config_to_dict as jax_config_to_dict
from nelegan_tpu.dsp.resample import resample_poly as jax_resample_poly
from nelegan_tpu.metrics import _metric_programs as jax_metric_programs
from nelegan_tpu.metrics import score_batch as jax_score_batch
from nelegan_tpu.metrics.calibrate import make_mappers_np as jax_mappers_np
from nelegan_tpu_torch import metrics
from nelegan_tpu_torch.config import MetricCalibration, config_from_dict
from nelegan_tpu_torch.dsp import imcra
from nelegan_tpu_torch.dsp.resample import resample_poly
from nelegan_tpu_torch.metrics import calibrate
from nelegan_tpu_torch.metrics.clean_pool import CleanSidePool
from nelegan_tpu_torch.parallel import launch

jestoi = importlib.import_module("nelegan_tpu.metrics.estoi")
jsiib = importlib.import_module("nelegan_tpu.metrics.siib")
estoi = importlib.import_module("nelegan_tpu_torch.metrics.estoi")
siib = importlib.import_module("nelegan_tpu_torch.metrics.siib")
METRICS = ("siib", "haspi", "estoi")
# The port's float32 against float64 (its own, on the CPU), relative: the
# float32 front ends' round-off; ESTOI's and SIIB's cores run in float64
# from their normalisation on, as the JAX package's do under x64.
F32_BARS = {"estoi": 1e-6, "siib": 1e-4, "haspi": 5e-5}
# The port against the JAX package at float64, relative: ESTOI and HASPI
# to their float64 round-off; SIIB to its KLT's, as the two packages take
# the eigenvectors of a tiled utterance's nearly rank-deficient covariance
# from two LAPACK routines (LAPACK's own routines disagree by 4e-9 on an
# untiled one, more with tiling).
JAX_BARS = {"estoi": 1e-9, "siib": 1e-5, "haspi": 1e-6}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads: more cost CPU time that these sizes do not repay
    in wall time, and the test run shares its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def triples(goldens):
    """Two seeded 1-s triples at 16 kHz, float64: one clean crop (so SIIB
    tiles both alike and the JAX package compiles each metric once), two
    noises and enhancements."""
    g = goldens("features")
    clean = g["clean"].astype(np.float64)
    noise = g["noise"].astype(np.float64)
    rng = np.random.RandomState(0)
    c = clean[4000:20000]
    out = []
    for k in range(2):
        o = int(rng.randint(0, noise.size - 16000))
        n = noise[o:o + 16000] * rng.uniform(0.3, 1.0)
        out.append((c, n, c * rng.uniform(0.6, 1.4)))
    return out


@pytest.fixture(scope="module")
def jax_scores(triples):
    """The JAX package's score_batch of both triples, raw (one compiled
    program per metric)."""
    return jax_score_batch(*zip(*triples), norm=False, metrics=METRICS)


def test_config_calib_survives_and_drives_the_mappers():
    """A JAX config with a non-default calibration keeps it through the
    port's config_from_dict (which dropped it), and the port's mappers
    then use it."""
    calib = JaxCalibration(siib=(-0.1, 20.0), haspi=(-1.2, 2.0),
                           estoi=(-6.0, 0.4))
    d = jax_config_to_dict(dataclasses.replace(JaxConfig(), calib=calib))
    cfg = config_from_dict(d)
    assert cfg.calib == MetricCalibration(siib=(-0.1, 20.0),
                                          haspi=(-1.2, 2.0),
                                          estoi=(-6.0, 0.4))
    assert config_from_dict({}).calib == MetricCalibration()
    want = jax_mappers_np(calib)
    x = np.array([0.1, 1.5, 25.0])
    for name, fn in calibrate.make_mappers(cfg.calib).items():
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                                   want[name](x), rtol=1e-15)
    for name, fn in calibrate.make_mappers_np(cfg.calib).items():
        np.testing.assert_allclose(fn(x), want[name](x), rtol=1e-15)
    default = calibrate.make_mappers_np()["siib"](x)
    assert not np.allclose(default, want["siib"](x))


def test_imcra_init_defaults_to_cuda(monkeypatch):
    """imcra_init's device=None means CUDA, as every port entry point's
    does, and raises without it (it built CPU state)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        imcra.imcra_init(3, torch.float32)
    st = imcra.imcra_init(3, torch.float32, device="cpu")
    assert st.lam.device == torch.device("cpu")


@pytest.mark.parametrize("up,down", [(5, 8), (3, 2)])
def test_resample_poly_matches_jax(up, down):
    x = np.random.RandomState(up).randn(2, 16000)
    want = np.asarray(jax_resample_poly(jnp.asarray(x), up, down))
    got = resample_poly(torch.from_numpy(x), up, down).numpy()
    assert got.shape == want.shape == (2, -(-16000 * up // down))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    got32 = resample_poly(torch.from_numpy(x.astype(np.float32)), up,
                          down).numpy()
    assert got32.dtype == np.float32
    assert np.abs(got32 - want).max() < 1e-5 * np.abs(want).max()


def test_estoi_matches_jax(triples):
    c, n, e = triples[0]
    want = float(jestoi.estoi(c, e + n))
    got = estoi.estoi(torch.from_numpy(c), torch.from_numpy(e + n))
    assert got.dtype == torch.float64
    assert abs(float(got) - want) < JAX_BARS["estoi"] * abs(want)
    got32 = estoi.estoi(torch.from_numpy(c.astype(np.float32)),
                        torch.from_numpy((e + n).astype(np.float32)))
    assert abs(float(got32) - want) < F32_BARS["estoi"] * abs(want)


def test_siib_matches_jax(triples):
    c, n, e = triples[1]
    want = float(jsiib.siib(c, e + n))
    got = float(siib.siib(c, e + n, device="cpu"))
    assert abs(got - want) < JAX_BARS["siib"] * abs(want)
    got32 = float(siib.siib(c.astype(np.float32), (e + n).astype(np.float32),
                            device="cpu"))
    assert abs(got32 - want) < F32_BARS["siib"] * abs(want)


def test_padded_rows_score_as_trimmed(triples):
    """ESTOI and SIIB of a batch of zero-padded rows with n_valid equal
    each trimmed signal's score."""
    c, n, e = triples[0]
    lens = [16000, 12345, 9000]
    x = np.zeros((3, 16000))
    y = np.zeros((3, 16000))
    for j, m in enumerate(lens):
        x[j, :m], y[j, :m] = c[:m], (e + n)[:m]
    nv = torch.tensor(lens)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    pad_e = estoi.estoi(xt, yt, n_valid=nv)
    pad_s = siib.siib_gauss_16k(xt, yt, nv)
    for j, m in enumerate(lens):
        cx, cy = torch.from_numpy(c[:m]), torch.from_numpy((e + n)[:m])
        assert abs(float(pad_e[j]) - float(estoi.estoi(cx, cy))) < 1e-12
        want = float(siib.siib_gauss_16k(cx, cy))
        assert abs(float(pad_s[j]) - want) < 1e-9 * abs(want)


def test_clean_side_split_equals_pair_path(triples):
    c, n, e = triples[0]
    x = resample_poly(torch.from_numpy(c), 5, 8)
    y = resample_poly(torch.from_numpy(e + n), 5, 8)
    nv = torch.tensor(x.shape[-1])
    half = estoi.estoi_clean_10k(x, nv)
    assert float(estoi.estoi_from_clean_10k(y, half, nv)) == float(
        estoi.estoi_10k(x, y, nv))
    xs, ys = torch.from_numpy(c), torch.from_numpy(e + n)
    u = siib.siib_klt_16k(xs)
    assert float(siib.siib_gauss_16k_with_klt(xs, ys, None, u)) == float(
        siib.siib_gauss_16k(xs, ys))


def test_siib_capacity_ignores_eigenvector_sign_and_null_rotation(
        triples):
    """The KLT's eigenvectors are fixed only up to sign, and inside a
    degenerate eigenspace up to a rotation.  Flipping signs leaves the
    capacity bit-equal.  An untiled 1-s utterance has 64 stacked vectors
    in 600 dimensions, so most eigenvalues are round-off: rotating that
    null space, or taking another LAPACK routine's eigenvectors, moves the
    capacity by eigh's own round-off (syevr, syevd and syev against torch:
    at most 4.2e-9 relative), bar 1e-8 relative at float64."""
    c, n, e = triples[0]
    vx, vy, scnt = siib._stack_pair(torch.from_numpy(c)[None],
                                    torch.from_numpy(e + n)[None], None)
    cov = (vx[0].T @ vx[0]) / scnt[0]
    lam, u = torch.linalg.eigh(cov)
    base = float(siib._capacity(vx, vy, u[None])[0])
    rng = np.random.RandomState(3)
    signs = torch.from_numpy(rng.choice([-1.0, 1.0], 600))
    assert float(siib._capacity(vx, vy, (u * signs)[None])[0]) == base
    null = (lam < 1e-10 * lam.max()).numpy()
    assert null.sum() >= 500
    q, _ = np.linalg.qr(rng.randn(null.sum(), null.sum()))
    u_rot = u.clone()
    u_rot[:, null] = u[:, null] @ torch.from_numpy(q)
    rot = float(siib._capacity(vx, vy, u_rot[None])[0])
    assert abs(rot - base) < 1e-8 * abs(base)
    c = cov.numpy()
    for name, u_l in (("syevr", lapack.dsyevr(c)[1]),
                      ("syevd", lapack.dsyevd(c)[1]),
                      ("syev", lapack.dsyev(c)[1])):
        other = float(siib._capacity(vx, vy, torch.from_numpy(u_l)[None])[0])
        assert abs(other - base) < 1e-8 * abs(base), name


def test_score_batch_matches_jax(triples, jax_scores):
    """The whole slice: the port's score_batch of SIIB, HASPI and ESTOI
    against the JAX package's, raw, float64.  The JAX package returns its
    scores as float32 (6e-8 relative), and SIIB's KLT comes from another
    LAPACK routine (JAX_BARS); the calibrated form (norm=True) too."""
    got = metrics.score_batch(*zip(*triples), norm=False, metrics=METRICS,
                              device="cpu")
    for g, w in zip(got, jax_scores):
        assert g.keys() == w.keys() == set(METRICS)
        for m in METRICS:
            bar = max(JAX_BARS[m], 2.0 ** -23)       # float32's rounding
            assert abs(g[m] - w[m]) < bar * abs(w[m]), (m, g[m], w[m])
    normed = metrics.score_batch(*zip(*triples[:1]), metrics=("estoi",),
                                 device="cpu")[0]
    want = float(jax_mappers_np()["estoi"](jax_scores[0]["estoi"]))
    assert abs(normed["estoi"] - want) < 1e-6
    # float32 signals: within the float32 bars of the float64 scores
    got32 = metrics.score_batch(*zip(*[tuple(v.astype(np.float32) for v in t)
                                       for t in triples[1:]]),
                                norm=False, metrics=METRICS, device="cpu")
    for g, w in zip(got32, got[1:]):
        for m in METRICS:
            assert abs(g[m] - w[m]) < F32_BARS[m] * abs(w[m]), (m, g, w)


def test_score_corpus_matches_score_batch(triples):
    """Bucketed scoring (zero-padded rows, n_valid, SIIB tiled on the
    device) against per-triple scoring, at the JAX package's bars
    (tests/test_metrics_bucketed.py); the clean-side cache's warm hit
    equals its cold fill and the pair path."""
    c, n, e = triples[0]
    lens = (16000, 9001)
    trip = [(c[:m], n[:m], e[:m]) for m in lens]
    exact = metrics.score_batch(*zip(*trip), norm=False, metrics=METRICS,
                                device="cpu")
    bucketed = metrics.score_corpus(*zip(*trip), norm=False, metrics=METRICS,
                                    device="cpu")
    for ex, bu in zip(exact, bucketed):
        for m in ("estoi", "haspi"):
            tol = 5e-3 if m == "haspi" else 1e-3
            assert abs(ex[m] - bu[m]) < tol * max(abs(ex[m]), 1.0), m
        assert abs(ex["siib"] - bu["siib"]) < 0.05 * max(ex["siib"], 10.0)
    cache = {}
    keys = ["a", "b"]
    cold = metrics.score_corpus(*zip(*trip), norm=False, metrics=METRICS,
                                device="cpu", clean_cache=cache,
                                clean_keys=keys)
    key = (16384,) + tuple((k, m) for k, m in zip(keys, lens))
    assert {k[0] for k in cache} == {"estoi-clean", "haspi-clean",
                                     "siib-klt", "siib-vad"}
    assert ("estoi-clean",) + key in cache
    assert ("siib-vad", "a", 16000) in cache
    warm = metrics.score_corpus(*zip(*trip), norm=False, metrics=METRICS,
                                device="cpu", clean_cache=cache,
                                clean_keys=keys)
    assert warm == cold
    for w, b in zip(warm, bucketed):
        assert w["estoi"] == b["estoi"] and w["siib"] == b["siib"]
        assert abs(w["haspi"] - b["haspi"]) < 1e-9 * abs(b["haspi"])


def test_unported_metrics_and_options_raise(triples):
    """PESQ and ViSQOL, a CleanSidePool, enhanced_keys and a mesh, which
    raised before they were ported, now score: score_pair gives the metric
    functions' raw values on (clean, enhanced), the pool and the enhanced
    keys leave score_corpus's scores as they are, and so does a mesh of an
    in-process world of one rank, bit for bit (tests/test_torch_parallel.py
    holds a world of two)."""
    c, n, e = (x[:8000] for x in triples[0])
    got = metrics.score_pair(c, n, e, norm=False, metrics=("pesq", "visqol"),
                             device="cpu")
    want = {"pesq": metrics.pesq_p862(torch.from_numpy(c),
                                      torch.from_numpy(e)),
            "visqol": metrics.visqol_speech(torch.from_numpy(c),
                                            torch.from_numpy(e))}
    assert got == {k: float(v) for k, v in want.items()}
    assert metrics.pesq_proxy is metrics.pesq_p862
    assert metrics.visqol_proxy_16k is metrics.visqol_speech_16k
    kw = dict(norm=False, metrics=("estoi", "pesq"), device="cpu")
    base = metrics.score_corpus([c], [n], [e], **kw)
    with launch.world_of_one("gloo", "cpu") as mesh:
        assert metrics.score_corpus([c], [n], [e], mesh=mesh, **kw) == base
    assert metrics.score_corpus([c], [n], [e], enhanced_keys=["x"],
                                **kw) == base
    assert metrics.score_corpus([c], [n], [e], clean_keys=["a"],
                                clean_cache=CleanSidePool(), **kw) == base


def test_score_corpus_matches_jax(triples, jax_scores):
    """score_corpus of all five metrics against the JAX package, float64:
    the two triples as bucketed rows of their own length against its
    score_batch (the intelligibility metrics, at JAX_BARS); PESQ and
    ViSQOL on zero-padded rows of 16000 and 9001 samples against its
    score_corpus programs on the same rows, within 1e-9."""
    got = metrics.score_corpus(*zip(*triples), norm=False,
                               bucket_quant=16000, device="cpu")
    for g, w in zip(got, jax_scores):
        assert set(g) == set(metrics.ALL_METRICS)
        for m in METRICS:
            bar = max(JAX_BARS[m], 2.0 ** -23)       # float32's rounding
            assert abs(g[m] - w[m]) < bar * abs(w[m]), (m, g[m], w[m])
    c, n, e = triples[1]
    lens = (16000, 9001)
    ref, enh = np.zeros((2, 16384)), np.zeros((2, 16384))
    for j, m in enumerate(lens):
        ref[j, :m], enh[j, :m] = c[:m], e[:m]
    got = metrics.score_corpus([c[:m] for m in lens], [n[:m] for m in lens],
                               [e[:m] for m in lens], norm=False,
                               metrics=("pesq", "visqol"), device="cpu")
    progs = jax_metric_programs()
    for m in ("pesq", "visqol"):
        want = np.asarray(progs[m](jnp.asarray(ref), jnp.asarray(enh),
                                   jnp.asarray(np.array(lens))))
        for j in range(2):
            assert abs(got[j][m] - want[j]) < 1e-9 * abs(want[j]), (m, j)


def test_siib_of_a_trainer_file_alone_or_beside_its_degraded_signal(
        tmp_path):
    """The calibrated SIIB of chip_smoke.py's pre-enhanced utterance tr03
    (its trainer corpus, seed 13: 14975 samples, PCM16, float32), scored
    with its KLT taken alone (a fresh CleanSidePool: a miss) and beside the
    degraded signal (no pool), by both packages on the CPU.  On the card a
    float32 front end scored it 1.7e-3 apart between the two; here the JAX
    package gives one value both ways (its float32 front end), and the
    port's float64 front end is within JAX_BARS of it (measured 3.2e-9)."""
    from chip_smoke import write_trainer_corpus
    from nelegan_tpu.metrics import score_corpus as jax_score_corpus
    from nelegan_tpu.metrics.clean_pool import CleanSidePool as JaxPool
    from nelegan_tpu_torch.data.wavio import read_wav

    write_trainer_corpus(str(tmp_path), 4, 0, seed=13)
    name = "tr03#Cafeteria#3.wav"
    c, n, e = (read_wav(str(tmp_path / "Train" / d / name))[0]
               for d in ("Clean", "Noise", "MultiEnh"))
    kw = dict(metrics=("siib",))
    got = {"beside": metrics.score_corpus([c], [n], [e], device="cpu", **kw),
           "alone": metrics.score_corpus([c], [n], [e], device="cpu",
                                         clean_cache=CleanSidePool(),
                                         clean_keys=[name], **kw)}
    want = {"beside": jax_score_corpus([c], [n], [e], **kw),
            "alone": jax_score_corpus([c], [n], [e], clean_cache=JaxPool(),
                                      clean_keys=[name], **kw)}
    assert want["alone"] == want["beside"]
    assert got["alone"] == got["beside"]
    g, w = got["alone"][0]["siib"], want["alone"][0]["siib"]
    assert abs(g - w) < JAX_BARS["siib"] * abs(w), (g, w)
