"""Port DSP front end (nelegan_tpu_torch.dsp) against the goldens and against
the JAX package on the same inputs."""
import numpy as np
import torch

from nelegan_tpu import dsp as jdsp
from nelegan_tpu_torch.dsp import erb, features, stft as tstft


def _t(a):
    return torch.from_numpy(np.array(a))


def test_band_energy_golden(goldens):
    g = goldens("erb")
    ours = erb.band_energy(_t(g["mag"])).numpy()
    np.testing.assert_allclose(ours, g["band_e"], rtol=1e-6, atol=1e-9)


def test_interp_band_gain_golden(goldens):
    g = goldens("erb")
    ours = erb.interp_band_gain(_t(g["gain_in"])).numpy()
    np.testing.assert_allclose(ours, g["gains"], rtol=1e-6, atol=1e-12)
    assert (ours[:, :2] == 1e-4).all() and (ours[:, -1] == 1e-2).all()


def test_featurize_speech_golden(goldens):
    g = goldens("features")
    band, mag, phase = features.featurize_speech(_t(g["clean"]))
    np.testing.assert_allclose(mag.numpy(), g["clean_mag"], rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(band.numpy(), g["clean_band"], rtol=1e-5,
                               atol=1e-8)


def test_featurize_noise_golden(goldens):
    g = goldens("features")
    band, _, _ = features.featurize_noise(_t(g["noise"]))
    np.testing.assert_allclose(band.numpy(), g["noise_band"], rtol=1e-5,
                               atol=1e-8)


def test_resynthesize_golden(goldens):
    g = goldens("features")
    r = goldens("resyn")
    wav = features.resynthesize(_t(r["alpha2"]), _t(g["clean_mag"]),
                                _t(g["clean_phase"]))
    np.testing.assert_allclose(wav.numpy(), r["wav"], rtol=1e-6, atol=1e-9)


def test_stft_istft_match_jax_f64():
    rng = np.random.RandomState(11)
    for n, center in [(16000, True), (300, True), (9000, False)]:
        x = rng.randn(2, n)
        ours = tstft.stft(_t(x), center=center).numpy()
        ref = np.asarray(jdsp.stft(x, center=center))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
        # the overlap-add sums in another order: the JAX package's own
        # istft bar against torch (tests/test_stft.py)
        back = tstft.istft(_t(ref), center=center).numpy()
        np.testing.assert_allclose(back, np.asarray(jdsp.istft(ref,
                                                               center=center)),
                                   rtol=1e-9, atol=1e-10)


def test_band_ops_match_jax_f64():
    rng = np.random.RandomState(12)
    mag = rng.rand(3, 20, 257)
    np.testing.assert_allclose(erb.band_energy(_t(mag)).numpy(),
                               np.asarray(jdsp.band_energy(mag)),
                               rtol=1e-12, atol=1e-14)
    gains = rng.rand(3, 20, 64) * 4.0
    np.testing.assert_allclose(erb.interp_band_gain(_t(gains)).numpy(),
                               np.asarray(jdsp.interp_band_gain(gains)),
                               rtol=1e-12, atol=1e-14)


def test_window_follows_frame_dtype():
    x = torch.zeros(4096, dtype=torch.float32)
    assert tstft.stft(x).dtype == torch.complex64
    assert tstft.istft(tstft.stft(x)).dtype == torch.float32


def test_asl_p56_golden_and_jax(goldens):
    from nelegan_tpu.pipeline import active_speech_level_batch as jax_asl
    from nelegan_tpu_torch.dsp.asl_p56 import asl_p56
    from nelegan_tpu_torch.pipeline import active_speech_level_batch
    g = goldens("asl_p56")
    wav = g["wav"].astype(np.float64)
    got = asl_p56(_t(wav))
    for v, name in zip(got, ("asl_msq", "actfact", "c0")):
        np.testing.assert_allclose(float(v), g[name][0], rtol=1e-6)
    # a quieter crop, a louder one and digital silence, against the JAX
    # package's batch (the same P.56 per row)
    rows = np.stack([wav, np.roll(wav, 5000) * 0.1, wav * 3.0,
                     np.zeros_like(wav)])
    want = np.asarray(jax_asl(rows))
    ours = active_speech_level_batch(rows, device="cpu").numpy()
    np.testing.assert_allclose(ours, want, rtol=1e-9)
    np.testing.assert_allclose(ours[0] ** 2, g["asl_msq"][0], rtol=1e-6)
    assert ours[3] == 1e-6                       # no activity: the floor


def test_one_pole_scan_matches_lfilter():
    from scipy.signal import lfilter
    from nelegan_tpu_torch.dsp.asl_p56 import one_pole_scan
    u = np.random.RandomState(5).rand(2, 40001)
    for n in (1, 128, 129, 40001):
        y = one_pole_scan(_t(u[:, :n]), 0.9979).numpy()
        want = lfilter([1.0], [1.0, -0.9979], u[:, :n], axis=-1)
        np.testing.assert_allclose(y, want, rtol=1e-12)


def test_mmse_estimators_match_jax_f64():
    from nelegan_tpu.dsp import mmse as jmmse
    from nelegan_tpu_torch.dsp import mmse
    rng = np.random.RandomState(0)
    nu = np.logspace(-3, 3.5, 300)
    np.testing.assert_allclose(mmse.expint_approx(_t(nu)).numpy(),
                               np.asarray(jmmse.expint_approx(nu)),
                               rtol=1e-12)
    mu = rng.randn(64, 10) + 1j * rng.randn(64, 10)
    lam = rng.rand(64, 10) * 0.1 + 0.001
    mu[0, :3] *= 100.0                       # nu past 1300: the Wiener branch
    for name in ("mmse_lsa", "mmse_psd", "mmse_stsa"):
        ours = getattr(mmse, name)(_t(mu), _t(lam)).numpy()
        want = np.asarray(getattr(jmmse, name)(mu, lam))
        np.testing.assert_allclose(ours, want, rtol=1e-10, err_msg=name)
    x, d = rng.randn(2, 4000), rng.randn(2, 4000) * 0.3
    np.testing.assert_allclose(mmse.preemphasis(_t(x)).numpy(),
                               np.asarray(jmmse.preemphasis(x)), rtol=1e-12)
    np.testing.assert_allclose(mmse.seg_snr(_t(x), _t(d)).numpy(),
                               np.asarray(jmmse.seg_snr(x, d)), rtol=1e-12)


def test_mmse_lsa_enhance_matches_jax_f64(goldens):
    """IMCRA with the enhancer's own configuration (10 warm-up frames, its
    alpha and xi_min), then the decision-directed gain recursion."""
    from nelegan_tpu.dsp import mmse as jmmse
    from nelegan_tpu_torch.dsp import mmse
    g = goldens("features")
    spec = np.asarray(jdsp.stft(g["clean"] + g["noise"]))       # [257, T]
    want = np.asarray(jmmse.mmse_lsa_enhance(spec, alpha=0.95, xi_min=0.01))
    got = mmse.mmse_lsa_enhance(_t(spec), alpha=0.95, xi_min=0.01).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_reverb_matches_jax_f64():
    from scipy.signal import lfilter
    from nelegan_tpu.dsp import reverb as jreverb
    from nelegan_tpu_torch.dsp import reverb
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8000)
    rir = rng.randn(1500) * np.exp(-np.arange(1500) / 300.0)
    ours = reverb.fir_filter(_t(rir), _t(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jreverb.fir_filter(rir, x)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ours, lfilter(rir, [1.0], x, axis=-1),
                               rtol=1e-7, atol=1e-9)
    rir[[100, 500]] = [5.0, 2.5]
    np.testing.assert_array_equal(reverb.direct_path_rir(rir),
                                  jreverb.direct_path_rir(rir))
    for v in (np.array([1.5, -1.2, 0.3]), np.array([0.5, -0.5])):
        np.testing.assert_array_equal(reverb.clip_overflow(v.copy()),
                                      jreverb.clip_overflow(v.copy()))
