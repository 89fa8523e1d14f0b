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
