"""Port batched enhancement (nelegan_tpu_torch.pipeline) against the JAX
pipeline on the same utterances and the same generator parameters."""
import copy

import jax
import numpy as np
import pytest
import torch

from nelegan_tpu import pipeline as jpipe
from nelegan_tpu.config import ModelConfig
from nelegan_tpu.models.generator import Generator as JaxGenerator
from nelegan_tpu_torch import pipeline as tpipe
from nelegan_tpu_torch.models.convert import generator_state_dict_from_jax
from nelegan_tpu_torch.models.generator import Generator

HIDDEN, BLOCKS = 32, 3


@pytest.fixture(scope="module")
def generators():
    z = np.zeros((1, 4, 64), np.float32)
    params = JaxGenerator(hidden=HIDDEN, n_blocks=BLOCKS).init(
        jax.random.PRNGKey(0), z, z)["params"]
    tg = Generator(hidden=HIDDEN, n_blocks=BLOCKS)
    tg.load_state_dict(generator_state_dict_from_jax(params), strict=True)
    return params, tg.eval()


@pytest.fixture(scope="module")
def utterances(goldens):
    """The golden speech and two seeded crops of it, of different lengths."""
    g = goldens("features")
    clean, noise = g["clean"].astype(np.float32), g["noise"].astype(np.float32)
    rng = np.random.RandomState(5)
    out = [(clean, noise)]
    for n in (20000, 27137):
        o = rng.randint(0, len(clean) - n)
        out.append((clean[o:o + n], noise[o:o + n]))
    return out


def _pcm16(x):
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def _jax_run(params, cp, npd, lens):
    feats = jpipe.featurize_batch(cp, npd, lens)
    mc = ModelConfig(gen_hidden=HIDDEN, gen_blocks=BLOCKS)
    wav, _, out_len = jpipe.enhance_batch(params, feats, model_cfg=mc)
    return feats, np.asarray(wav), np.asarray(out_len)


# Bands are held at rtol 1e-5.  In float32 the quiet high bands also carry
# the FFT's round-off of each frame's loudest bins (|X| errors ~1e-6 where
# the peak is ~16), which the absolute term admits; float64 has no such term.
@pytest.mark.parametrize("kind,atol", [("f64", 1e-10), ("f32", 5e-6),
                                       ("int16", 5e-6)])
def test_enhance_batch_matches_jax(generators, utterances, kind, atol):
    params, tg = generators
    cleans = [c for c, _ in utterances]
    noises = [n for _, n in utterances]
    if kind == "int16":
        cleans, noises = map(lambda ws: [_pcm16(w) for w in ws],
                             (cleans, noises))
    cp, lens = tpipe.reflect_pad_batch(cleans)
    npd, _ = tpipe.reflect_pad_batch(noises)
    assert cp.dtype == (np.int16 if kind == "int16" else np.float32)
    if kind == "f64":
        cp, npd = cp.astype(np.float64), npd.astype(np.float64)
        tg = copy.deepcopy(tg).double()

    jf, jwav, jlen = _jax_run(params, cp, npd, lens)
    with torch.no_grad():
        tf = tpipe.featurize_batch(cp, npd, lens, device="cpu")
        twav, _, tlen = tpipe.enhance_batch(tg, tf, device="cpu")
    assert twav.dtype == (torch.float64 if kind == "f64" else torch.float32)

    np.testing.assert_array_equal(tlen.numpy(), jlen)
    np.testing.assert_array_equal(tf.frames.numpy(), np.asarray(jf.frames))
    for i, n in enumerate(lens):
        t = 1 + n // 256   # frames past an utterance's count are masked
        for name in ("clean_band", "noise_band"):
            np.testing.assert_allclose(
                getattr(tf, name)[i, :t].numpy(),
                np.asarray(getattr(jf, name))[i, :t], rtol=1e-5, atol=atol,
                err_msg=name)
    q_t = tpipe.pcm16_quantize_i16(twav).numpy().astype(np.int32)
    q_j = np.asarray(jpipe.pcm16_quantize_i16(jwav)).astype(np.int32)
    diff = np.abs(q_t - q_j)
    n_diff = int((diff > 0).sum())
    print(f"PCM16 samples differing from JAX: {n_diff} of {diff.size}, "
          f"max {diff.max()} LSB")
    assert diff.max() <= 1
    assert n_diff < 1e-3 * diff.size
    for i, m in enumerate(tlen.numpy()):
        assert np.abs(twav[i, m:].numpy()).max(initial=0.0) == 0.0
        rms = np.sqrt(np.mean(twav[i, :m].numpy().astype(np.float64) ** 2))
        assert abs(rms - 0.03) < 1e-6


def test_pcm16_quantize_ties_round_away_from_zero():
    w = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 32766.5, -32767.5,
                      40000.0, -40000.0], dtype=torch.float32) / 32768.0
    want = np.array([1, -1, 2, -2, 3, -3, 32767, -32768, 32767, -32768])
    np.testing.assert_array_equal(tpipe.pcm16_quantize_i16(w).numpy(), want)
    np.testing.assert_array_equal(tpipe.pcm16_quantize(w).numpy(),
                                  (want / 32768.0).astype(np.float32))
    np.testing.assert_array_equal(tpipe.pcm16_quantize_i16(w).numpy(),
                                  np.asarray(jpipe.pcm16_quantize_i16(
                                      w.numpy())))


def test_beta2_and_rms_guard_on_silent_row(generators):
    _, tg = generators
    rng = np.random.RandomState(0)
    wavs = [(0.03 * rng.randn(8192)).astype(np.float32),
            np.zeros(8192, np.float32)]
    noises = [(0.01 * rng.randn(8192)).astype(np.float32),
              np.zeros(8192, np.float32)]
    cp, lens = tpipe.reflect_pad_batch(wavs)
    npd, _ = tpipe.reflect_pad_batch(noises)
    with torch.no_grad():
        feats = tpipe.featurize_batch(cp, npd, lens, device="cpu")
        t = feats.clean_band.shape[1]
        fmask = tpipe.frame_mask(feats.frames, t).float()
        mask = tg(feats.clean_band, feats.noise_band)
        beta2 = tpipe.beta2_energy_norm(feats.clean_band, mask, fmask)
        wav, _, _ = tpipe.enhance_batch(tg, feats, device="cpu")
    want = np.asarray(jpipe.beta2_energy_norm(
        feats.clean_band.numpy(), mask.numpy(), fmask.numpy()))
    np.testing.assert_allclose(beta2.numpy(), want, rtol=1e-6)
    assert float(beta2[1]) == 1.0
    out = wav.numpy()
    assert np.isfinite(out).all()
    assert np.abs(out[1]).max() == 0.0


def test_istft_batch_matches_jax_f64():
    rng = np.random.RandomState(9)
    spec = rng.randn(2, 257, 30) + 1j * rng.randn(2, 257, 30)
    frames = np.array([30, 17])
    want = np.asarray(jpipe.istft_batch_tail_truncated(spec, frames))
    got = tpipe.istft_batch_tail_truncated(torch.from_numpy(spec),
                                           torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_entry_points_need_cuda_unless_cpu_is_asked(generators, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = generators
    cp, lens = tpipe.reflect_pad_batch([np.zeros(4096, np.float32)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.featurize_batch(cp, cp, lens)
    feats = tpipe.featurize_batch(cp, cp, lens, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.enhance_batch(tg, feats)
