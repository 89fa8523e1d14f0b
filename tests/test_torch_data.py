"""Port wav I/O and corpus loading (nelegan_tpu_torch.data) against the JAX
package's, on the same files."""
import os

import numpy as np
import pytest
import scipy.io.wavfile as wavfile

from nelegan_tpu.data import pipeline as jpipe
from nelegan_tpu.data import wavio as jwavio
from nelegan_tpu_torch.data import pipeline as tpipe
from nelegan_tpu_torch.data import wavio


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, goldens):
    """Ten pairs in three length buckets (one nested a directory deeper),
    cut from the golden speech and noise, as PCM16 wavs, plus a file that is
    not a wav by its extension."""
    root = tmp_path_factory.mktemp("corpus")
    g = goldens("features")
    rng = np.random.RandomState(4)
    (root / "clean" / "sub").mkdir(parents=True)
    (root / "noise").mkdir()
    for i, n in enumerate([3000, 3500, 4096, 5000, 7000, 8000, 8192, 9000,
                           12000, 12288]):
        o = rng.randint(0, g["clean"].size - n)
        sub = "sub" if i == 4 else ""
        name = f"u{i:02d}#Cafe#{i}.wav"
        wavfile.write(root / "clean" / sub / name, 16000,
                      (g["clean"][o:o + n] * 32768).astype(np.int16))
        wavfile.write(root / "noise" / name, 16000,
                      (g["noise"][o:o + n + 50] * 32768).astype(np.int16))
    (root / "clean" / "u00#Cafe#0.wav.bak").write_bytes(b"x")
    return root


def _signals():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 3000),
                        np.array([0.5, -0.5, 1.5, -1.5, 32766.5, -32767.5,
                                  2.0, -2.0]) / 32768.0]).astype(np.float32)
    return x, (rng.randn(2000) * 3000).astype(np.int16)


def test_written_wavs_are_byte_identical(tmp_path):
    x, pcm = _signals()
    files = {}
    for name, write in (("jax", jwavio.write_wav_pcm16),
                        ("native", wavio.write_wav_pcm16),
                        ("plain", lambda p, d, fs: wavio.write_wav_pcm16(
                            p, d, fs, native=False))):
        for kind, data in (("f", x), ("i", pcm)):
            path = tmp_path / f"{name}_{kind}.wav"
            write(str(path), data, 16000)
            files[name, kind] = path.read_bytes()
    for kind in "fi":
        assert files["native", kind] == files["jax", kind]
        assert files["plain", kind] == files["jax", kind]
    np.testing.assert_array_equal(
        wavfile.read(tmp_path / "native_f.wav")[1], wavio.pcm16_samples(x))
    assert list(wavio.pcm16_samples(x[-8:])) == [1, -1, 2, -2, 32767, -32768,
                                                 2, -2]


def test_readers_native_equal_plain_and_jax(corpus):
    paths = sorted(tpipe.get_filepaths(str(corpus / "clean")))
    assert len(paths) == 10 and not any(p.endswith(".bak") for p in paths)
    for p in paths[:3]:
        got, rate = wavio.read_wav(p)
        plain, rate_p = wavio.read_wav(p, native=False)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, jwavio.read_wav(p)[0])
        assert rate == rate_p == 16000
        assert wavio.wav_length(p) == wavio.wav_length(p, native=False) \
            == len(got)
    batch = wavio.read_wav_batch(paths, 8192, n_threads=4)
    plain = wavio.read_wav_batch(paths, 8192, native=False)
    for a, b in zip(batch, plain):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(IOError):
        wavio.read_wav_batch([paths[0], str(corpus / "absent.wav")], 100)


@pytest.mark.parametrize("shuffle", [False, True])
def test_bucketed_loader_matches_jax(corpus, shuffle):
    paths = sorted(tpipe.get_filepaths(str(corpus / "clean")))
    assert paths == sorted(jpipe.get_filepaths(str(corpus / "clean")))
    noise = str(corpus / "noise")
    # the shuffled run also loads a third signal (here the noise again)
    ours = tpipe.BucketedLoader(tpipe.CorpusIndex(paths, noise, noise), 3,
                                shuffle, seed=5, with_extra=shuffle)
    ref = jpipe.BucketedLoader(jpipe.CorpusIndex(paths, noise, noise), 3,
                               shuffle, seed=5, with_extra=shuffle)
    for epoch in range(2):
        got, want = list(ours()), list(ref())
        assert [b.names for b in got] == [b.names for b in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.lengths, b.lengths)
            np.testing.assert_array_equal(a.clean, b.clean)
            np.testing.assert_array_equal(a.noise, b.noise)
            if shuffle:
                np.testing.assert_array_equal(a.extra, b.extra)
            else:
                assert a.extra is None and b.extra is None
    assert sorted(n for b in got for n in b.names) == sorted(
        os.path.basename(p) for p in paths)


def test_corpus_refuses_duplicate_basenames(corpus):
    a = str(corpus / "clean" / "u00#Cafe#0.wav")
    b = str(corpus / "clean" / "sub" / "u00#Cafe#0.wav")
    with pytest.raises(ValueError, match="duplicate"):
        tpipe.CorpusIndex([a, b], str(corpus / "noise"))
    assert tpipe._bucket_len(4096) == 4096 and tpipe._bucket_len(4097) == 8192


def test_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "wavio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(wavio, "_SRC", bad)
    monkeypatch.setattr(wavio, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        wavio.build()
