"""The evaluation entry points of the port against the JAX package on the
same numpy inputs: `cli/eval_reverb` over a padded bucket of four
utterances of different lengths (batch 4), and P.56's batch over four
different rows.  The card runs the same paths in `chip_smoke.py`'s eval
phase."""
import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

from nelegan_tpu import pipeline as jpipeline
from nelegan_tpu.cli import eval_reverb as jeval
from nelegan_tpu.train import gan as jgan
from nelegan_tpu_torch import pipeline
from nelegan_tpu_torch.cli import eval_reverb
from nelegan_tpu_torch.models.convert import save_reference_checkpoint
from nelegan_tpu_torch.models.generator import Generator

LENGTHS = (20500, 21800, 23000, 24576)     # one 24576-sample bucket


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, goldens):
    """Four PCM16 pairs of different lengths cut from the golden signals at
    seeded offsets and gains, and a reference-format generator at full
    width whose weights are drawn with numpy."""
    root = tmp_path_factory.mktemp("eval_corpus")
    g = goldens("features")
    rng = np.random.RandomState(13)
    for sub in ("Clean", "Noise"):
        (root / sub).mkdir()
    for i, n in enumerate(LENGTHS):
        off, s = int(rng.randint(0, 9000)), float(rng.uniform(0.5, 1.5))
        name = f"utt{i}#Cafeteria#{i}.wav"
        for sub, x in (("Clean", g["clean"]), ("Noise", g["noise"])):
            x = np.tile(x, 2)[off:off + n] * s
            wavfile.write(root / sub / name, 16000,
                          np.round(x * 32767).astype(np.int16))
    sd = {k: torch.from_numpy(rng.uniform(-0.05, 0.05, tuple(v.shape))
                              .astype(np.float32))
          for k, v in Generator().state_dict().items()}
    save_reference_checkpoint(str(root / "chkpt_GD.pt"), {"gen": sd})
    rir = np.zeros(2400)
    rir[57] = 0.9
    rir[58:] = 0.05 * rng.randn(2342) * 10.0 ** (-3.0 * np.arange(2342)
                                                  / 2400.0)
    wavfile.write(root / "rir.wav", 16000,
                  np.round(rir * 32767).astype(np.int16))
    return root


def _printed(text: str, metric: str) -> list:
    tag = f"{metric.upper()} is "
    return [float(part.split(tag)[1]) for line in text.splitlines()
            for part in line.split(",") if tag in part]


def test_eval_reverb_batched_bucket_matches_jax(corpus, capsys,
                                                monkeypatch):
    """Batch 4 over four lengths in one padded bucket, NO_rev and a
    synthetic RIR, ESTOI: every printed mean equals the JAX CLI's to the
    print's last digit.  The JAX CLI's template state is not drawn:
    `--torch-checkpoint` replaces its generator, the one part it reads."""
    monkeypatch.setattr(jgan, "init_train_state", lambda key, cfg: jgan
                        .TrainState(*[None] * len(jgan.TrainState._fields)))
    args = ["--test-clean", str(corpus / "Clean"), "--test-noise",
            str(corpus / "Noise"), "--torch-checkpoint",
            str(corpus / "chkpt_GD.pt"), "--batch-size", "4", "--metrics",
            "estoi", "--rir", "NO_rev", "--rir", str(corpus / "rir.wav")]
    jeval.main(args)
    want = capsys.readouterr().out
    res = eval_reverb.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert list(res) == ["NO_rev", str(corpus / "rir.wav")]
    w, g = _printed(want, "estoi"), _printed(got, "estoi")
    assert len(w) == len(g) == 2, (want, got)
    for a, b in zip(g, w):
        assert abs(a - b) <= 1e-3 + 1e-9, (got, want)
    # the port's unrounded means are what it printed
    assert [float(f"{res[c]['estoi']:.3f}") for c in res] == g


def test_active_speech_level_batch_matches_jax_rows(goldens):
    """Four different rows at float64 (a crop of the utterance tiled round,
    one with a second of silence in it, one at a low and one at a high
    gain) against the JAX package's vmap within 1e-9."""
    x = goldens("features")["clean"]
    quiet = x.copy()
    quiet[8000:24000] = 0.0
    rows = np.stack([np.roll(x, -7001) * 0.7, quiet,
                     np.roll(x, -20011) * 0.04, x * 2.5])
    want = np.asarray(jpipeline.active_speech_level_batch(rows))
    got = pipeline.active_speech_level_batch(rows, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)
    assert len(set(np.round(want, 12))) == 4
