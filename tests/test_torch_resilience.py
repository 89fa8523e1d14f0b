"""Elastic recovery in the port (`train/resilience.py`): a mid-run failure
resumes from the latest checkpoint and completes, with no epoch lost and
none double-counted in the log; the mirror of tests/test_resilience.py on
a one-utterance PCM16 corpus, CPU.  That the recovered run lands bit for
bit where a straight run does is tests/test_torch_trainer.py's
`test_recovery_bit_for_bit`."""
import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

from nelegan_tpu_torch.config import Config, ModelConfig, TrainConfig
from nelegan_tpu_torch.train.loop import Trainer, TrainPaths
from nelegan_tpu_torch.train.resilience import run_with_recovery

CFG = Config(model=ModelConfig(gen_hidden=16, gen_blocks=2,
                               disc_channels=(4, 8), disc_kernels=(1, 3)),
             train=TrainConfig(num_sampling=1, num_valid=1, batch_size=1,
                               gan_epochs=3))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, goldens):
    """One training pair (with a pre-enhanced copy at half gain) and one
    test pair, PCM16, 12000 samples each, cut from the golden signals."""
    root = tmp_path_factory.mktemp("corpus")
    g = goldens("features")
    for sub in ("Train/Clean", "Train/Noise", "Train/MultiEnh",
                "Test/Clean", "Test/Noise"):
        (root / sub).mkdir(parents=True)

    def write(path, x):
        wavfile.write(path, 16000, (np.clip(x, -1.0, 1.0 - 2.0 ** -15)
                                    * 32768).astype(np.int16))

    name = "u0#Cafeteria#0.wav"
    write(root / "Train/Clean" / name, g["clean"][:12000])
    write(root / "Train/Noise" / name, g["noise"][:12000])
    write(root / "Train/MultiEnh" / name, 0.5 * g["clean"][:12000])
    write(root / "Test/Clean/t0#Cafeteria#0.wav", g["clean"][9000:21000])
    write(root / "Test/Noise/t0#Cafeteria#0.wav", g["noise"][9000:21000])
    return root


def _paths(corpus, run) -> TrainPaths:
    return TrainPaths(train_clean=str(corpus / "Train/Clean"),
                      train_noise=str(corpus / "Train/Noise"),
                      test_clean=str(corpus / "Test/Clean"),
                      test_noise=str(corpus / "Test/Noise"),
                      train_enhanced=str(corpus / "Train/MultiEnh"),
                      output=str(run / "output"),
                      checkpoints=str(run / "chkpt"),
                      log_file=str(run / "log.txt"))


def test_run_with_recovery(corpus, tmp_path):
    paths = _paths(corpus, tmp_path / "flaky")
    attempts = {"n": 0}

    class Flaky(Trainer):
        def run_epoch(self, epoch):
            if attempts["n"] == 1 and epoch == 2:
                raise RuntimeError("injected device fault")
            return super().run_epoch(epoch)

    def make():
        attempts["n"] += 1
        return Flaky(paths, CFG, metric_set=("estoi",),
                     valid_metric_set=("estoi",), device="cpu")

    t = run_with_recovery(make, epochs=3, max_retries=2,
                          backoff_seconds=0.01)
    assert attempts["n"] == 2                      # exactly one rebuild
    with open(paths.log_file) as f:
        lines = f.read().strip().splitlines()
    assert len(lines) == 3                         # epochs 1..3, once each
    assert "EPOCH:3" in lines[-1]
    assert t.state.step_g >= 1


def test_recovery_exhausts_and_raises():
    def make():
        raise RuntimeError("always fails")
    with pytest.raises(RuntimeError, match="always fails"):
        run_with_recovery(make, epochs=1, max_retries=1,
                          backoff_seconds=0.01)
