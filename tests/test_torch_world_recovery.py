"""Recovery of a whole torchrun world (`cli/train --data-parallel
--max-retries` under `torchrun --max-restarts`), CPU, two gloo ranks.

A fault in rank 1 at the start of epoch 2 of the first attempt (after
`latest` names epoch 1) fails the world; torchrun's agent kills rank 0 and
starts the world again, and every rank resumes the latest checkpoint.  The
run ends bit for bit where a world run to that epoch and then resumed by
hand (`--resume`) ends: log, state, key, replay, history.  The CLI refuses
more retries than the agent allows restarts.

Run as a script (torchrun's entry), this file is `cli/train` with that
fault injected.
"""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
EPOCHS = 2
FAULT_RANK, FAULT_EPOCH = 1, 2
# (offset, length) in the golden signals: two training utterances (one
# batch of two) and a test utterance long enough for ESTOI's frames
TRAIN_CUTS = ((0, 8000), (5000, 7000))
TEST_CUT = (9000, 20000)
RECOVERED = re.compile(r"\[recovery\] attempt (\d+): resumed at epoch (\d+)")


def inject_fault() -> None:
    """On the first attempt, rank FAULT_RANK raises at the start of epoch
    FAULT_EPOCH, once `latest` names the epoch before it (rank 0 publishes
    it in the background while the next epoch runs)."""
    from nelegan_tpu_torch.train import loop, resilience
    if (resilience.restart_count() != 0
            or int(os.environ["RANK"]) != FAULT_RANK):
        return
    run_epoch = loop.Trainer.run_epoch

    def faulty(self, epoch):
        if epoch == FAULT_EPOCH:
            latest = os.path.join(self.paths.checkpoints, "latest")
            want = f"chkpt_{epoch - 1}.ptstate"
            deadline = time.monotonic() + 120
            while not (os.path.lexists(latest)
                       and os.readlink(latest) == want):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{latest} never named {want}")
                time.sleep(0.02)
            raise RuntimeError(f"injected fault: rank {FAULT_RANK}, "
                               f"epoch {epoch}")
        return run_epoch(self, epoch)

    loop.Trainer.run_epoch = faulty


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, goldens):
    root = tmp_path_factory.mktemp("corpus")
    g = goldens("features")
    for sub in ("Train/Clean", "Train/Noise", "Test/Clean", "Test/Noise"):
        (root / sub).mkdir(parents=True)

    def write(path, x):
        wavfile.write(path, 16000, (np.clip(x, -1.0, 1.0 - 2.0 ** -15)
                                    * 32768).astype(np.int16))

    for i, (o, n) in enumerate(TRAIN_CUTS):
        name = f"u{i}#Cafeteria#{i}.wav"
        write(root / "Train/Clean" / name, g["clean"][o:o + n])
        write(root / "Train/Noise" / name, g["noise"][o:o + n])
    o, n = TEST_CUT
    write(root / "Test/Clean/t0#Cafeteria#0.wav", g["clean"][o:o + n])
    write(root / "Test/Noise/t0#Cafeteria#0.wav", g["noise"][o:o + n])
    return root


def cli_args(corpus, run, epochs) -> list:
    return ["--data-parallel", "--device", "cpu",
            "--train-clean", str(corpus / "Train/Clean"),
            "--train-noise", str(corpus / "Train/Noise"),
            "--test-clean", str(corpus / "Test/Clean"),
            "--test-noise", str(corpus / "Test/Noise"),
            "--epochs", str(epochs), "--batch-size", str(WORLD),
            "--num-sampling", str(len(TRAIN_CUTS)), "--num-valid", "1",
            "--metrics", "estoi", "--output", str(run / "output"),
            "--checkpoints", str(run / "chkpt"),
            "--log-file", str(run / "log.txt")]


def torchrun(entry: list, args: list, restarts: int = 0) -> subprocess.Popen:
    """A world of WORLD gloo ranks on a free port, one torch thread each."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        filter(None, (str(REPO), os.environ.get("PYTHONPATH")))))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "--max-restarts", str(restarts),
         *entry, *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def finish(proc: subprocess.Popen) -> str:
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-6000:]
    return out


def checkpoint(run: Path) -> tuple:
    """(blob, sidecar) of a run's latest checkpoint."""
    path = run / "chkpt" / os.readlink(run / "chkpt" / "latest")
    with open(f"{path}.json") as f:
        meta = json.load(f)
    return torch.load(path, map_location="cpu", weights_only=True), meta


def tensors_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tensors_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(tensors_equal, a, b))
    return a == b


def test_world_recovers_like_a_resume_by_hand(corpus, tmp_path):
    """The faulty world and the reference world to epoch 1 run at once; the
    reference's `--resume` world runs after it."""
    rec, ref = tmp_path / "recovered", tmp_path / "by_hand"
    faulty = torchrun([__file__], cli_args(corpus, rec, EPOCHS) + [
        "--max-retries", "1"], restarts=1)
    first = torchrun(["-m", "nelegan_tpu_torch.cli.train"],
                     cli_args(corpus, ref, FAULT_EPOCH - 1))
    out = finish(faulty)
    finish(first)
    assert "injected fault" in out
    resumed = RECOVERED.findall(out)
    # every rank resumed, from the same checkpoint: the one published
    # before the fault (the fault waits for it)
    assert sorted(resumed) == [("2", str(FAULT_EPOCH))] * WORLD, out[-6000:]
    finish(torchrun(["-m", "nelegan_tpu_torch.cli.train"],
                    cli_args(corpus, ref, EPOCHS) + ["--resume"]))

    (got, got_meta), (want, want_meta) = checkpoint(rec), checkpoint(ref)
    assert got["epoch"] == want["epoch"] == EPOCHS
    assert tensors_equal(got["state"], want["state"])
    assert torch.equal(got["rng"], want["rng"])
    assert (got["replay"].replace(str(rec), "")
            == want["replay"].replace(str(ref), ""))
    assert got_meta["extra"]["history"] == want_meta["extra"]["history"]
    assert len(got_meta["extra"]["history"]["estoi"]) == EPOCHS
    log = (rec / "log.txt").read_text()
    assert log == (ref / "log.txt").read_text()
    assert [ln.rsplit("EPOCH:", 1)[1].strip()
            for ln in log.splitlines()] == ["1", "2"]


@pytest.mark.parametrize("restarts", [None, "0"])
def test_more_retries_than_restarts_is_refused(corpus, tmp_path,
                                               monkeypatch, restarts):
    """--max-retries above torchrun's --max-restarts (or with no agent
    restarts at all) refuses before the world is joined."""
    from nelegan_tpu_torch.cli import train
    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    if restarts is None:
        monkeypatch.delenv("TORCHELASTIC_MAX_RESTARTS", raising=False)
    else:
        monkeypatch.setenv("TORCHELASTIC_MAX_RESTARTS", restarts)
    with pytest.raises(SystemExit, match="--max-restarts 1"):
        train.main(cli_args(corpus, tmp_path, 1) + ["--max-retries", "1"])


def test_restart_without_a_checkpoint_starts_afresh(corpus, tmp_path,
                                                    monkeypatch):
    """A restarted attempt with no `latest` yet (a fault in epoch 1)
    resumes nothing; the first attempt never resumes."""
    from nelegan_tpu_torch.config import Config, ModelConfig, TrainConfig
    from nelegan_tpu_torch.train.loop import Trainer, TrainPaths
    from nelegan_tpu_torch.train.resilience import resume_after_restart
    cfg = Config(model=ModelConfig(gen_hidden=8, gen_blocks=1,
                                   disc_channels=(4, 8), disc_kernels=(1, 3)),
                 train=TrainConfig(batch_size=2, num_sampling=2, num_valid=1))
    t = Trainer(TrainPaths(
        str(corpus / "Train/Clean"), str(corpus / "Train/Noise"),
        str(corpus / "Test/Clean"), str(corpus / "Test/Noise"),
        checkpoints=str(tmp_path / "chkpt")), cfg, ("estoi",), device="cpu")
    monkeypatch.delenv("TORCHELASTIC_RESTART_COUNT", raising=False)
    assert resume_after_restart(t) is None
    monkeypatch.setenv("TORCHELASTIC_RESTART_COUNT", "1")
    assert resume_after_restart(t) is None and t.start_epoch == 1


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    inject_fault()
    from nelegan_tpu_torch.cli import train
    train.main()
