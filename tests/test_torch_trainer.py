"""The port's training loop (`train/loop.py`) against the JAX package's on
one small PCM16 corpus cut from the golden signals: two epochs from the
same initial state, and epoch 2 resumed from the JAX package's epoch-1
checkpoint; then the port alone: exact resume and recovery against the
same run emptied of its caches, the device pools' hits, and the
data-parallel rule without a process group.  CPU, float32."""
import glob
import os
import shutil

import jax
import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

from nelegan_tpu.config import Config as JaxConfig
from nelegan_tpu.config import ModelConfig as JaxModelConfig
from nelegan_tpu.config import TrainConfig as JaxTrainConfig
from nelegan_tpu.train import gan as jgan
from nelegan_tpu.train.loop import Trainer as JaxTrainer
from nelegan_tpu.train.loop import TrainPaths as JaxTrainPaths
from nelegan_tpu_torch.config import Config, ModelConfig, TrainConfig
from nelegan_tpu_torch import metrics as port_metrics
from nelegan_tpu_torch.models.convert import train_state_from_jax
from nelegan_tpu_torch.train import gan
from nelegan_tpu_torch.train.checkpoint import load_checkpoint
from nelegan_tpu_torch.train.loop import (Trainer, TrainPaths,
                                          generator_from_jax_key)
from nelegan_tpu_torch.train.resilience import run_with_recovery

MODEL = dict(gen_hidden=16, gen_blocks=2, disc_channels=(4, 8),
             disc_kernels=(1, 3))
TRAIN = dict(batch_size=2, num_sampling=4, num_valid=1, gan_epochs=2)
CFG = Config(model=ModelConfig(**MODEL), train=TrainConfig(**TRAIN))
METRICS = ("estoi",)
# Bars of the port against the JAX package, both float32 on the CPU:
# scores (replay, history) as |a - b| / max(|b|, 1) within ESTOI's float32
# bar (chip_smoke.py's SCORE_BARS; measured 2.0e-7 on replay scores, 4.1e-7
# on the history); every state tensor (parameters, u and v, Adam moments)
# max|a - b| / max|b| within the models' float32 bar, rtol 1e-4
# (COMPONENTS.md; measured 1.5e-5); each parameter's update in norm within
# chip_smoke.py's F32_UPDATE_BAR (measured 9.0e-6).  Enhanced PCM16 within
# 1 LSB (37 of 187,392 samples differ).
SCORE_BAR = 5e-6
MODEL_BAR = 1e-4
UPDATE_BAR = 3e-3
# (offset, length) of the four training utterances (one 4096-sample
# bucket) and the test utterance, in the golden signals; a test utterance
# much shorter than ~19500 samples gives ESTOI no valid frames
TRAIN_CUTS = ((0, 17000), (3000, 18500), (7000, 20000), (12000, 19000))
TEST_CUT = (9000, 19500)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads: more cost CPU time that these sizes do not repay
    in wall time, and the test run shares its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, goldens):
    """Train/{Clean,Noise,MultiEnh} and Test/{Clean,Noise} as PCM16 wavs;
    MultiEnh, the pre-enhanced stand-in, is the clean signal at half gain."""
    root = tmp_path_factory.mktemp("corpus")
    g = goldens("features")
    for sub in ("Train/Clean", "Train/Noise", "Train/MultiEnh",
                "Test/Clean", "Test/Noise"):
        (root / sub).mkdir(parents=True)

    def write(path, x):
        wavfile.write(path, 16000, (np.clip(x, -1.0, 1.0 - 2.0 ** -15)
                                    * 32768).astype(np.int16))

    for i, (o, n) in enumerate(TRAIN_CUTS):
        name = f"u{i}#Cafeteria#{i}.wav"
        write(root / "Train/Clean" / name, g["clean"][o:o + n])
        write(root / "Train/Noise" / name, g["noise"][o:o + n])
        write(root / "Train/MultiEnh" / name, 0.5 * g["clean"][o:o + n])
    o, n = TEST_CUT
    write(root / "Test/Clean/t0#Cafeteria#0.wav", g["clean"][o:o + n])
    write(root / "Test/Noise/t0#Cafeteria#0.wav", g["noise"][o:o + n])
    return root


def _paths(cls, corpus, run):
    return cls(train_clean=str(corpus / "Train/Clean"),
               train_noise=str(corpus / "Train/Noise"),
               test_clean=str(corpus / "Test/Clean"),
               test_noise=str(corpus / "Test/Noise"),
               train_enhanced=str(corpus / "Train/MultiEnh"),
               output=str(run / "output"), checkpoints=str(run / "chkpt"),
               log_file=str(run / "log.txt"))


@pytest.fixture(scope="module")
def jax_run(corpus, tmp_path_factory):
    """The JAX package's Trainer, two epochs (its `init_train_state`
    jitted: one compilation in place of op-by-op ones).  -> its run
    directory, initial and final states as numpy leaves, history and
    replay entries."""
    jitted = jax.jit(jgan.init_train_state, static_argnums=1)
    run = tmp_path_factory.mktemp("jax_run")
    jcfg = JaxConfig(model=JaxModelConfig(**MODEL),
                     train=JaxTrainConfig(**TRAIN))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgan, "init_train_state",
                   lambda key, cfg=JaxConfig(): jitted(key, cfg))
        t = JaxTrainer(_paths(JaxTrainPaths, corpus, run), jcfg,
                       metric_set=METRICS)
        init = jax.tree.map(np.asarray, t.state)
        t.run(2)
    return {"run": run, "init": init,
            "final": jax.tree.map(np.asarray, t.state),
            "history": t.history, "replay": t.replay.entries}


def port_trainer(corpus, run, state=None, cls=Trainer, **kw) -> Trainer:
    t = cls(_paths(TrainPaths, corpus, run), CFG, metric_set=METRICS,
            device="cpu", **kw)
    if state is not None:
        t.state = train_state_from_jax(state, CFG, "cpu")
    return t


@pytest.fixture(scope="module")
def port_run(corpus, jax_run, tmp_path_factory):
    """The port's Trainer, two epochs from the JAX run's initial state,
    its caches emptied before epoch 2 (as cold as a fresh trainer that
    resumed there, the reference of the exact-resume and recovery tests).
    -> (run directory, trainer, a copy of the run directory's checkpoints
    and log after epoch 1)."""
    run = tmp_path_factory.mktemp("port_run")
    t = port_trainer(corpus, run, jax_run["init"])
    t.run(1)
    after_1 = tmp_path_factory.mktemp("after_epoch_1")
    shutil.copytree(run / "chkpt", after_1 / "chkpt", symlinks=True)
    shutil.copy(run / "log.txt", after_1 / "log.txt")
    t.clear_caches()
    t.start_epoch = 2
    t.run(2)
    return run, t, after_1


def _tensors(state) -> dict:
    """Every tensor of a port TrainState by name: parameters, u and v,
    Adam moments."""
    sd = state.state_dict()
    out = {f"{m}.{k}": v for m in ("gen", "d", "dq") for k, v in sd[m].items()}
    for m in ("gen_opt", "d_opt", "dq_opt"):
        for i, st in sd[m]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"{m}.{i}.{k}"] = st[k]
    return out


def _state_errors(got, want, origin) -> tuple:
    """(largest max|a - b| / max|b| over every tensor, largest ||a - b|| /
    ||b - origin|| over the parameters)."""
    fa, fw, fo = _tensors(got), _tensors(want), _tensors(origin)
    tensor = max(float((fa[k].double() - w.double()).abs().max()
                       / w.double().abs().max().clamp_min(1e-300))
                 for k, w in fw.items())
    update = 0.0
    for m in ("gen", "d", "dq"):
        for name, _ in getattr(want, m).named_parameters():
            k = f"{m}.{name}"
            moved = (fw[k] - fo[k]).double().norm()
            if moved > 0:
                update = max(update, float(
                    (fa[k] - fw[k]).double().norm() / moved))
    return tensor, update


def _states_equal(a, b) -> bool:
    fa, fb = _tensors(a), _tensors(b)
    return (fa.keys() == fb.keys()
            and all(torch.equal(fa[k], fb[k]) for k in fa)
            and (a.step_g, a.step_d) == (b.step_g, b.step_d))


def _replay_close(got, want, got_root, want_root):
    """The same entries, paths under either run directory compared without
    it (a run resumed from the other's checkpoint replays its files)."""
    def rel(p):
        return p.replace(str(got_root), "").replace(str(want_root), "")
    assert [rel(e.enhanced_path) for e in got] == \
        [rel(e.enhanced_path) for e in want]
    assert [e.name for e in got] == [e.name for e in want]
    err = max(abs(a - b) / max(abs(b), 1.0)
              for eg, ew in zip(got, want)
              for a, b in zip(eg.scores, ew.scores))
    assert err < SCORE_BAR, err


def _history_close(got, want):
    assert got.keys() == want.keys()
    for m in want:
        assert len(got[m]) == len(want[m])
        for a, b in zip(got[m], want[m]):
            assert abs(a - b) / max(abs(b), 1.0) < SCORE_BAR, (m, a, b)


def _log_epochs(path) -> list:
    with open(path) as f:
        return [ln.rsplit("EPOCH:", 1)[1].strip() for ln in f]


def test_trainer_follows_jax_from_its_initial_state(jax_run, port_run):
    run, t, _ = port_run
    jrun = jax_run["run"]
    # the same names sampled, written and replayed
    files = sorted(os.path.relpath(p, run / "output") for p in glob.glob(
        str(run / "output" / "**" / "*.wav"), recursive=True))
    jfiles = sorted(os.path.relpath(p, jrun / "output") for p in glob.glob(
        str(jrun / "output" / "**" / "*.wav"), recursive=True))
    assert files == jfiles and len(files) == 2 * (1 + 4)
    n_diff = n_total = 0
    for f in files:
        a = wavfile.read(run / "output" / f)[1].astype(np.int32)
        b = wavfile.read(jrun / "output" / f)[1].astype(np.int32)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, f
        n_diff += int((a != b).sum())
        n_total += a.size
    assert n_diff < 1e-3 * n_total, (n_diff, n_total)
    _replay_close(t.replay.entries, jax_run["replay"], run, jrun)
    assert len(t.replay) == 16
    _history_close(t.history, jax_run["history"])
    assert _log_epochs(t.paths.log_file) == ["1", "2"]

    want = train_state_from_jax(jax_run["final"], CFG, "cpu")
    origin = train_state_from_jax(jax_run["init"], CFG, "cpu")
    assert (t.state.step_g, t.state.step_d) == (want.step_g, want.step_d)
    tensor, update = _state_errors(t.state, want, origin)
    assert tensor < MODEL_BAR and update < UPDATE_BAR, (tensor, update)
    # the gated quality head takes no update; its power iteration runs in
    # the G steps, as in the JAX package
    start = dict(origin.dq.named_parameters())
    for name, p in t.state.dq.named_parameters():
        assert torch.equal(p, start[name]), name
    start = dict(origin.dq.named_buffers())
    us = {k: b for k, b in t.state.dq.named_buffers() if k.endswith("_u")}
    assert us and not any(torch.equal(b, start[k]) for k, b in us.items())


def test_trainer_resumes_jax_checkpoint(jax_run, corpus, tmp_path):
    """Epoch 2 resumed from the JAX package's chkpt_1.msgpack follows JAX's
    epoch 2; the port's own checkpoint of it then resumes."""
    jrun = jax_run["run"]
    t = port_trainer(corpus, tmp_path)
    t.resume(str(jrun / "chkpt" / "chkpt_1.msgpack"))
    assert t.start_epoch == 2
    assert t.history["estoi"] == jax_run["history"]["estoi"][:1]
    key = t.key.get_state()
    t.run(2)
    _replay_close(t.replay.entries, jax_run["replay"], tmp_path, jrun)
    _history_close(t.history, jax_run["history"])
    want = train_state_from_jax(jax_run["final"], CFG, "cpu")
    origin = train_state_from_jax(jax_run["init"], CFG, "cpu")
    tensor, update = _state_errors(t.state, want, origin)
    assert tensor < MODEL_BAR and update < UPDATE_BAR, (tensor, update)

    again = port_trainer(corpus, tmp_path)
    again.resume()
    assert again.start_epoch == 3 and _states_equal(again.state, t.state)
    assert torch.equal(again.key.get_state(), key)
    jax_key = np.asarray(jax.random.key_data(
        jax.random.PRNGKey(JaxTrainConfig().seed)))
    assert torch.equal(key, generator_from_jax_key(jax_key).get_state())
    assert again.replay.state_dict() == t.replay.state_dict()
    assert again.history == t.history


def _same_run(got, want, got_root, want_root):
    """Bit for bit: state (Adam moments, u and v included), replay entries
    (paths without their run directories), history and log."""
    def rows(t, root):
        return [(e.enhanced_path.replace(str(root), "")
                 .replace(str(want_root), ""), e.name, e.scores)
                for e in t.replay.entries]
    assert _states_equal(got.state, want.state)
    assert rows(got, got_root) == rows(want, want_root)
    assert got.history == want.history
    with open(got.paths.log_file) as f, open(want.paths.log_file) as g:
        assert f.read() == g.read()


def test_exact_resume_bit_for_bit(port_run, corpus, monkeypatch):
    """A fresh Trainer resumes the run's epoch-1 checkpoint and runs epoch
    2: equal bit for bit to the run itself, whose caches were emptied
    before epoch 2 (a fresh trainer starts cold).  It runs with the D
    passes' section timing on (NELE_D_TIMING), which changes no number."""
    run, ref, after_1 = port_run
    monkeypatch.setenv("NELE_D_TIMING", "1")
    b = port_trainer(corpus, after_1)
    b.resume(truncate_log=True)
    assert b.start_epoch == 2
    steps = b.state.step_d
    b.run(2)
    _same_run(b, ref, after_1, run)
    assert b.last_d_timing["steps"] == b.state.step_d - steps
    assert b.last_d_timing["step_s"] > 0


def test_recovery_bit_for_bit(port_run, jax_run, corpus, tmp_path):
    """`run_with_recovery` with a fault injected at the start of epoch 2
    rebuilds once, resumes epoch 1's checkpoint and lands on the run whose
    caches were emptied before epoch 2, bit for bit."""
    run, ref, _ = port_run
    attempts = {"n": 0}

    class Flaky(Trainer):
        def run_epoch(self, epoch):
            if attempts["n"] == 1 and epoch == 2:
                raise RuntimeError("injected device fault")
            return super().run_epoch(epoch)

    def make():
        attempts["n"] += 1
        return port_trainer(corpus, tmp_path, jax_run["init"], cls=Flaky)

    t = run_with_recovery(make, epochs=2, max_retries=1,
                          backoff_seconds=0.01)
    assert attempts["n"] == 2
    _same_run(t, ref, tmp_path, run)


def test_generator_unchanged_through_epoch_1(port_run, jax_run):
    """Epoch 1 takes no G step: the module run's epoch-1 checkpoint holds
    the generator it started from bit for bit, G's Adam moments at zero
    and step 0, while D moved."""
    _, _, after_1 = port_run
    # the file, not `latest`: the exact-resume test runs epoch 2 there
    state, _, epoch, _ = load_checkpoint(
        str(after_1 / "chkpt" / "chkpt_1.ptstate"),
        gan.init_train_state(CFG, 9, "cpu"))
    origin = train_state_from_jax(jax_run["init"], CFG, "cpu")
    assert epoch == 1 and state.step_g == 0 and state.step_d > 0
    got, want = state.gen.state_dict(), origin.gen.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(
            got[k].view(torch.uint8), v.view(torch.uint8)), k
    for st in state.gen_opt.state_dict()["state"].values():
        assert float(st["step"]) == 0 and not st["exp_avg"].any() \
            and not st["exp_avg_sq"].any()
    assert not all(torch.equal(p, q) for p, q in zip(
        state.d.parameters(), origin.d.parameters()))


def test_pools_serve_every_epoch(port_run):
    """Each epoch, also the one after the caches were emptied, finds rows
    in both device pools (the telemetry's counts are cumulative): the
    band pool serves D passes 2 and 3 the rows of pass 1, the scoring pool
    serves score_corpus the enhanced PCM16 rows the loop parked."""
    _, t, _ = port_run
    assert [r["epoch"] for r in t.telemetry] == [1, 2]
    prev = {"band_pool_hits": 0, "clean_pool_hits": 0}
    for rec in t.telemetry:
        for k in prev:
            assert rec[k] > prev[k], (rec["epoch"], k)
            prev[k] = rec[k]


def test_data_parallel_raises_with_more_than_one_gpu(corpus, tmp_path,
                                                     monkeypatch):
    """data_parallel=True with more than one visible GPU and no process
    group raises, naming torchrun: the ranks are processes.  With one
    device or none it trains single-device, as the JAX package does with
    one device.  (tests/test_torch_parallel.py trains a world of two.)"""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="torchrun"):
        port_trainer(corpus, tmp_path, data_parallel=True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    t = port_trainer(corpus, tmp_path, data_parallel=True)
    assert t.dev.type == "cpu" and t.mesh is None
    # nothing of the JAX package is left unported: no refusal remains
    assert not hasattr(port_metrics, "not_ported")
