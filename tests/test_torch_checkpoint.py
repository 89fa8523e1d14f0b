"""Port checkpoints (nelegan_tpu_torch.train.checkpoint): exact resume,
retention and atomic publication, the asynchronous saver's snapshot,
reference-format files and the config sidecar; the replay buffer copy."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from nelegan_tpu.config import Config as JaxConfig
from nelegan_tpu.config import config_to_dict as jax_config_to_dict
from nelegan_tpu.models import convert as jconvert
from nelegan_tpu.train.replay import ReplayBuffer as JaxReplayBuffer
from nelegan_tpu.train.replay import ReplayEntry as JaxReplayEntry
from nelegan_tpu_torch.config import (Config, ModelConfig, config_from_dict,
                                      config_to_dict)
from nelegan_tpu_torch.train import checkpoint as ckpt
from nelegan_tpu_torch.train import gan
from nelegan_tpu_torch.train.replay import ReplayBuffer, ReplayEntry

CFG = dataclasses.replace(Config(), model=ModelConfig(
    gen_hidden=16, gen_blocks=3, disc_channels=(4, 8), disc_kernels=(1, 3)))


def _bands(seed=0):
    rng = np.random.RandomState(seed)
    cb, nb, eb = (rng.rand(2, 12, 64).astype(np.float32) + 0.05
                  for _ in range(3))
    return (cb, nb, eb, np.array([12, 9], np.int32),
            rng.uniform(0.2, 0.9, (2, 3)).astype(np.float32),
            rng.uniform(0.2, 0.9, (2, 2)).astype(np.float32))


def _step(state, seed):
    """One G step and one D step; returns the three losses."""
    cb, nb, eb, fr, tg, tq = _bands(seed)
    _, lg = gan.g_step_bands(state, cb, nb, fr, CFG)
    _, ld, lq = gan.d_step_bands(state, eb, nb, cb, fr, tg, tq, CFG)
    return [float(lg), float(ld), float(lq)]


def _assert_equal(a: gan.TrainState, b: gan.TrainState):
    """Bit-for-bit equality of two states, Adam states included."""
    def walk(x, y, key):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), key
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), key
            for k in x:
                walk(x[k], y[k], f"{key}.{k}")
        else:
            assert x == y, key
    walk(a.state_dict(), b.state_dict(), "state")


def test_save_load_resumes_bit_for_bit(tmp_path):
    state = gan.init_train_state(CFG, 0, "cpu")
    _step(state, 1)
    rng = torch.Generator().manual_seed(3)
    torch.rand(5, generator=rng)
    path = ckpt.save_checkpoint(str(tmp_path), 1, state, rng,
                                replay_json='["x"]',
                                extra={"config": config_to_dict(CFG)})
    assert path.endswith("chkpt_1.ptstate")
    assert os.readlink(tmp_path / "latest") == "chkpt_1.ptstate"

    fresh = gan.init_train_state(CFG, 9, "cpu")
    loaded, rng2, epoch, replay, extra = ckpt.load_checkpoint_full(
        str(tmp_path), fresh)
    assert (epoch, replay) == (1, '["x"]')
    assert config_from_dict(extra["config"]) == CFG
    assert torch.equal(torch.rand(4, generator=rng2),
                       torch.rand(4, generator=rng))
    _assert_equal(loaded, state)
    assert _step(loaded, 2) == _step(state, 2)
    _assert_equal(loaded, state)


def test_pruning_and_atomic_latest(tmp_path):
    state = gan.init_train_state(CFG, 0, "cpu")
    rng = torch.Generator().manual_seed(0)
    for ep in range(1, 8):
        ckpt.save_checkpoint(str(tmp_path), ep, state, rng,
                             extra={"epoch_tag": ep}, keep_every=5,
                             keep_last=2)
    names = sorted(os.listdir(tmp_path))
    assert not [n for n in names if n.endswith(".tmp")], names
    kept = sorted(int(n[6:-len(ckpt.SUFFIX)]) for n in names
                  if n.endswith(ckpt.SUFFIX))
    assert kept == [5, 6, 7]           # every 5th, and the last two
    assert all(f"chkpt_{e}{ckpt.SUFFIX}.json" in names for e in kept)
    assert os.readlink(tmp_path / "latest") == f"chkpt_7{ckpt.SUFFIX}"
    assert ckpt.peek_meta(str(tmp_path))["epoch"] == 7
    # an explicit older file reads its own sidecar
    _, _, epoch, _, extra = ckpt.load_checkpoint_full(
        str(tmp_path / f"chkpt_5{ckpt.SUFFIX}"),
        gan.init_train_state(CFG, 1, "cpu"))
    assert epoch == 5 and extra == {"epoch_tag": 5}
    assert ckpt.prune_checkpoints(str(tmp_path), 7, 0, 2) == 0


def test_async_save_is_a_snapshot(tmp_path):
    """save_async copies the state before it returns: an in-place step
    taken while the save is in flight does not reach the file."""
    state = gan.init_train_state(CFG, 0, "cpu")
    _step(state, 1)
    rng = torch.Generator().manual_seed(1)
    saver = ckpt.AsyncSaver()
    before = gan.init_train_state(CFG, 2, "cpu")
    before.load_state_dict(state.state_dict())
    saver.save_async(str(tmp_path), 4, state, rng)
    _step(state, 2)                                   # while in flight
    ckpt.AsyncSaver.barrier(str(tmp_path))            # any instance may wait
    saver.wait()
    loaded, _, epoch, _ = ckpt.load_checkpoint(
        str(tmp_path), gan.init_train_state(CFG, 3, "cpu"))
    assert epoch == 4
    _assert_equal(loaded, before)
    assert not torch.equal(loaded.gen.fc1.weight, state.gen.fc1.weight)
    # a failing background save surfaces on the next wait()
    saver.save_async(str(tmp_path / ("x" * 300)), 1, state, rng)
    with pytest.raises(OSError):
        saver.wait()


def test_reference_checkpoint_loads_strict(tmp_path):
    """A chkpt_*.pt with G, D and D_Qua in the reference format, written by
    the reference package's exporter, loads strict into G, D and D_Qua (the
    reference's five-layer discriminators)."""
    cfg = dataclasses.replace(CFG, model=ModelConfig(gen_hidden=16,
                                                     gen_blocks=3))
    src = gan.init_train_state(cfg, 5, "cpu")
    path = str(tmp_path / "chkpt_GD.pt")
    jconvert.save_torch_checkpoint(
        path, generator=jconvert.torch_generator_to_flax(
            src.gen.state_dict(), n_blocks=3),
        intel=jconvert.torch_discriminator_to_flax(src.d.state_dict()),
        quality=jconvert.torch_discriminator_to_flax(src.dq.state_dict()),
        n_blocks=3)
    state = ckpt.load_reference_checkpoint(
        path, gan.init_train_state(cfg, 6, "cpu"))
    for name in ("gen", "d", "dq"):
        want = getattr(src, name).state_dict()
        for k, v in getattr(state, name).state_dict().items():
            assert torch.equal(v, want[k]), (name, k)
    torch.save({"other": {}}, tmp_path / "bad.pt")
    with pytest.raises(KeyError):
        ckpt.load_reference_checkpoint(str(tmp_path / "bad.pt"), state)


def test_config_travels_with_checkpoint(tmp_path):
    assert config_from_dict(config_to_dict(CFG)) == CFG
    # the reference package's dict (with its calib and parallel sections)
    # gives the same config
    jax_cfg = dataclasses.replace(JaxConfig(), model=dataclasses.replace(
        JaxConfig().model, gen_hidden=16, gen_blocks=3, disc_channels=(4, 8),
        disc_kernels=(1, 3)))
    assert config_from_dict(jax_config_to_dict(jax_cfg)) == CFG
    state = gan.init_train_state(CFG, 0, "cpu")
    ckpt.save_checkpoint(str(tmp_path), 3, state,
                         torch.Generator().manual_seed(0),
                         extra={"config": config_to_dict(CFG)})
    got = ckpt.config_for_checkpoint(str(tmp_path))
    assert got == CFG
    loaded, _, _, _ = ckpt.load_checkpoint(
        str(tmp_path), gan.init_train_state(got, 1, "cpu"))
    _assert_equal(loaded, state)
    assert ckpt.config_for_checkpoint(None) == Config()
    assert ckpt.config_for_checkpoint(str(tmp_path / "absent")) == Config()


def test_replay_buffer_matches_reference_package():
    entries = [(f"e{i}.wav", f"n{i}", [0.1 * i] * 5) for i in range(64)]
    ours, ref = ReplayBuffer(seed=4), JaxReplayBuffer(seed=4)
    ours.extend([ReplayEntry(*e) for e in entries])
    ref.extend([JaxReplayEntry(*e) for e in entries])
    assert ([e.name for e in ours.sample_fraction(30)]
            == [e.name for e in ref.sample_fraction(30)])
    assert ours.state_dict() == ref.state_dict()
    back = ReplayBuffer()
    back.load_state_dict(ours.state_dict())
    assert len(back) == 64 and back.entries[5] == ours.entries[5]
