"""Checkpoints of the complete training state, resumable exactly.

Counterpart of `nelegan_tpu/train/checkpoint.py`, in the port's own format.
A checkpoint is the whole state: the three models (parameters and the
spectral-norm u, v), the three Adam states, the step counters, the
`torch.Generator` state, the epoch and the replay buffer, so
`load_checkpoint` resumes bit for bit.  (The reference saves only the G and
D weights, reference: train_nele.py:76-85, 272-277.)

Format: one ``chkpt_<epoch>.ptstate`` per epoch, written with `torch.save`
and read with ``torch.load(weights_only=True)``, beside a JSON sidecar
``chkpt_<epoch>.ptstate.json`` holding ``epoch``, ``replay`` and ``extra``
(``extra["config"]`` from `config_to_dict`), and a ``latest`` symlink.  The
suffix differs from the reference's ``chkpt_*.pt``, which
`load_reference_checkpoint` reads, and from the reference package's
``chkpt_<epoch>.msgpack`` (flax serialization, with the same sidecar), which
the loaders here also read: `train.flax_msgpack` decodes it without flax or
msgpack, and `models.convert.train_state_from_jax` carries the state across.
"""
from __future__ import annotations

import glob
import json
import os
import re
import threading
from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np
import torch

from nelegan_tpu_torch.config import Config, config_from_dict
from nelegan_tpu_torch.device import resolve_device
from nelegan_tpu_torch.models import convert
from nelegan_tpu_torch.models.generator import Generator
from nelegan_tpu_torch.train import flax_msgpack
from nelegan_tpu_torch.train.gan import TrainState, init_train_state

SUFFIX = ".ptstate"
JAX_SUFFIX = ".msgpack"
FORMAT = 1


def _path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"chkpt_{epoch}{SUFFIX}")


def prune_checkpoints(directory: str, current_epoch: int,
                      keep_every: int, keep_last: int) -> int:
    """Delete checkpoints (and sidecars) that are neither among the
    keep_last most recent epochs nor divisible by keep_every.  No-op when
    keep_every <= 0 (keep all, the reference's habit).  Returns the number
    pruned."""
    if keep_every <= 0:
        return 0
    pruned = 0
    for p in glob.glob(os.path.join(directory, f"chkpt_*{SUFFIX}")):
        m = re.match(rf"chkpt_(\d+){re.escape(SUFFIX)}$", os.path.basename(p))
        if not m:
            continue
        e = int(m.group(1))
        if e % keep_every == 0 or e > current_epoch - keep_last:
            continue
        for f in (p, p + ".json"):
            if os.path.exists(f):
                os.remove(f)
        pruned += 1
    return pruned


def _host_copy(obj):
    """`obj` with every tensor copied to the host: a CUDA tensor into pinned
    memory without blocking (the caller synchronises), a CPU tensor
    cloned."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            out = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
            return out.copy_(obj, non_blocking=True)
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _snapshot(state: TrainState, rng: torch.Generator, epoch: int,
              replay_json: str) -> Dict[str, Any]:
    """The checkpoint's blob: a host copy of the whole state, complete when
    this returns.  The optimisers update their tensors in place, so a save
    that read the live state later would race the next step."""
    blob = {"format": FORMAT, "state": _host_copy(state.state_dict()),
            "rng": rng.get_state(), "epoch": int(epoch),
            "replay": replay_json}
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    return blob


def _publish(directory: str, blob: Dict[str, Any],
             extra: Optional[Dict[str, Any]], keep_every: int,
             keep_last: int) -> str:
    """Write `blob` and its sidecar, then point `latest` at them."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, blob["epoch"])
    meta = {"epoch": blob["epoch"], "replay": blob["replay"],
            "extra": extra or {}}
    # atomic publication: each file under a tmp name, fsync, then rename
    # data -> sidecar -> `latest`; a crash mid-save never leaves a truncated
    # blob behind a live `latest`, nor a sidecar without its blob
    with open(path + ".tmp", "wb") as f:
        torch.save(blob, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".json.tmp", path + ".json")
    latest = os.path.join(directory, "latest")
    tmp = latest + ".tmp"
    if os.path.lexists(tmp):
        os.remove(tmp)
    os.symlink(os.path.basename(path), tmp)
    os.replace(tmp, latest)
    prune_checkpoints(directory, blob["epoch"], keep_every, keep_last)
    return path


def save_checkpoint(directory: str, epoch: int, state: TrainState,
                    rng: torch.Generator, replay_json: str = "[]",
                    extra: Optional[Dict[str, Any]] = None,
                    keep_every: int = 0, keep_last: int = 5) -> str:
    """Write epoch `epoch`'s checkpoint and return its path."""
    return _publish(directory, _snapshot(state, rng, epoch, replay_json),
                    extra, keep_every, keep_last)


class AsyncSaver:
    """Overlap a checkpoint's disk write with the next steps.

    `save_async` takes the host snapshot before it returns (device copies
    into pinned memory, then a synchronise), and a background thread writes
    that snapshot: the steps that follow update the live state in place and
    cannot reach it.  One save in flight at a time: `save_async` joins the
    previous one first, and `wait` re-raises a background failure; wait
    before reading checkpoints back.  A process that dies mid-save leaves
    `latest` on the previous epoch (atomic publication)."""

    # in-flight saves by directory across all instances: a resume through
    # another saver (a fresh trainer) must not read `latest` while this
    # one's save still flips it
    _inflight: Dict[str, threading.Thread] = {}
    _inflight_lock = threading.Lock()

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[Exception] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    @classmethod
    def barrier(cls, directory: str) -> None:
        """Join any in-flight save to `directory`, whichever saver started
        it (its errors still surface on the owner's `wait`)."""
        if not os.path.isdir(directory):
            directory = os.path.dirname(directory) or "."
        with cls._inflight_lock:
            t = cls._inflight.get(os.path.realpath(directory))
        if t is not None:
            t.join()

    def save_async(self, directory: str, epoch: int, state: TrainState,
                   rng: torch.Generator, replay_json: str = "[]",
                   extra: Optional[Dict[str, Any]] = None,
                   keep_every: int = 0, keep_last: int = 5) -> None:
        self.wait()
        blob = _snapshot(state, rng, epoch, replay_json)
        key = os.path.realpath(directory)

        def run():
            try:
                _publish(directory, blob, extra, keep_every, keep_last)
            except Exception as e:  # noqa: BLE001 — raised by the next wait()
                self._err = e
            finally:
                with AsyncSaver._inflight_lock:
                    if AsyncSaver._inflight.get(key) is thread:
                        del AsyncSaver._inflight[key]

        thread = threading.Thread(target=run, daemon=True,
                                  name="nele-ckpt-saver")
        with AsyncSaver._inflight_lock:
            AsyncSaver._inflight[key] = thread
        self._thread = thread
        thread.start()


def _resolve(path: str) -> str:
    if os.path.isdir(path):
        path = os.path.join(path, "latest")
    return os.path.realpath(path)


def load_checkpoint(path: str, template_state: TrainState):
    """-> (state, rng, epoch, replay_json).  `path` is a directory (its
    `latest`) or a checkpoint file, the port's ``.ptstate`` or the reference
    package's ``.msgpack``; `template_state`, built for the same config,
    receives the tensors on its own device and dtype.  `rng` is the saved
    `torch.Generator`, or for a ``.msgpack`` file the JAX PRNG key's data as
    a numpy ``uint32[2]``: a port run resumed from it cannot continue JAX's
    random stream."""
    state, rng, epoch, replay_json, _ = load_checkpoint_full(path,
                                                             template_state)
    return state, rng, epoch, replay_json


def jax_train_state(tree: Dict[str, Any]) -> SimpleNamespace:
    """The decoded ``state`` of a reference-package checkpoint (a dict whose
    optax Adam chains arrive as ``{"0": {count, mu, nu}, "1": {}}``) in the
    shape `models.convert.train_state_from_jax` reads a reference-package
    `TrainState`: attributes, numpy leaves, each Adam state a tuple whose
    first element has ``count``, ``mu`` and ``nu``."""
    opts = {name: (SimpleNamespace(**tree[name]["0"]),)
            for name in ("gen_opt", "d_opt", "dq_opt")}
    return SimpleNamespace(**dict(tree, **opts))


def _load_jax(path: str, template_state: TrainState, meta: Dict[str, Any]):
    blob = flax_msgpack.load(path)
    cfg = _config(meta)
    state = convert.train_state_from_jax(jax_train_state(blob["state"]), cfg,
                                         template_state.device)
    template_state.load_state_dict(state.state_dict())
    return template_state, np.asarray(blob["rng"], np.uint32)


def load_checkpoint_full(path: str, template_state: TrainState):
    """-> (state, rng, epoch, replay_json, extra), the sidecar's `extra` of
    the same checkpoint file."""
    path = _resolve(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    if path.endswith(JAX_SUFFIX):
        state, rng = _load_jax(path, template_state, meta)
        return (state, rng, int(meta["epoch"]), meta.get("replay", "[]"),
                meta.get("extra") or {})
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if blob.get("format") != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of format {FORMAT}")
    template_state.load_state_dict(blob["state"])
    rng = torch.Generator()
    rng.set_state(blob["rng"])
    return (template_state, rng, int(blob["epoch"]), blob["replay"],
            meta.get("extra") or {})


def peek_meta(path: str) -> Dict[str, Any]:
    """The sidecar (epoch, replay, extra) without reading the tensors, so a
    caller can rebuild the Config before building a template state."""
    with open(_resolve(path) + ".json") as f:
        return json.load(f)


def _config(meta: Dict[str, Any]) -> Config:
    try:
        return config_from_dict(meta["extra"]["config"])
    except (KeyError, TypeError):
        return Config()


def config_for_checkpoint(path: Optional[str]) -> Config:
    """The Config a checkpoint (either format) was trained with (sidecar
    ``extra["config"]``); the defaults for a checkpoint without one, or
    when no path is given."""
    if path:
        try:
            return _config(peek_meta(path))
        except (FileNotFoundError, json.JSONDecodeError):
            pass
    return Config()


def load_reference_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a reference ``chkpt_*.pt`` ('enhance-model', 'intel-model',
    'quality-model', whichever it holds) into G, D and D_Qua with
    ``strict=True``; optimiser states and counters are left as they are."""
    for slot, sd in convert.reference_state_dicts(path).items():
        getattr(state, slot).load_state_dict(sd, strict=True)
    return state


def load_generator(checkpoint: Optional[str] = None,
                   torch_checkpoint: Optional[str] = None, device=None):
    """The generator a CLI runs, as the reference package's CLIs load it:
    sized by `config_for_checkpoint(checkpoint)`, its weights from
    `torch_checkpoint` (a reference ``chkpt_*.pt``; it wins when both are
    given) or from `checkpoint` (a ``.ptstate`` or ``.msgpack`` file, or a
    directory).  -> (generator on `device` (None: CUDA) in eval mode,
    config, epoch or None)."""
    dev = resolve_device(device)
    cfg = config_for_checkpoint(checkpoint)
    if torch_checkpoint:
        gen = Generator.from_config(cfg.model)
        gen.load_state_dict(convert.load_reference_checkpoint(
            torch_checkpoint), strict=True)
        return gen.to(dev).eval(), cfg, None
    if checkpoint:
        state, _, epoch, _ = load_checkpoint(checkpoint,
                                             init_train_state(cfg, 0, dev))
        return state.gen.eval(), cfg, epoch
    raise SystemExit("need --checkpoint or --torch-checkpoint")
