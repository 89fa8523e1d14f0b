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
suffix differs from the reference package's ``.msgpack`` and from the
reference's ``chkpt_*.pt``, which `load_reference_checkpoint` reads.
"""
from __future__ import annotations

import glob
import json
import os
import re
import threading
from typing import Any, Dict, Optional

import torch

from nelegan_tpu_torch.config import Config, config_from_dict
from nelegan_tpu_torch.models.convert import reference_state_dicts
from nelegan_tpu_torch.train.gan import TrainState

SUFFIX = ".ptstate"
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
    `latest`) or a checkpoint file; `template_state`, built for the same
    config, receives the tensors on its own device and dtype."""
    state, rng, epoch, replay_json, _ = load_checkpoint_full(path,
                                                             template_state)
    return state, rng, epoch, replay_json


def load_checkpoint_full(path: str, template_state: TrainState):
    """-> (state, rng, epoch, replay_json, extra), the sidecar's `extra` of
    the same checkpoint file."""
    path = _resolve(path)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if blob.get("format") != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of format {FORMAT}")
    template_state.load_state_dict(blob["state"])
    rng = torch.Generator()
    rng.set_state(blob["rng"])
    with open(path + ".json") as f:
        meta = json.load(f)
    return (template_state, rng, int(blob["epoch"]), blob["replay"],
            meta.get("extra") or {})


def peek_meta(path: str) -> Dict[str, Any]:
    """The sidecar (epoch, replay, extra) without reading the tensors, so a
    caller can rebuild the Config before building a template state."""
    with open(_resolve(path) + ".json") as f:
        return json.load(f)


def config_for_checkpoint(path: Optional[str]) -> Config:
    """The Config a checkpoint was trained with (sidecar
    ``extra["config"]``); the defaults for a checkpoint without one, or
    when no path is given."""
    if path:
        try:
            return config_from_dict(peek_meta(path)["extra"]["config"])
        except (KeyError, FileNotFoundError, json.JSONDecodeError):
            pass
    return Config()


def load_reference_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a reference ``chkpt_*.pt`` ('enhance-model', 'intel-model',
    'quality-model', whichever it holds) into G, D and D_Qua with
    ``strict=True``; optimiser states and counters are left as they are."""
    for slot, sd in reference_state_dicts(path).items():
        getattr(state, slot).load_state_dict(sd, strict=True)
    return state
