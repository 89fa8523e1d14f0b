"""Every hook the benchmark holds into the program, in one place.

The training cells read what the port's public surface gives (the
trainer's `StepTimer` report, `ReplayBuffer.state_dict`, the corpus
index's `clean_paths`, `AsyncSaver.barrier`) and, for what it does not
give, wrap a few names of the program:

  * `train.gan.g_step_bands`, `train.gan.d_step_bands` (module attributes
    the training loop calls once a step): each step's rows and frames, and
    the state, losses and first moments of the first steps an epoch;
  * `Trainer._pooled_cn_bands` (a G step's rows) and
    `Trainer._eb_keys_compute` (a D step's rows, with the targets they
    carry), called once a step;
  * `Trainer.timer.phase` (each phase's host interval, for the trace).

`check` looks every one of them up before a run starts and fails with a
message that names the missing one, and `Recorder.verify` fails a run
whose steps went past the wrappers: a program that renames or fuses one
stops the benchmark at set-up, never with an empty comparison.
"""
from __future__ import annotations

import contextlib
import copy
import time
from typing import Dict, List, Optional

import torch

GAN_STEPS = ("g_step_bands", "d_step_bands")
TRAINER_METHODS = ("_pooled_cn_bands", "_eb_keys_compute", "run_epoch")
TRAINER_PUBLIC = ("timer", "replay", "train_index", "state", "paths")


class ProgramChanged(RuntimeError):
    """The program no longer has a name the benchmark hooks."""


def check(gan, trainer) -> None:
    missing = [f"nelegan_tpu_torch.train.gan.{n}" for n in GAN_STEPS
               if not callable(getattr(gan, n, None))]
    missing += [f"Trainer.{n}" for n in TRAINER_METHODS
                if not callable(getattr(trainer, n, None))]
    missing += [f"Trainer.{n}" for n in TRAINER_PUBLIC
                if not hasattr(trainer, n)]
    timer = getattr(trainer, "timer", None)
    missing += [f"StepTimer.{n}" for n in ("phase", "report")
                if not callable(getattr(timer, n, None))]
    if missing:
        raise ProgramChanged(
            "portbench/adapter.py hooks names the program no longer has: "
            + ", ".join(missing) + "; follow the program there")


def _named(model, prefix: str) -> Dict[str, torch.nn.Parameter]:
    return {f"{prefix}.{n}": p for n, p in model.named_parameters()}


def _moments(named, opt) -> Dict[str, torch.Tensor]:
    """Each parameter's Adam first moment (zeros before its first step)."""
    return {k: (opt.state[p]["exp_avg"].detach().clone()
                if p in opt.state and "exp_avg" in opt.state[p]
                else torch.zeros_like(p)) for k, p in named.items()}


class Steps:
    """The first `n` steps of one kind in an epoch, as the program ran them.

    `start`: every model's state dict and each updated model's Adam state
    by parameter name, before the first; `losses`: device scalars;
    `grad1`: the first gradient each parameter's Adam got, from its first
    moment before and after the first step, (m1 - beta1 m0) / (1 - beta1);
    `after`: the updated parameters after the last; `rows`: each step's
    rows as the feed chose them."""

    def __init__(self, parts, n: int):
        self.parts, self.n = parts, n      # ((prefix, model, opt), ...)
        self.calls = 0
        self.losses: List[list] = []
        self.rows: List = []
        self.start = self.grad1 = self.after = None
        self._m0 = None

    def named(self, state):
        out = {}
        for prefix, model, _ in self.parts:
            out.update(_named(getattr(state, model), prefix))
        return out

    def before_step(self, state) -> None:
        if self.calls == 0:
            self.start = {
                "models": {k: copy.deepcopy(getattr(state, k).state_dict())
                           for k in ("gen", "d", "dq")},
                "adam": {prefix: {
                    n: {k: (v.detach().clone() if torch.is_tensor(v) else v)
                        for k, v in getattr(state, opt).state[p].items()}
                    for n, p in getattr(state, model).named_parameters()
                    if p in getattr(state, opt).state}
                    for prefix, model, opt in self.parts}}
            self._m0 = {}
            for prefix, model, opt in self.parts:
                self._m0.update(_moments(_named(getattr(state, model),
                                                prefix), getattr(state, opt)))

    def after_step(self, state, losses) -> None:
        self.losses.append([x.detach() for x in losses])
        if self.calls == 0:
            beta1 = {}
            m1 = {}
            for prefix, model, opt in self.parts:
                o = getattr(state, opt)
                named = _named(getattr(state, model), prefix)
                m1.update(_moments(named, o))
                beta1.update({k: o.param_groups[0]["betas"][0]
                              for k in named})
            self.grad1 = {k: (m1[k] - beta1[k] * self._m0[k])
                          / (1.0 - beta1[k]) for k in m1}
            self._m0 = None
        self.calls += 1
        if self.calls == self.n:
            self.after = {k: v.detach().clone()
                          for k, v in self.named(state).items()}

    def host(self) -> "Steps":
        """The losses as floats (after the run; no sync inside it)."""
        self.losses = [[float(x) for x in step] for step in self.losses]
        return self


G_PARTS = (("gen", "gen", "gen_opt"),)
D_PARTS = (("d", "d", "d_opt"), ("dq", "dq", "dq_opt"))


class Recorder:
    """Wraps the program's step functions and row feeds for one run.

    `arm(n)` starts an epoch's record: its first `n` G and D steps
    (`g`, `d`), every D step's rows and targets (`d_groups`), the first
    `n` G steps' rows; `counting` collects every step's (kind, rows,
    frames) for the FLOP count; `phases` collects the timer's phase
    intervals on the host clock (ns) while `spans` is a list."""

    def __init__(self, gan, trainer):
        check(gan, trainer)
        self.gan, self.trainer = gan, trainer
        self.g: Optional[Steps] = None
        self.d: Optional[Steps] = None
        self.d_groups: List = []
        self.counts: Optional[List] = None
        self.spans: Optional[List] = None
        self.seen = {"g": 0, "d": 0, "g_rows": 0, "d_rows": 0}
        self._orig = {n: getattr(gan, n) for n in GAN_STEPS}
        self._orig_t = {n: getattr(trainer, n) for n in
                        ("_pooled_cn_bands", "_eb_keys_compute")}
        self._orig_phase = trainer.timer.phase
        gan.g_step_bands = self._g_step
        gan.d_step_bands = self._d_step
        trainer._pooled_cn_bands = self._cn_rows
        trainer._eb_keys_compute = self._eb_rows
        trainer.timer.phase = self._phase

    def arm(self, n: int) -> None:
        self.g, self.d = Steps(G_PARTS, n), Steps(D_PARTS, n)
        self.d_groups = []

    def disarm(self) -> None:
        self.g = self.d = None

    def remove(self) -> None:
        for n, f in self._orig.items():
            setattr(self.gan, n, f)
        for n in self._orig_t:
            delattr(self.trainer, n)
        del self.trainer.timer.phase

    def verify(self) -> None:
        """Every wrapped name was called, as the program calls it once a
        step; else the program went past the wrappers."""
        idle = [k for k, v in self.seen.items() if v == 0]
        if idle:
            raise ProgramChanged(
                f"the program's steps went past portbench/adapter.py's "
                f"wrappers ({', '.join(idle)} never called); follow it there")

    # --- wrappers -------------------------------------------------------
    def _g_step(self, state, clean_band, *a, **k):
        self.seen["g"] += 1
        if self.counts is not None:
            self.counts.append(("g", clean_band.shape[0],
                                clean_band.shape[1]))
        rec = self.g if self.g is not None and self.g.calls < self.g.n \
            else None
        if rec is not None:
            rec.before_step(state)
        out = self._orig["g_step_bands"](state, clean_band, *a, **k)
        if rec is not None:
            rec.after_step(state, out[1:])
        return out

    def _d_step(self, state, eband, *a, **k):
        self.seen["d"] += 1
        if self.counts is not None:
            self.counts.append(("d", eband.shape[0], eband.shape[1]))
        rec = self.d if self.d is not None and self.d.calls < self.d.n \
            else None
        if rec is not None:
            rec.before_step(state)
        out = self._orig["d_step_bands"](state, eband, *a, **k)
        if rec is not None:
            rec.after_step(state, out[1:])
        return out

    def _cn_rows(self, group_paths):
        self.seen["g_rows"] += 1
        if self.g is not None and len(self.g.rows) < self.g.n:
            self.g.rows.append(list(group_paths))
        return self._orig_t["_pooled_cn_bands"](group_paths)

    def _eb_rows(self, group, blen):
        self.seen["d_rows"] += 1
        if self.g is not None:
            self.d_groups.append((int(blen), [
                (e.enhanced_path, e.name, [float(s) for s in e.scores])
                for e in group]))
        return self._orig_t["_eb_keys_compute"](group, blen)

    @contextlib.contextmanager
    def _phase(self, name):
        t0 = time.time_ns()
        with self._orig_phase(name):
            yield
        if self.spans is not None:
            self.spans.append((t0, time.time_ns(), f"phase.{name}"))
