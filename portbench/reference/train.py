"""The reference side of a training cell's comparison.

`Reference.records` works out again what the program's set-up and window
produced, in three parts:

  * from the seed alone (the start): the initial generator and
    discriminators, drawn from the seed (`models.draw_models`, the port's
    order and float64 host draw); each row's bands and noise PSD
    (`pipeline.featurize_batch`, the plain IMCRA loop); the enhanced PCM16
    of the drawn generator; the five calibrated scores of the rows the
    first discriminator steps take (`metrics.score_rows`); every
    discriminator step of epoch 1 with its own Adam, and from the
    discriminators that gives, the first generator steps of epoch 2
    (`g_own`; `replay`).  The rows of each step are the feed's choice,
    read from the program; so are the targets of the rows the reference
    does not score itself (the scores of a sample of them are compared on
    their own);
  * the first generator steps of epoch 2 from the drawn generator and the
    discriminators the program held there (`g`): in float32 the replay of
    epoch 1's 231 D steps drifts from the program's by float32 round-off
    grown through Adam as far as a TF32 run does, so there the G steps are
    followed from the program's state;
  * from the program's state inside the window (followed step by step,
    as the program holds it): the first discriminator and generator steps
    of the window's last epoch, from the models and Adam state the
    program held before them and the files and targets that epoch fed;
  * the PCM16 of the window's last epoch, from the generator the program
    holds at its end, and the scores of the files the program wrote.

`precision="lower"` computes the same with TF32 on (a float32
configuration) or with float8 (e4m3) rounding at every bfloat16 cast (a
bfloat16 one): the control.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import models
from portbench.reference.config import config_from_dict
from portbench.reference.metrics import score_rows
from portbench.reference.pipeline import (eband_from_enhanced,
                                          enhance_batch, featurize_batch,
                                          pcm16_quantize_i16,
                                          reflect_pad_batch, speech_band)
from portbench.reference.steps import d_step, g_step
from portbench.traffic.corpus import read_pcm


def bucket(n: int, quant: int = 4096) -> int:
    return -(-n // quant) * quant


def leaf_norms(named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in named.items()}


def _params(model, prefix):
    return {f"{prefix}.{n}": p for n, p in model.named_parameters()}


def _fp8_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).to(dtype)


def file_key(path: str) -> str:
    return os.path.basename(path)


def program_records(program: dict) -> dict:
    """The program's side, in the form `records` gives."""
    rec = {"pcm": {}, "scores": {}}
    for tag, steps in (("d", program["epoch1"]["d"]),
                       ("g", program["epoch2"]["g"]),
                       ("g_own", program["epoch2"]["g"]),
                       ("win_d", program["window"]["d"]),
                       ("win_g", program["window"]["g"])):
        named0 = {f"{prefix}.{k}": v
                  for prefix, model, _ in steps.parts
                  for k, v in steps.start["models"][model].items()
                  if f"{prefix}.{k}" in steps.after}
        rec[f"{tag}_losses"] = steps.losses
        rec[f"{tag}_grad1"] = leaf_norms(steps.grad1)
        rec[f"{tag}_change"] = leaf_norms({k: steps.after[k] - named0[k]
                                           for k in steps.after})
    for path in compared_files(program):
        rec["pcm"][file_key(path)] = (read_pcm(path) * 32768).astype(np.int32)
        rec["scores"][file_key(path)] = np.asarray(program["scores"][path])
    return rec


def compared_files(program: dict) -> List[str]:
    """The PCM16 files the comparison reads: epoch 1's of the rows the first
    discriminator steps took and of the sample, the last epoch's of the
    sample."""
    first, last = program["epochs"]
    disc = program["disc_dir"]
    n = program["epoch1"]["d"].n
    names = {e[1] for _, group in program["epoch1"]["d_groups"][:n]
             for e in group if os.path.dirname(e[0]) == disc}
    out = []
    for epoch, rows in ((first, sorted(names | set(program["sample"]))),
                        (last, program["sample"])):
        out += [os.path.join(disc, f"{n[:-4]}@{epoch}{n[-4:]}") for n in rows]
    return out


class Reference:

    def __init__(self, config: dict, port_cfg, dirs: dict, device):
        cfg = config_from_dict(config)
        t = port_cfg.train
        self.cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, seed=t.seed, batch_size=t.batch_size,
            num_sampling=t.num_sampling, num_valid=t.num_valid))
        self.dirs = dirs
        self.dev = torch.device(device)
        self._sig: Dict[str, tuple] = {}
        self._bands: Dict[tuple, tuple] = {}
        self._ebands: Dict[tuple, torch.Tensor] = {}
        self.fault = None

    @contextlib.contextmanager
    def precision(self, which: str):
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32,
                 torch.backends.cudnn.deterministic)
        lower = which == "lower"
        bf16 = self.cfg.model.compute_dtype == "bfloat16"
        torch.backends.cuda.matmul.allow_tf32 = lower and not bf16
        torch.backends.cudnn.allow_tf32 = lower and not bf16
        torch.backends.cudnn.deterministic = True
        models.set_cast(_fp8_cast if lower and bf16 else None)
        self._bands.clear()
        self._ebands.clear()
        try:
            yield
        finally:
            models.set_cast(None)
            self._bands.clear()
            self._ebands.clear()
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic) = flags

    # --- inputs -------------------------------------------------------
    def signals(self, name: str):
        """(clean, noise) of a training utterance, trimmed to the shorter."""
        if name not in self._sig:
            c = read_pcm(os.path.join(self.dirs["train_clean"], name))
            n = read_pcm(os.path.join(self.dirs["train_noise"], name))
            m = min(len(c), len(n))
            self._sig[name] = (c[:m], n[:m])
        return self._sig[name]

    def featurize(self, names: List[str], blen: int):
        sig = [self.signals(n) for n in names]
        cp, lens = reflect_pad_batch([c for c, _ in sig], blen)
        npad, _ = reflect_pad_batch([n for _, n in sig], blen)
        return featurize_batch(cp, npad, lens, self.cfg.train.p_power,
                               self.cfg.imcra, device=self.dev)

    def bands(self, names: List[str], blen: int):
        """(clean_band, noise_band, frames) of `names` at bucket `blen`,
        each row featurized once a precision and kept."""
        todo = sorted({n for n in names if (n, blen) not in self._bands})
        for i in range(0, len(todo), 64):
            rows = todo[i:i + 64]
            f = self.featurize(rows, blen)
            for j, n in enumerate(rows):
                self._bands[(n, blen)] = (f.clean_band[j], f.noise_band[j],
                                          f.frames[j])
        got = [self._bands[(n, blen)] for n in names]
        return tuple(torch.stack([g[k] for g in got]) for k in range(3))

    @torch.no_grad()
    def enhance(self, gen, names: List[str]) -> Dict[str, np.ndarray]:
        """name -> the int16 samples the program's file of it would hold,
        each utterance enhanced at its own bucket."""
        out = {}
        by_bucket: Dict[int, List[str]] = {}
        for n in names:
            by_bucket.setdefault(bucket(len(self.signals(n)[0])), []).append(n)
        for blen, rows in sorted(by_bucket.items()):
            for i in range(0, len(rows), 64):
                part = rows[i:i + 64]
                feats = self.featurize(part, blen)
                wav, _, out_len = enhance_batch(gen, feats,
                                                self.cfg.train.p_power,
                                                self.cfg.train.target_rms,
                                                device=self.dev)
                q = pcm16_quantize_i16(wav).cpu().numpy().astype(np.int32)
                for j, n in enumerate(part):
                    out[n] = q[j, :int(out_len[j])]
        return out

    def scores(self, rows) -> np.ndarray:
        """[len(rows), 5] calibrated scores of (name, enhanced) rows."""
        out = score_rows([self.signals(n) + (e,) for n, e in rows], self.dev)
        if self.fault == "altered_answer":
            out[:, 1] += 0.02
        return out

    def eband(self, path: str, blen: int, enhanced) -> torch.Tensor:
        """[1, blen frames, 64] bands of one D row: `enhanced` (float32
        samples) a written file's PCM16 as the program feeds it, None a
        pre-enhanced corpus file, read and reflect-padded."""
        key = (path, blen)
        if key not in self._ebands:
            p = self.cfg.train.p_power
            if enhanced is not None:
                row = torch.zeros(1, blen, device=self.dev)
                row[0, :len(enhanced)] = torch.from_numpy(enhanced).to(
                    self.dev)
                self._ebands[key] = eband_from_enhanced(
                    row, torch.tensor([len(enhanced)], device=self.dev), p)
            else:
                ep, _ = reflect_pad_batch([read_pcm(path)[:blen]], blen)
                self._ebands[key] = speech_band(
                    torch.from_numpy(ep).to(self.dev), p)
        return self._ebands[key]

    # --- the steps ----------------------------------------------------
    def _rows(self, n_real: int) -> torch.Tensor:
        """The row mask of a step: real rows 1, shape padding 0; under the
        planted fault "half_batch" the second half of the batch is left
        out too, the mean taken over the rest."""
        bs = self.cfg.train.batch_size
        rv = torch.tensor([1.0] * n_real + [0.0] * (bs - n_real),
                          device=self.dev)
        if self.fault == "half_batch":
            rv[bs // 2:] = 0.0
        return rv

    def _adams(self, parts, start):
        """Adam over each model, its state the program's `start` (by
        parameter name) where one is given."""
        lrs = {"gen": self.cfg.train.lr_g, "d": self.cfg.train.lr_d,
               "dq": self.cfg.train.lr_dqua}
        opts = []
        for prefix, model in parts:
            opt = torch.optim.Adam(model.parameters(), lr=lrs[prefix])
            if start is not None:
                for n, p in model.named_parameters():
                    st = start["adam"][prefix].get(n)
                    if st is not None:
                        opt.state[p] = {k: (v.clone() if torch.is_tensor(v)
                                            else v) for k, v in st.items()}
            opts.append(opt)
        return opts

    def follow_d(self, d, dq, groups, n: int, pcm_of, target_of,
                 start=None):
        """Discriminator steps over `groups` (every one given), from `d`,
        `dq` and, with `start`, the program's Adam state; -> the first `n`
        steps' losses, the first gradient, the change after `n` steps."""
        bs = self.cfg.train.batch_size
        d_opt, dq_opt = self._adams((("d", d), ("dq", dq)), start)
        named = {**_params(d, "d"), **_params(dq, "dq")}
        before = {k: v.detach().clone() for k, v in named.items()}
        losses, grad1, change = [], None, None
        for i, (blen, group) in enumerate(groups):
            n_real = len(group)
            padded = list(group) + [group[-1]] * (bs - n_real)
            eband = torch.cat([self.eband(path, blen, pcm_of(path, name))
                               for path, name, _ in padded])
            tg = torch.tensor(np.array([target_of(path, name, s)
                                        for path, name, s in padded],
                                       np.float32), device=self.dev)
            cb, nb, fr = self.bands([e[1] for e in padded], blen)
            out = d_step(d, d_opt, dq, dq_opt, eband, nb, cb, fr, tg[:, :3],
                         tg[:, 3:5], self._rows(n_real))
            if i < n:
                losses.append(list(out))
            if i == 0:
                grad1 = leaf_norms({k: v.grad if v.grad is not None
                                    else torch.zeros_like(v)
                                    for k, v in named.items()})
            if i == n - 1:
                change = leaf_norms({k: named[k].detach() - before[k]
                                     for k in named})
        return losses, grad1, change

    def follow_g(self, gen, d, dq, rows, start=None):
        """The generator steps over `rows` (path groups), from `gen`, `d`,
        `dq` and, with `start`, the program's Adam state."""
        cfg = self.cfg
        bs = cfg.train.batch_size
        (opt,) = self._adams((("gen", gen),), start)
        named = _params(gen, "gen")
        before = {k: v.detach().clone() for k, v in named.items()}
        losses, grad1 = [], None
        for group in rows:
            names = [os.path.basename(x) for x in group]
            n_real = len(names)
            names += [names[-1]] * (bs - n_real)
            blen = bucket(max(len(self.signals(n)[0]) for n in names))
            cb, nb, fr = self.bands(names, blen)
            losses.append([g_step(gen, opt, d, dq, cb, nb, fr,
                                  self._rows(n_real), cfg.train.p_power,
                                  cfg.train.inv_p, cfg.train.weight_qua)])
            if grad1 is None:
                grad1 = leaf_norms({k: v.grad for k, v in named.items()})
        change = leaf_norms({k: named[k].detach() - before[k] for k in named})
        return losses, grad1, change

    def records(self, program: dict, precision: str = "stated",
                fault: str | None = None, replay: bool = True) -> dict:
        """The reference's records; `fault` plants one of the faults the
        limits are read against: "half_batch", or "altered_answer" (ten
        samples of the first enhanced row 40 LSB up where it is produced,
        and every HASPI target 0.02 up).  `replay`: follow every D step of
        epoch 1 and from there epoch 2's G steps (`g_own_*`)."""
        self.fault = fault
        try:
            return self._records(program, precision, replay)
        finally:
            self.fault = None

    def _records(self, program: dict, precision: str, replay: bool) -> dict:
        cfg = self.cfg
        first, last = program["epochs"]
        disc = program["disc_dir"]
        files = compared_files(program)
        e1, e2, win = program["epoch1"], program["epoch2"], program["window"]
        n = e1["d"].n
        rec = {"pcm": {}, "scores": {}}
        with self.precision(precision):
            gen, d, dq = models.draw_models(cfg.model, cfg.train.seed,
                                            self.dev)
            # epoch 1 from the seed: the drawn generator's PCM16 of every
            # row the discriminators take, the reference's own scores of
            # the first steps' rows, every D step, then epoch 2's G steps
            need = sorted({name for _, group in e1["d_groups"]
                           for path, name, _ in group
                           if os.path.dirname(path) == disc}
                          | set(program["sample"]))
            pcm1 = self.enhance(gen, need)
            if self.fault == "altered_answer":
                k = sorted(os.path.basename(f).split("@")[0] + ".wav"
                           for f in files if f.endswith(f"@{first}.wav"))[0]
                pcm1[k] = pcm1[k].copy()
                pcm1[k][1000:1010] += 40

            def own_pcm(path, name):
                if os.path.dirname(path) != disc:
                    return None
                return pcm1[name].astype(np.float32) / np.float32(32768)

            first_rows = {(path, name): blen
                          for blen, group in e1["d_groups"][:n]
                          for path, name, _ in group}
            scored = sorted(first_rows)
            own = dict(zip(scored, self.scores([
                (name, own_pcm(path, name) if os.path.dirname(path) == disc
                 else read_pcm(path)[:first_rows[(path, name)]])
                for path, name in scored])))

            def target(path, name, program_scores):
                s = own.get((path, name))
                return program_scores if s is None else s

            # epoch 2's first G steps from the drawn generator and the
            # discriminators the program held there
            sg = e2["g"].start
            gen2 = copy.deepcopy(gen)
            d2, dq2 = (m.to(self.dev) for m in models.discriminators(
                cfg.model))
            d2.load_state_dict(sg["models"]["d"])
            dq2.load_state_dict(sg["models"]["dq"])
            (rec["g_losses"], rec["g_grad1"],
             rec["g_change"]) = self.follow_g(gen2, d2, dq2, e2["g"].rows)
            del gen2, d2, dq2
            groups = e1["d_groups"] if replay else e1["d_groups"][:n]
            (rec["d_losses"], rec["d_grad1"],
             rec["d_change"]) = self.follow_d(d, dq, groups, n, own_pcm,
                                              target)
            if replay:
                (rec["g_own_losses"], rec["g_own_grad1"],
                 rec["g_own_change"]) = self.follow_g(gen, d, dq,
                                                      e2["g"].rows)

            # the window's last epoch, from the program's state there
            def file_pcm(path, name):
                return read_pcm(path) if os.path.dirname(path) == disc \
                    else None

            def fed(path, name, program_scores):
                return program_scores

            sd, sg = win["d"].start, win["g"].start
            d.load_state_dict(sd["models"]["d"])
            dq.load_state_dict(sd["models"]["dq"])
            (rec["win_d_losses"], rec["win_d_grad1"],
             rec["win_d_change"]) = self.follow_d(
                d, dq, win["d_groups"][:win["d"].n], win["d"].n, file_pcm,
                fed, start=sd)
            gen.load_state_dict(sg["models"]["gen"])
            d.load_state_dict(sg["models"]["d"])
            dq.load_state_dict(sg["models"]["dq"])
            (rec["win_g_losses"], rec["win_g_grad1"],
             rec["win_g_change"]) = self.follow_g(gen, d, dq, win["g"].rows,
                                                  start=sg)

            last_gen = models.Generator(cfg.model).to(self.dev)
            last_gen.load_state_dict(program["gen_last"])
            pcm_last = self.enhance(last_gen, program["sample"])
            rows = []
            for path in files:
                name = os.path.basename(path).split("@")[0] + ".wav"
                epoch = int(os.path.basename(path).split("@")[1][:-4])
                rec["pcm"][file_key(path)] = (pcm1 if epoch == first
                                              else pcm_last)[name]
                rows.append((name, read_pcm(path)))
            for path, s in zip(files, self.scores(rows)):
                rec["scores"][file_key(path)] = s
        return rec
