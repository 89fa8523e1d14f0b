"""Traffic kind `gan_epochs`: whole GAN epochs of the port's `Trainer`.

Set-up makes the corpus from the seed, builds one `Trainer` (its state
drawn from the seed by the port's own draw) and runs its epochs 1 and 2,
which warm every shape the window uses: epoch 1 takes no generator step,
epoch 2 the first.  The window then runs `Trainer.run_epoch` from epoch 3
until `--seconds` have passed; the epoch running then finishes and counts,
and so does the checkpoint its end queued.  `train_utts_per_s` is the
utterances sampled (`num_sampling` an epoch) over the window.  The
window's per-layer numbers come from the same untraced epochs: the
trainer's `StepTimer` phases and every step's rows and frames.  A traced
run then runs one more epoch under the profiler (the device's activity
only) for the idle share and the breakdown.

The comparison with the plain reference (`reference/train.py`) covers:

  * from the seed: the first three discriminator steps of epoch 1; the
    first three generator steps of epoch 2, from the drawn generator and
    the discriminators the program held there, and where the cell lists
    it (`g_own_*`), from the discriminators the reference's own replay of
    all of epoch 1's discriminator steps gives: the loss of each, the
    first gradient as Adam got it (from its first moment), the change of
    the weights after three steps;
  * inside the window: the same of the first three discriminator and
    generator steps of its last epoch, from the program's state before
    them;
  * the PCM16 files the epochs wrote for the discriminators: epoch 1's
    (the generator as drawn) and the window's last epoch's (the
    generator the program holds at the end, its own state);
  * the five calibrated scores that became the discriminators' targets,
    against the reference's scores of the same files.

`portbench/adapter.py` holds every hook this takes into the program.  The
reference runs after the window, once the peak memory is read and the
program's state is freed.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import time

import numpy as np
import torch

from portbench import adapter, compare, trace
from portbench.traffic import corpus


def port_config(ctx):
    from nelegan_tpu_torch.config import config_from_dict
    cfg = config_from_dict(ctx.config)
    t = ctx.traffic
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=int(ctx.seed), batch_size=int(t["batch_size"]),
        num_sampling=int(t["num_sampling"]), num_valid=int(t["num_valid"])))


def _phases(timer) -> dict:
    return {k: v["total_s"] for k, v in timer.report().items()}


def _since(timer, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in _phases(timer).items()}


def run(ctx, control: bool = False) -> None:
    from nelegan_tpu_torch import kernels
    from nelegan_tpu_torch.device import disable_tf32
    from nelegan_tpu_torch.train import gan
    from nelegan_tpu_torch.train.checkpoint import AsyncSaver
    from nelegan_tpu_torch.train.loop import Trainer, TrainPaths

    t = ctx.traffic
    dev = ctx.device
    t_setup = time.perf_counter()
    # as cli/train runs: TF32 off, deterministic cuDNN
    disable_tf32()
    torch.backends.cudnn.deterministic = True
    if dev.type == "cuda":
        kernels.build()
        torch.cuda.synchronize(dev)         # the context exists
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = port_config(ctx)
    parts = ctx.layer.setdefault("setup_parts", {})
    parts["build_s"] = time.perf_counter() - t_setup
    dirs = corpus.write_corpus(os.path.join(ctx.tmp, "corpus"), ctx.seed,
                               t["n_train"], t["n_test"], t["len_s"], dev)
    parts["corpus_s"] = time.perf_counter() - t_setup - parts["build_s"]
    paths = TrainPaths(
        train_clean=dirs["train_clean"], train_noise=dirs["train_noise"],
        test_clean=dirs["test_clean"], test_noise=dirs["test_noise"],
        train_enhanced=dirs["train_multi_enh"],
        output=os.path.join(ctx.tmp, "out"),
        checkpoints=os.path.join(ctx.tmp, "chkpt"),
        log_file=os.path.join(ctx.tmp, "log.txt"))
    trainer = Trainer(paths, cfg, metric_set=tuple(t["metrics"]), device=dev)
    n = int(t["follow_steps"])
    rec = adapter.Recorder(gan, trainer)
    if ctx.fault is not None:
        ctx.fault("trainer", trainer)
    rec.arm(n)
    t1 = time.perf_counter()
    trainer.run_epoch(1)
    parts["epoch1_s"] = time.perf_counter() - t1
    epoch1 = {"d": rec.d, "d_groups": rec.d_groups}
    parts["epoch1_d_steps"] = len(rec.d_groups)
    rec.arm(n)
    t1 = time.perf_counter()
    trainer.run_epoch(2)
    parts["epoch2_s"] = time.perf_counter() - t1
    epoch2 = {"g": rec.g}
    rec.verify()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_setup

    # the window: whole epochs from 3; each re-arms the record of its
    # first steps (the last epoch's stays) and counts every step
    epoch = 3
    rec.counts = []
    before = _phases(trainer.timer)
    t0 = time.perf_counter()
    while True:
        rec.arm(n)
        trainer.run_epoch(epoch)
        epoch += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    AsyncSaver.barrier(paths.checkpoints)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    n_epochs = epoch - 3
    window = {"d": rec.d, "g": rec.g, "d_groups": rec.d_groups}
    rec.disarm()
    ctx.layer["window"] = {
        "epochs": n_epochs, "window_s": window_s,
        "phases_s": _since(trainer.timer, before), "steps": rec.counts}
    rec.counts = None
    ctx.attempted = n_epochs * cfg.train.num_sampling
    if dev.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    ctx.report("train_utts_per_s", ctx.attempted / window_s, "utts/s")
    ctx.report("setup_s", setup_s, "s")
    ctx.layer["model"] = ctx.config["model"]
    last = epoch - 1
    # the generator that wrote the last window epoch's files
    gen_last = {k: v.detach().cpu().clone()
                for k, v in trainer.state.gen.state_dict().items()}

    if ctx.trace:
        # one more epoch under the profiler, the device's activity only;
        # each trainer phase a host span
        with trace.Window(dev) as tw:
            rec.spans = tw.spans
            trainer.run_epoch(epoch)
            AsyncSaver.barrier(paths.checkpoints)
        rec.spans = None
        ctx.window = tw
        ctx.layer["traced_epoch_s"] = tw.window_s
        ctx.layer["untraced_epoch_s"] = window_s / n_epochs

    # --- what the comparison reads of the program, then its state freed
    rng = np.random.default_rng([ctx.seed, 17])
    names = sorted(os.path.basename(p)
                   for p in trainer.train_index.clean_paths)
    sample = sorted(rng.choice(len(names), int(t["sample_rows"]),
                               replace=False).tolist())
    sample = [names[i] for i in sample]
    disc_dir = os.path.join(paths.output, "For_discriminator_training")
    program = {
        "epoch1": epoch1, "epoch2": {"g": epoch2["g"].host()},
        "window": {"d": window["d"].host(), "g": window["g"].host(),
                   "d_groups": window["d_groups"]},
        "gen_last": gen_last,
        "scores": {e["enhanced_path"]: list(e["scores"])
                   for e in json.loads(trainer.replay.state_dict())},
        "disc_dir": disc_dir, "epochs": (1, last), "sample": sample,
    }
    epoch1["d"].host()
    rec.remove()
    del trainer, rec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from portbench.reference import train as ref_train
    ref = ref_train.Reference(ctx.config, cfg, dirs, dev)
    rec_p = ref_train.program_records(program)
    t1 = time.perf_counter()
    # the replay of epoch 1 runs where the cell compares what it gives
    replay = control or any(k.startswith("g_own_")
                            for k in ctx.checks.limits)
    rec_r = ref.records(program, precision="stated", replay=replay)
    ctx.layer["reference_s"] = time.perf_counter() - t1
    compare.train_checks(ctx.checks, rec_p, rec_r)
    if control:
        ctx.layer["program"] = dict(
            compare.train_numbers(rec_p, rec_r),
            by_metric=compare.score_gaps_by_metric(rec_p["scores"],
                                                   rec_r["scores"]))
        ctx.layer["control"] = compare.train_numbers(
            ref.records(program, precision="lower"), rec_r)
        ctx.layer["faults"] = {
            f: compare.train_numbers(ref.records(program, fault=f), rec_r)
            for f in ("half_batch", "altered_answer")}
