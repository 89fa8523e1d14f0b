"""Reference-scale training report: seeds x variants of the GAN trainer,
each metric's best-epoch gain over the untrained generator beside the JAX
package's band.

Counterpart of `tools/multi_seed_report.py`, with
`tools/make_training_report.py`'s per-phase timing of every run.  Each run
trains at a fixed reference-shaped scale (every phase of
train_nele.py:110-429 an epoch, all five metrics scored for D and for
validation) on the JAX report's own synthetic corpus, built by running
`tools/make_synth_corpus.py` (seed 1234) when `--corpus` is empty.  Runs go
seed-outer, variant-inner, each under `run_with_recovery` in a run
directory keyed by variant, seed, epochs and utterances; the untrained
baseline (`validate(epoch=0)`) is kept beside the run and survives a
resume.  `multiseed.json` and `MULTISEED.md` are written after every run,
and a killed campaign resumes, skipping the seeds it has recorded.

    python -m nelegan_tpu_torch.cli.train_report \\
        [--seeds 101,202,303] [--epochs 30] [--variants b8_f32,b64_bf16] \\
        [--n-train 300] [--n-test 16] [--n-valid 16] [--corpus DIR] \\
        [--out artifacts/train_report_torch] \\
        [--work build/train_report_torch] \\
        [--device cuda]

The seeds do not carry over from the JAX package (`torch.Generator`
against JAX's PRNG): compare the bands, not the bits.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from nelegan_tpu_torch.metrics import ALL_METRICS as METRICS

REPO = Path(__file__).resolve().parents[2]
# the JAX package's campaign, whose gains give each variant's band
JAX_REPORT = REPO / "artifacts" / "train_report" / "multiseed.json"
CORPUS_SEED = 1234
# variant -> (batch size, compute dtype), as tools/multi_seed_report.py's
VARIANTS = {"b8_f32": (8, "float32"), "b64_bf16": (64, "bfloat16")}


def ensure_corpus(corpus: str, n_train: int, n_test: int) -> None:
    """The JAX report's synthetic corpus in `corpus`, built once by its own
    tool (a marker file records the build)."""
    marker = os.path.join(corpus, f".synth_{n_train}_{n_test}_{CORPUS_SEED}")
    if os.path.exists(marker):
        return
    tool = REPO / "tools" / "make_synth_corpus.py"
    subprocess.run([sys.executable, str(tool), corpus, "--n-train",
                    str(n_train), "--n-test", str(n_test), "--seed",
                    str(CORPUS_SEED)], check=True)
    open(marker, "w").close()


def card(dev) -> str:
    """The device a run trained on: a card's name and power limit as
    nvidia-smi prints them, or "cpu"."""
    if dev.type != "cuda":
        return dev.type
    import torch
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
        return out[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def run_one(corpus: str, run_dir: str, seed: int, epochs: int,
            n_sampling: int, n_valid: int, variant: str, dev) -> dict:
    """One seed of one variant, to `epochs` -> its record."""
    from nelegan_tpu_torch.config import Config, ModelConfig, TrainConfig
    from nelegan_tpu_torch.train.loop import Trainer, TrainPaths
    from nelegan_tpu_torch.train.resilience import run_with_recovery

    batch, dtype = VARIANTS[variant]
    cfg = Config(train=TrainConfig(gan_epochs=epochs, num_sampling=n_sampling,
                                   num_valid=n_valid, batch_size=batch,
                                   seed=seed),
                 model=ModelConfig(compute_dtype=dtype))
    paths = TrainPaths(
        train_clean=os.path.join(corpus, "Train", "Clean"),
        train_noise=os.path.join(corpus, "Train", "Noise"),
        test_clean=os.path.join(corpus, "Test", "Clean"),
        test_noise=os.path.join(corpus, "Test", "Noise"),
        train_enhanced=os.path.join(corpus, "Train", "MultiEnh"),
        output=os.path.join(run_dir, "output"),
        checkpoints=os.path.join(run_dir, "chkpt"),
        log_file=os.path.join(run_dir, "log.txt"))
    os.makedirs(run_dir, exist_ok=True)
    base_path = os.path.join(run_dir, "baseline.json")
    first_epoch = []

    def make_trainer():
        trainer = Trainer(paths, cfg, metric_set=METRICS,
                          valid_metric_set=METRICS, device=dev)
        # a killed campaign's run resumes where it stopped; later attempts
        # are resumed by run_with_recovery
        if not first_epoch and os.path.exists(
                os.path.join(paths.checkpoints, "latest")):
            trainer.resume(truncate_log=True)
        first_epoch.append(trainer.start_epoch)
        if trainer.start_epoch == 1 and not os.path.exists(base_path):
            baseline = trainer.validate(epoch=0)    # the untrained G
            for m in METRICS:               # not a point of the curves
                trainer.history[m].pop()
            with open(base_path, "w") as f:
                json.dump(baseline, f)
        return trainer

    t0 = time.time()
    trainer = run_with_recovery(make_trainer, epochs)
    wall = time.time() - t0
    with open(base_path) as f:
        baseline = json.load(f)
    history = {m: list(v) for m, v in trainer.history.items()}
    best = {m: float(max(v)) for m, v in history.items() if v}
    best_ep = {m: int(np.argmax(v)) + 1 for m, v in history.items() if v}
    ran = epochs + 1 - first_epoch[0]
    return {"seed": seed, "baseline": baseline, "best": best,
            "best_epoch": best_ep, "history": history,
            "wall_s": wall, "s_per_epoch": wall / max(ran, 1),
            "epochs_this_call": ran, "timing": trainer.timer.report(),
            "device": card(trainer.dev)}


def gains(runs: list, m: str) -> np.ndarray:
    """Each run's best-epoch gain over its untrained baseline, percent."""
    base = np.array([r["baseline"][m] for r in runs])
    best = np.array([r["best"][m] for r in runs])
    return 100.0 * (best - base) / np.maximum(np.abs(base), 1e-9)


def jax_bands(path: Path = JAX_REPORT) -> dict:
    """variant -> metric -> (low, high): the JAX campaign's gain mean -/+
    two spreads over its seeds; {} without its report."""
    if not path.exists():
        return {}
    with open(path) as f:
        variants = json.load(f)["variants"]
    bands = {}
    for v, runs in variants.items():
        if runs:
            bands[v] = {}
            for m in METRICS:
                g = gains(runs, m)
                bands[v][m] = (g.mean() - 2 * g.std(), g.mean() + 2 * g.std())
    return bands


def render_md(results: dict, out_md: str, bands: dict) -> None:
    lines = ["# Multi-seed training campaign: the PyTorch/CUDA port",
             "",
             f"Scale: {results['epochs']} epochs x {results['n_sampling']} "
             f"sampled utterances/epoch, {results['n_valid']} validation "
             "utterances, 3 D passes, all 5 metrics scored every epoch for D "
             "and validation (reference train_nele.py scale on the "
             "synthetic corpus of `tools/make_synth_corpus.py`, seed "
             f"{CORPUS_SEED}).  Regenerate: `python -m "
             "nelegan_tpu_torch.cli.train_report`.  The JAX band is the "
             "JAX package's gain mean -/+ 2 spreads over its seeds "
             f"(`{JAX_REPORT.relative_to(REPO)}`).",
             ""]
    for variant, runs in results["variants"].items():
        if not runs:
            continue
        b, dt = VARIANTS[variant]
        spe = [r["s_per_epoch"] for r in runs]
        lines += [f"## {variant} (batch {b}, {dt})", "",
                  f"{len(runs)} seeds: "
                  + ", ".join(str(r["seed"]) for r in runs)
                  + f"; {min(spe):.1f}-{max(spe):.1f} s/epoch on "
                  + "; ".join(sorted({r["device"] for r in runs})),
                  "",
                  "| metric | untrained (mean) | best (mean +/- spread) "
                  "| gain % (mean +/- spread) | min gain % "
                  "| JAX gain % band | in band |",
                  "|---|---|---|---|---|---|---|"]
        for m in METRICS:
            base = np.array([r["baseline"][m] for r in runs])
            best = np.array([r["best"][m] for r in runs])
            g = gains(runs, m)
            band = bands.get(variant, {}).get(m)
            where = ("-" if band is None else
                     "yes" if band[0] <= g.mean() <= band[1] else "no")
            lines.append(
                f"| {m} | {base.mean():.4f} | {best.mean():.4f} "
                f"+/- {best.std():.4f} | {g.mean():+.1f} "
                f"+/- {g.std():.1f} | {g.min():+.1f} | "
                + ("-" if band is None else
                   f"{band[0]:+.1f} to {band[1]:+.1f}") + f" | {where} |")
        phases = sorted({k for r in runs for k in r["timing"]})
        lines += ["", "Mean seconds of each phase an epoch (g_train from "
                  "epoch 2), by seed: " + "; ".join(
                      f"{r['seed']}: " + ", ".join(
                          f"{k} {r['timing'][k]['mean_s']:.2f}"
                          for k in phases if k in r["timing"])
                      for r in runs), ""]
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", default="101,202,303")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--variants", default="b8_f32,b64_bf16")
    p.add_argument("--n-train", type=int, default=300,
                   help="training utterances, all sampled every epoch")
    p.add_argument("--n-test", type=int, default=16)
    p.add_argument("--n-valid", type=int, default=16)
    p.add_argument("--corpus", default="",
                   help="a corpus in the reference layout; empty: the "
                        "synthetic corpus, built under --work")
    p.add_argument("--out", default=str(REPO / "artifacts"
                                        / "train_report_torch"))
    p.add_argument("--work", default=str(REPO / "build"
                                         / "train_report_torch"),
                   help="the built corpus and the runs' directories")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a GPU pass 'cpu' explicitly")
    return p


def main(argv=None) -> dict:
    """Runs the campaign; returns its results (as in multiseed.json)."""
    args = build_parser().parse_args(argv)
    import torch

    from nelegan_tpu_torch.device import disable_tf32, resolve_device

    dev = resolve_device(args.device)
    disable_tf32()                  # as cli/train trains
    torch.backends.cudnn.deterministic = True
    corpus = args.corpus or os.path.join(
        args.work, f"corpus_{args.n_train}_{args.n_test}")
    if not args.corpus:
        ensure_corpus(corpus, args.n_train, args.n_test)
    os.makedirs(args.out, exist_ok=True)
    out_json = os.path.join(args.out, "multiseed.json")
    results = {"epochs": args.epochs, "n_sampling": args.n_train,
               "n_valid": args.n_valid, "variants": {}}
    if os.path.exists(out_json):        # resume a killed campaign
        with open(out_json) as f:
            prev = json.load(f)
        if all(prev.get(k) == results[k]
               for k in ("epochs", "n_sampling", "n_valid")):
            results = prev
    bands = jax_bands()
    for seed in (int(s) for s in args.seeds.split(",") if s):
        for variant in args.variants.split(","):
            runs = results["variants"].setdefault(variant, [])
            if seed in {r["seed"] for r in runs}:
                print(f"[skip] {variant} seed {seed} (already recorded)",
                      flush=True)
                continue
            run_dir = os.path.join(
                args.work, "runs",
                f"{variant}_s{seed}_{args.epochs}ep_{args.n_train}n")
            print(f"[run] {variant} seed {seed} ...", flush=True)
            r = run_one(corpus, run_dir, seed, args.epochs, args.n_train,
                        args.n_valid, variant, dev)
            runs.append(r)
            with open(out_json, "w") as f:
                json.dump(results, f, indent=1)
            render_md(results, os.path.join(args.out, "MULTISEED.md"), bands)
            print(f"[done] {variant} seed {seed}: best "
                  + ", ".join(f"{m}={r['best'][m]:.3f}" for m in METRICS)
                  + f" ({r['wall_s']:.0f} s, {r['device']})", flush=True)
    print("campaign complete:", out_json, flush=True)
    return results


if __name__ == "__main__":
    main()
