"""Reverb-condition evaluation CLI.

Counterpart of `nelegan_tpu/cli/eval_reverb.py` (the reference's
`python eval_metrics.py`): a trained generator enhances a test corpus on
the card, and each condition (no reverb, or an RIR wav) is scored raw on
(direct-path clean, reverberant enhanced + noise) by `metrics.score_batch`.

    python -m nelegan_tpu_torch.cli.eval_reverb \\
        --test-clean ... --test-noise ... --checkpoint ./chkpt \\
        [--rir NO_rev] [--rir path/to/rir.wav ...] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from nelegan_tpu_torch import pipeline
from nelegan_tpu_torch.data.pipeline import (BucketedLoader, CorpusIndex,
                                             get_filepaths)
from nelegan_tpu_torch.data.wavio import read_wav
from nelegan_tpu_torch.device import disable_tf32, resolve_device
from nelegan_tpu_torch.dsp.reverb import (clip_overflow, direct_path_rir,
                                          fir_filter)
from nelegan_tpu_torch.metrics import score_batch
from nelegan_tpu_torch.train.checkpoint import load_generator


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--test-clean", required=True)
    p.add_argument("--test-noise", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir, .ptstate or .msgpack file")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference chkpt_GD.pt")
    p.add_argument("--rir", action="append", default=None,
                   help="'NO_rev' or an RIR wav path; repeatable")
    p.add_argument("--num-utts", type=int, default=720)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--tau", type=int, default=32,
                   help="direct-path taps past the RIR peak")
    p.add_argument("--metrics", default="siib,haspi,estoi")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a GPU pass 'cpu' explicitly")
    return p


def main(argv=None) -> dict:
    """Runs the CLI; returns {condition: per-metric mean}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    gen, cfg, _ = load_generator(args.checkpoint, args.torch_checkpoint,
                                 device)
    index = CorpusIndex(sorted(get_filepaths(args.test_clean))[
        :args.num_utts], args.test_noise)
    loader = BucketedLoader(index, batch_size=args.batch_size, shuffle=False)
    metrics = tuple(m.strip() for m in args.metrics.split(",") if m.strip())

    def rms(v):
        return np.sqrt(np.mean(v ** 2))

    def fir(h, x):
        return fir_filter(torch.as_tensor(h, device=device),
                          torch.as_tensor(x, device=device)).cpu().numpy()

    means = {}
    for rev in (args.rir or ["NO_rev"]):
        rir = None if rev == "NO_rev" else read_wav(rev)[0]
        if rir is not None:
            b = int(np.argmax(rir))
            h_direct = direct_path_rir(rir, args.tau)
        refs, mixes = [], []
        for batch in loader():
            with torch.inference_mode():
                feats = pipeline.featurize_batch(
                    batch.clean, batch.noise, batch.lengths,
                    cfg.train.p_power, cfg.imcra, device=device)
                wavs, _, out_lens = pipeline.enhance_batch(
                    gen, feats, cfg.train.p_power, cfg.train.target_rms,
                    device=device)
                wavs, out_lens = wavs.cpu().numpy(), out_lens.cpu().numpy()
            for i, name in enumerate(batch.names):
                clean, _ = read_wav(os.path.join(args.test_clean, name))
                noise, _ = read_wav(os.path.join(args.test_noise, name))
                enh = wavs[i, :out_lens[i]]
                m = min(len(enh), len(noise), len(clean))
                enh, noise, clean = enh[:m], noise[:m], clean[:m]
                if rir is None:
                    mixed = clip_overflow(enh + noise)
                    clean_a = clean
                else:
                    direct = fir(h_direct, clean)
                    direct = clip_overflow(direct / rms(direct) * 0.03)
                    clean_a = direct[b:]
                    rev_enh = fir(rir, enh)
                    rev_enh = clip_overflow(rev_enh / rms(rev_enh) * 0.03)
                    mixed = clip_overflow(rev_enh[b:] + noise[b:])
                refs.append(np.asarray(clean_a))
                mixes.append(np.asarray(mixed))
        with torch.inference_mode():
            scores = score_batch(refs, [np.zeros_like(x) for x in mixes],
                                 mixes, cfg.train.fs, norm=False,
                                 metrics=metrics, device=device)
        print(rev)
        if scores:
            means[rev] = {m: float(np.mean([s[m] for s in scores]))
                          for m in metrics}
            print("  " + ", ".join(f"{m.upper()} is {means[rev][m]:.3f}"
                                   for m in metrics))
        else:
            print("  no utterances scored for this condition")
        print("=======")
    return means


if __name__ == "__main__":
    main()
