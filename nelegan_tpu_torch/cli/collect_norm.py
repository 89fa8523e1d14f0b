"""Metric-normalisation data collector.

Counterpart of `nelegan_tpu/cli/collect_norm.py` (the reference's
`python intel.py` __main__, intel.py:162-274): scores a sample of training
utterances before and after pre-enhancement, with and without
reverberation, on the card, and saves each score distribution as a .npy
file under ./metric_norm/.  As in the reference, the default saves
calibrated scores; --raw saves unmapped ones (to refit the logistic
constants of `config.MetricCalibration`).

    python -m nelegan_tpu_torch.cli.collect_norm \\
        --clean .../Train/Clean --noise .../Train/Noise \\
        --enhanced .../Train/MultiEnh [--rir-dir .../RIR_DB16k] \\
        [--num 1500] [--out ./metric_norm] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from nelegan_tpu_torch.data.pipeline import get_filepaths
from nelegan_tpu_torch.data.wavio import read_wav
from nelegan_tpu_torch.device import disable_tf32, resolve_device
from nelegan_tpu_torch.dsp.reverb import direct_path_rir, fir_filter
from nelegan_tpu_torch.metrics import estoi, haspi_v2, siib
from nelegan_tpu_torch.metrics.calibrate import make_mappers_np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--clean", required=True)
    p.add_argument("--noise", required=True)
    p.add_argument("--enhanced", required=True)
    p.add_argument("--rir-dir", default=None,
                   help="RIR corpus; file chosen by the clean name's "
                        "#<rir>...# field like the reference")
    p.add_argument("--num", type=int, default=1500)
    p.add_argument("--out", default="./metric_norm")
    p.add_argument("--metrics", default="estoi,haspi,siib")
    p.add_argument("--raw", action="store_true",
                   help="save unmapped scores (for refitting the logistic "
                        "calibration constants)")
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--tau", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="torch device; without a GPU pass 'cpu' explicitly")
    return p


def main(argv=None) -> dict:
    """Runs the CLI; returns {(metric, condition): scores}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    metrics = tuple(m.strip() for m in args.metrics.split(",") if m.strip())
    mappers = make_mappers_np()

    def on_dev(x):
        return torch.as_tensor(x, device=device)

    def score(m, x, y):
        if m == "estoi":
            raw = float(estoi(on_dev(x), on_dev(y), 16000))
        elif m == "siib":
            raw = float(siib(x, y, 16000, device=device))
        elif m == "haspi":
            raw = float(haspi_v2(on_dev(x), 16000, on_dev(y), 16000)[0])
        else:
            raise ValueError(m)
        return raw if args.raw else float(mappers[m](raw))

    def fir(h, x):
        return fir_filter(on_dev(h), on_dev(x)).cpu().numpy()

    files = sorted(get_filepaths(args.clean))
    random.Random(args.seed).shuffle(files)
    files = files[:args.num]

    def rms(v):
        return np.sqrt(np.mean(v ** 2))

    acc = {}  # (metric, condition) -> list
    with torch.inference_mode():
        for i, path in enumerate(files):
            base = os.path.basename(path)
            clean, _ = read_wav(path)
            noise, _ = read_wav(os.path.join(args.noise, base))
            enhan, _ = read_wav(os.path.join(args.enhanced, base))
            n = min(len(clean), len(noise), len(enhan))
            clean, noise, enhan = clean[:n], noise[:n], enhan[:n]
            pairs = {"before": (clean, clean + noise),
                     "after": (clean, enhan + noise)}
            if args.rir_dir:
                rir, _ = read_wav(os.path.join(
                    args.rir_dir, base.split("#")[1] + ".wav"))
                b = int(np.argmax(rir))
                direct = fir(direct_path_rir(rir, args.tau), clean)
                direct = direct / rms(direct) * 0.03
                reverb = fir(rir, clean)
                reverb = reverb / rms(reverb) * 0.03
                reverb_enh = fir(rir, enhan)
                reverb_enh = reverb_enh / rms(reverb_enh) * 0.03
                pairs["rev_before"] = (direct[b:], reverb[b:] + noise[b:])
                pairs["rev_after"] = (direct[b:], reverb_enh[b:] + noise[b:])
            for cond, (x, y) in pairs.items():
                for m in metrics:
                    acc.setdefault((m, cond), []).append(score(m, x, y))
            if i % 10 == 0:
                print(f"{i} finished")

    os.makedirs(args.out, exist_ok=True)
    for (m, cond), vals in acc.items():
        np.save(os.path.join(args.out, f"{m}_{cond}.npy"), np.asarray(vals))
    print(f"saved {len(acc)} distributions to {args.out}")
    return acc


if __name__ == "__main__":
    main()
