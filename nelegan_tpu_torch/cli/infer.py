"""Inference CLI: enhance a test corpus with a trained generator.

Counterpart of `nelegan_tpu/cli/infer.py` (the reference's
`python inference.py`): each clean/noise pair of the corpus is enhanced by
the batched pipeline on the card and written as a PCM16 wav at RMS 0.03,
``<name>@1.wav`` under `--output`.  Batches come from a `CorpusIndex` and a
`BucketedLoader` in corpus order; every batch is dispatched first
(`featurize_batch`, `enhance_batch`, `pcm16_quantize_i16`), and the whole
corpus comes back in one device-to-host copy at the end.

    python -m nelegan_tpu_torch.cli.infer \\
        --test-clean .../Test/Clean --test-noise .../Test/Noise \\
        --checkpoint ./chkpt [--torch-checkpoint chkpt_GD.pt] \\
        --output ./output_wav [--device cuda]

Scoring (`--metrics`) waits for the metric engines, which are not ported
yet: `--metrics ""`, the default, writes the wavs only.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from nelegan_tpu_torch import pipeline
from nelegan_tpu_torch.data.pipeline import (BucketedLoader, CorpusIndex,
                                             get_filepaths)
from nelegan_tpu_torch.data.wavio import write_wav_pcm16
from nelegan_tpu_torch.device import disable_tf32, resolve_device
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
    p.add_argument("--output", default="./output_wav")
    p.add_argument("--num-utts", type=int, default=960)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--metrics", default="",
                   help="metrics to score; none are ported yet, so only "
                        "the default '' (write wavs only) is accepted")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a GPU pass 'cpu' explicitly")
    return p


def main(argv=None) -> dict:
    """Runs the CLI; returns the paths written and the time split."""
    args = build_parser().parse_args(argv)
    if args.metrics.strip():
        raise SystemExit(f"--metrics {args.metrics!r}: the metric engines "
                         f"(SIIB, HASPI, ESTOI, PESQ, ViSQOL) are not ported "
                         f"to nelegan_tpu_torch yet; pass --metrics '' to "
                         f"write the enhanced wavs only")
    if not (args.checkpoint or args.torch_checkpoint):
        raise SystemExit("need --checkpoint or --torch-checkpoint")
    if not os.path.isdir(args.test_clean):
        raise SystemExit(f"--test-clean {args.test_clean} is not a directory")
    device = resolve_device(args.device)
    disable_tf32()
    gen, cfg, epoch = load_generator(args.checkpoint, args.torch_checkpoint,
                                     device)
    if epoch is not None:
        print(f"loaded checkpoint epoch {epoch}")
    p_power = cfg.train.p_power

    index = CorpusIndex(sorted(get_filepaths(args.test_clean))[
        :args.num_utts], args.test_noise)
    loader = BucketedLoader(index, batch_size=args.batch_size, shuffle=False)
    os.makedirs(args.output, exist_ok=True)

    # pass 1: read and dispatch every batch; the output lengths are known on
    # the host (256 * (n // 256)), so nothing waits for the device
    t0 = time.perf_counter()
    read_s = 0.0
    batches, quantized = [], []
    it = iter(loader())
    while True:
        t1 = time.perf_counter()
        batch = next(it, None)
        read_s += time.perf_counter() - t1
        if batch is None:
            break
        with torch.inference_mode():
            feats = pipeline.featurize_batch(batch.clean, batch.noise,
                                             batch.lengths, p_power,
                                             cfg.imcra, device=device)
            wavs, _, _ = pipeline.enhance_batch(gen, feats, p_power,
                                                cfg.train.target_rms,
                                                device=device)
            quantized.append(pipeline.pcm16_quantize_i16(wavs).reshape(-1))
        batches.append((batch.names, wavs.shape,
                        pipeline.HOP * (batch.lengths // pipeline.HOP)))
    # pass 2: one copy of the whole corpus to the host, then the files
    t1 = time.perf_counter()
    flat = (torch.cat(quantized).cpu().numpy() if quantized else None)
    fetch_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    written, off = [], 0
    for names, (bs, blen), out_lens in batches:
        wavs = flat[off:off + bs * blen].reshape(bs, blen)
        off += bs * blen
        for i, name in enumerate(names):
            path = os.path.join(args.output, f"{name[:-4]}@1.wav")
            write_wav_pcm16(path, wavs[i, :out_lens[i]], cfg.train.fs)
            written.append(path)
    write_s = time.perf_counter() - t1
    total_s = time.perf_counter() - t0
    res = {"written": written, "batches": len(batches), "seconds": total_s,
           "read_s": read_s, "write_s": write_s, "fetch_s": fetch_s,
           "dispatch_s": total_s - read_s - write_s - fetch_s}
    print(f"enhanced {len(written)} utterances -> {args.output} in "
          f"{total_s:.3f} s: reading wavs {read_s:.3f} s, dispatch "
          f"{res['dispatch_s']:.3f} s, device wait and copy {fetch_s:.3f} s, "
          f"writing wavs {write_s:.3f} s")
    return res


if __name__ == "__main__":
    main()
