"""Streaming-enhancement CLI.

Counterpart of `nelegan_tpu/cli/stream.py`: feeds a (clean, noise) wav pair
through the frame-streaming enhancer (`nelegan_tpu_torch.streaming`) in
real-time-sized chunks, writes the enhanced wav, and reports the real-time
factor and the latency.

    python -m nelegan_tpu_torch.cli.stream \\
        --clean f.wav --noise f.wav --out enhanced.wav \\
        --checkpoint ./chkpt [--torch-checkpoint chkpt_GD.pt] \\
        [--chunk-ms 128] [--compare-offline] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from nelegan_tpu_torch.data.wavio import read_wav, write_wav_pcm16
from nelegan_tpu_torch.device import disable_tf32, resolve_device
from nelegan_tpu_torch.streaming import (HOP, StreamingEnhancer,
                                         enhance_offline_causal)
from nelegan_tpu_torch.train.checkpoint import load_generator


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--clean", required=True)
    p.add_argument("--noise", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir, .ptstate or .msgpack file")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference chkpt_GD.pt")
    p.add_argument("--chunk-ms", type=float, default=128.0,
                   help="feed size in milliseconds (16 ms = one hop)")
    p.add_argument("--compare-offline", action="store_true",
                   help="also run the offline causal path and report the "
                        "max deviation at matching samples")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a GPU pass 'cpu' explicitly")
    return p


def main(argv=None) -> dict:
    """Runs the CLI; returns what it reported, as a dict."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    gen, cfg, epoch = load_generator(args.checkpoint, args.torch_checkpoint,
                                     device)
    if epoch is not None:
        print(f"loaded checkpoint epoch {epoch}")
    clean, fs = read_wav(args.clean)
    noise, _ = read_wav(args.noise)
    if fs != cfg.train.fs:
        raise SystemExit(f"stream expects {cfg.train.fs} Hz input, got {fs} "
                         f"Hz (the generator, IMCRA and the 32 ms latency "
                         f"assume 16 kHz)")
    n = min(len(clean), len(noise))
    clean, noise = clean[:n], noise[:n]
    chunk = max(1, int(fs * args.chunk_ms / 1000.0))
    se = StreamingEnhancer(gen, cfg.train.p_power, cfg.imcra,
                           chunk_frames=max(1, chunk // HOP), device=device)

    # warm-up (kernel build, cuFFT plans), so the RTF is steady streaming
    se.process(np.zeros(8192, np.float32), np.zeros(8192, np.float32))
    se.flush()
    se.reset()

    outs, call_s = [], []
    t0 = time.perf_counter()
    for i in range(0, n, chunk):
        t1 = time.perf_counter()
        outs.append(se.process(clean[i:i + chunk], noise[i:i + chunk]))
        call_s.append(time.perf_counter() - t1)
    outs.append(se.flush())
    dt = time.perf_counter() - t0
    enh = np.concatenate(outs)
    write_wav_pcm16(args.out, enh, fs)
    res = {"seconds": dt, "audio_seconds": n / fs, "rtf": dt / (n / fs),
           "latency_ms": StreamingEnhancer.LATENCY_SAMPLES / fs * 1000,
           "chunk_ms_p50": float(np.median(call_s)) * 1e3,
           "chunk_ms_max": float(np.max(call_s)) * 1e3,
           "samples": len(enh), "steps": se.steps}
    print(f"streamed {n / fs:.2f} s of audio in {dt:.2f} s "
          f"(RTF {res['rtf']:.3f}); latency {res['latency_ms']:.0f} ms "
          f"algorithmic, each {chunk}-sample chunk taking "
          f"{res['chunk_ms_p50']:.2f} ms (median, max "
          f"{res['chunk_ms_max']:.2f}); wrote {len(enh)} samples -> "
          f"{args.out}")

    if args.compare_offline:
        ref = enhance_offline_causal(gen, clean, noise, cfg.train.p_power,
                                     cfg.imcra, device).cpu().numpy()
        m = min(len(ref), len(enh))
        res["offline_max_dev"] = float(np.abs(ref[:m] - enh[:m]).max())
        print(f"offline-parity max deviation over {m} samples: "
              f"{res['offline_max_dev']:.2e}")
    return res


if __name__ == "__main__":
    main()
