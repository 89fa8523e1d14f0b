#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, `nelegan_tpu_torch`.

    python3 chip_smoke.py

Needs one CUDA GPU (sm_90a: H100) and `nvcc`; exits non-zero without them,
and in a directory that holds this file and nothing else of the repository.
Phases, in order; any failure raises:

  1. the card, as `nvidia-smi --query-gpu=name,power.limit` prints it;
  2. build both kernels from nelegan_tpu_torch/csrc (one nvcc per source,
     started together);
  3. kernel phase, TF32 off: each kernel against its plain PyTorch version
     on the card, at the main path's shapes (IMCRA [8, 257, 145]: eight
     noise spectra of the 36864-sample bucket; gammatone cascade
     [64, 36000] with per-row poles in [0.5, 0.991]).  IMCRA also at
     [8, 257, 401] (a 102400-sample bucket), where minimum tracking fires
     more than U = 8 times and its slot store rolls; at both lengths the
     kernel's fresh start equals a scan from the packed `imcra_init` state
     bit for bit, the state-less call gives the same PSD, and a scan resumed
     mid-utterance from the carried state equals the whole scan; the
     kernel's fast division equals IEEE division on 1.4e9 operand pairs,
     and the kernel is timed at 32, 257 and 513 bins (one, three and five
     warps to each of an SM's schedulers).  The
     cascade also against `lfilter` in float64 (bar 2e-5), at a ragged
     length (36001), past one shared-memory segment (100000) and at 1 and
     1024 samples, and beside it the cuFFT yardstick that the port never
     calls: FFT convolution with the four-pole impulse response, checked
     against `lfilter` too.  Kernel times: 20 calls between one pair of
     CUDA events (median of 5 such bursts), replayed from a CUDA graph where
     the host would otherwise set the pace; each kernel's device time from
     torch.profiler; IMCRA's wrapper as `featurize_batch` calls it and the
     packed wrapper of a scan from `imcra_init`;
  4. serving phase, the port's main path: `EnhanceServer` at full width
     (hidden 256, 6 blocks, 64 bands; weights from a numpy seed), batch 8,
     on 127.0.0.1:0; ten concurrent requests over two buckets, then three
     throughput windows of 3200 requests (400 full batches) each, sent by
     16 closed-loop clients from a process of their own; each window
     reports its rate, latency median, p99 and max, the batch period, the
     server's step time under load and its worker's busy share.  Each of
     the ten replies is checked for length, RMS 0.03 and PCM16 within 1 LSB
     of the same batch run through `enhance_batch` with the plain IMCRA,
     the golden utterance also against the CPU single-utterance path, and
     each window's replies for length and RMS.  Launch counts are zeroed just
     before the server starts and read after it stops: the IMCRA kernel
     must have run once per served batch, and no state was packed;
  5. training phase, the GAN training steps (`train/gan.py`) at full width
     (the generator above and both spectral-norm discriminators), batch 8
     with one shape-padding row masked by `row_valid`, bucket 36864 (145
     frames), HASPI's score column gated off, deterministic cuDNN: the
     batch is featurized with the IMCRA kernel and with the plain version
     (features equal bit for bit); four G steps; `enhance_batch`, then
     `eband_from_enhanced` (and `featurize_triple` of the same PCM16 rows,
     equal bit for bit); six D steps on that fixed batch with targets in
     [0.2, 0.9], whose losses must fall; `d_steps_scan` over four groups,
     one of them skipped, equal to the three valid groups alone bit for
     bit; training from kernel features equal to training from plain ones
     bit for bit; exact resume through `save_checkpoint` and through
     `AsyncSaver` with a G step in flight; three G and three D steps from
     one state on the card against the CPU in float64 (bar F64_BAR on every
     tensor and loss), and on the card in float32 against the CPU's float64
     (bars F32_LOSS_BAR and F32_UPDATE_BAR), which the same float32 steps
     with TF32 on, the control, must fail.  Launch counts are zeroed at
     the start: the IMCRA kernel must have run once per batch featurized
     with it.  Then G-step and D-step times (CUDA events), utterances/s and
     one G step's device-busy share (torch.profiler);
  6. streaming phase (`streaming.py`, `cli/stream.py`) at the same full
     width, float32: a stream of 102500 samples (401 frames: the IMCRA
     warm-up, 25 tracker fires, so the slot store rolls) cut from the
     golden speech and noise, fed in pieces of 300, 1000, 7, 4096 and 53
     samples.  At 1, 8 and 16 frames a chunk, the PSD from the IMCRA
     kernel's stateful launches (one per chunk step, counted from 0 before
     each run) equals one fresh launch over the same frames bit for bit;
     the stream through the plain IMCRA on the card gives the same PSDs and
     output bit for bit; the output is within STREAM_BAR of the offline
     causal path; 256 * (n // 256) samples come out, the first once 512 are
     in; 8 batched streams equal 8 single ones (IMCRA bit for bit, one
     launch a batched step).  Then step times at 1 and 8 frames, the device
     busy share of a step, frames/s for 8 and 64 concurrent streams, and the
     CLI's real-time factor at 16 and 128 ms chunks;
  7. infer phase (`cli/infer.py`, `data/`): 24 utterances in three length
     buckets, written as PCM16 wavs, enhanced from a `.ptstate` checkpoint of
     the seeded generator; every file equals `enhance_batch` on the same
     batches bit for bit and the plain-IMCRA path within 1 LSB; IMCRA runs
     once per batch and once for one `mmse_lsa_enhance` call (its own
     configuration), whose PSD equals the plain loop's bit for bit;
     utterances/s with wav I/O and device work apart;
  8. one JSON line per phase, one of kernel records (each with its launches
     on the serving, training, streaming and infer paths), the card line
     again, and last `{"ok": true, "device": ...}`.
"""
from __future__ import annotations

import copy
import functools
import json
import multiprocessing
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from nelegan_tpu_torch import kernels, pipeline, streaming
from nelegan_tpu_torch.cli import infer, stream
from nelegan_tpu_torch.cli.serve import EnhanceServer, enhance_remote
from nelegan_tpu_torch.config import Config, ImcraConfig, config_to_dict
from nelegan_tpu_torch.data.pipeline import (BucketedLoader, CorpusIndex,
                                             get_filepaths)
from nelegan_tpu_torch.data.wavio import read_wav, write_wav_pcm16
from nelegan_tpu_torch.device import disable_tf32
from nelegan_tpu_torch.dsp import imcra, mmse
from nelegan_tpu_torch.dsp.stft import stft
from nelegan_tpu_torch.models.generator import Generator
from nelegan_tpu_torch.ops import cascade
from nelegan_tpu_torch.train import checkpoint, gan

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "goldens" / "features.npz"
BUILD = REPO / "build"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 FLOP/s
# outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# float32 operations per bin and frame of the IMCRA recursion, counted from
# csrc/imcra.cu: both branches share the frame-0 select, the
# decision-directed update, one smoothing and the s/min updates (~25); the
# main branch adds two smoothings, the VAD, q, p with its expf, the PSD
# update and the minimum tracking (~50 more).
IMCRA_OPS_WARM = 25
IMCRA_OPS_MAIN = 75
# The recursion's loop-carried chain, in dependent float32 operations per
# frame, counted from csrc/imcra.cu with a division as its six dependent
# steps from the divisor (reciprocal, Newton step, quotient, correction):
# a main frame carries lam -> gamma_new (7) -> xi (5) -> nu (7) -> exp (5)
# -> p (11) -> ov_lam, lam (6); a warm-up frame carries gain -> xi -> gain
# (12).  At the float32 pipeline's 4-cycle latency and the card's highest
# SM clock this is the least time the frames can take one after another.
IMCRA_CHAIN_MAIN = 41
IMCRA_CHAIN_WARM = 12
FP32_LATENCY_CYCLES = 4
BUCKET = 36864
LONG_BUCKET = 102400   # IMCRA check past the 9th tracker fire (slot roll)
WINDOWS = 3            # throughput windows
CLIENTS = 16           # closed-loop clients: two batches in flight
PER_CLIENT = 200       # requests per client and window: 400 full batches
TRAIN_G_STEPS = 4      # G steps of the training phase's main run
TRAIN_D_STEPS = 6      # D steps on one fixed batch: the losses must fall
PARITY_STEPS = 3       # card against CPU: this many G steps, then D steps
INTEL_COLS = (1, 0, 1)  # HASPI's column gated off, as when it is not scored
# Bars of the card against the CPU's float64 after PARITY_STEPS G and D
# steps.  float64 on both sides: every tensor (max |a - b| over the
# tensor's largest magnitude) and every loss within 1e-9, the reference
# package's float64 bar.  float32 on the card: the losses within
# F32_LOSS_BAR and each parameter's update within F32_UPDATE_BAR in norm
# (Adam scales each step to about lr whatever the gradient's size, so an
# element whose gradient float32 resolves poorly can take a step of another
# size, or sign).  Each bar sits between float32's reading and that of the
# control, the same float32 steps with TF32 on, which must fail both.
F64_BAR = 1e-9
F32_LOSS_BAR = 1e-5
F32_UPDATE_BAR = 3e-3
# Streaming phase: a stream of 401 frames (warm-up, 25 tracker fires, so
# the slot store rolls), fed in irregular pieces; the stream against the
# offline causal path within STREAM_BAR (fixed in PERF.md before the first
# run: the reference package's float32 bar for this comparison).
STREAM_SAMPLES = 102500
STREAM_SIZES = (300, 1000, 7, 4096, 53)
STREAM_BAR = 1e-5
STREAM_BATCHES = (8, 64)    # concurrent streams timed
# Infer phase: eight utterances in each of three length buckets.
INFER_BUCKETS = ((12289, 16384), (20481, 24576), (32769, 36864))
INFER_PER_BUCKET = 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def cuda_ms(fn, calls: int = 20, samples: int = 5, warmup: int = 3) -> float:
    """Time per call of `fn`: `calls` calls queued back to back between one
    pair of CUDA events, divided by `calls`; the median of `samples` such
    bursts.  Where the host queues a call faster than the device runs it,
    this is device time; otherwise it is the host's time per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def graph_ms(fn, calls: int = 20, samples: int = 5) -> float:
    """Device time per call of `fn`: `calls` calls captured in one CUDA
    graph, its replay timed between CUDA events, divided by `calls`; the
    median of `samples` replays.  The host launches once per replay, so a
    call shorter than its launch overhead is still timed on the device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def profiler_ms(fn, kernel: str, calls: int = 10) -> float:
    """Device time per call of the kernels named `kernel`, torch.profiler
    over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages() if kernel in e.key)
    if us <= 0:
        raise RuntimeError(f"torch.profiler recorded no device time for "
                           f"{kernel}")
    return us / calls / 1e3


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def speech_signals():
    g = np.load(GOLDEN)
    return g["clean"].astype(np.float32), g["noise"].astype(np.float32)


def crop(x: np.ndarray, n: int, offset: int, scale: float) -> np.ndarray:
    """n samples of `x` tiled, starting at `offset`."""
    reps = -(-(n + offset) // x.size)
    return (np.tile(x, reps)[offset:offset + n] * scale).astype(np.float32)


def seeded_generator(seed: int = 0) -> Generator:
    """Full-width generator with xavier-uniform weights drawn from numpy."""
    gen = Generator()
    rng = np.random.RandomState(seed)
    sd = {}
    for name, p in gen.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("gain0"):
            v = np.ones(shape)
        elif name.endswith("bias0"):
            v = np.zeros(shape)
        elif len(shape) >= 2:
            rf = shape[2] if len(shape) == 3 else 1
            a = np.sqrt(6.0 / ((shape[0] + shape[1]) * rf))
            v = rng.uniform(-a, a, shape)
        else:
            v = rng.uniform(-0.05, 0.05, shape)
        sd[name] = torch.from_numpy(v.astype(np.float32))
    gen.load_state_dict(sd, strict=True)
    return gen


# --------------------------------------------------------------- kernels
def noise_power(dev, bucket: int, seed: int) -> torch.Tensor:
    """|Y|^2 [8, T, 257] of eight noise crops, padded to `bucket` as the
    server pads them."""
    _, noise = speech_signals()
    rng = np.random.RandomState(seed)
    noises = [crop(noise, bucket, int(rng.randint(0, noise.size)),
                   float(rng.uniform(0.5, 2.0))) for _ in range(8)]
    npd, _ = pipeline.reflect_pad_batch(noises, bucket)
    spec = stft(torch.from_numpy(npd).to(dev), center=False)   # [B, K, T]
    y2 = spec.real * spec.real + spec.imag * spec.imag
    return y2.transpose(-1, -2).contiguous()                   # [B, T, K]


def imcra_errors(y2: torch.Tensor) -> dict:
    """`imcra_scan` against `imcra_scan_plain` on one input, and the
    kernel's three ways in: its fresh start (state out), a scan from the
    packed `imcra_init` state, and the state-less call; raises unless within
    the bars and the three agree bit for bit."""
    cfg = ImcraConfig()
    b, _, k = y2.shape
    psd_k, st_k = imcra.imcra_scan(y2)
    psd_p, st_p = imcra.imcra_scan_plain(y2)
    psd_i, st_i = imcra.imcra_scan(y2, imcra.imcra_init(k, y2.dtype, cfg, (b,),
                                                        y2.device))
    psd_n = imcra.imcra_psd(y2, cfg)
    torch.cuda.synchronize()
    if not (torch.equal(psd_k, psd_i)
            and all(torch.equal(x, z) for x, z in zip(st_k, st_i))):
        raise AssertionError("imcra_scan: fresh start != scan from imcra_init")
    if not torch.equal(psd_n, psd_k):
        raise AssertionError("imcra_scan: state-less PSD != fresh PSD")
    kp, pp = psd_k.double().cpu().numpy(), psd_p.double().cpu().numpy()
    rel = np.abs(kp - pp) / (np.abs(pp) + 1e-12)
    state_rel = max(float(((a.double() - c.double()).abs()
                           / (c.double().abs() + 1e-12)).max())
                    for a, c in zip(st_k, st_p))
    rec = {"median_rel": float(np.median(rel)),
           "p99_rel": float(np.percentile(rel, 99)),
           "max_rel": float(rel.max()),
           "max_abs_err": float(np.abs(kp - pp).max()),
           "bit_equal_share": float(np.mean(kp == pp)),
           "state_max_rel": state_rel,
           "tracker_fires": int(st_k.u.min())}
    print(f"imcra_scan vs plain at {list(y2.shape)} [B, T, K]: {rec}; fresh "
          f"start, scan from imcra_init and state-less call bit-equal")
    # The reference package's float32 bar for IMCRA (tests/test_imcra.py),
    # and a tight maximum: both versions do the same float32 operations in
    # the same order, so a bin that goes wrong anywhere shows here.
    if not (rec["median_rel"] < 1e-4 and rec["p99_rel"] < 2e-2
            and rec["max_rel"] <= 1e-6 and rec["state_max_rel"] <= 1e-6):
        raise AssertionError(f"imcra_scan disagrees with its plain version: "
                             f"{rec}")
    return rec


def imcra_phase(dev) -> dict:
    cfg = ImcraConfig()
    y2 = noise_power(dev, BUCKET, 1)
    b, t, k = y2.shape
    assert (b, t, k) == (8, 145, 257), y2.shape
    rec = imcra_errors(y2)

    # the step form on the card: two chunks with the carried state
    psd_k, st_k = imcra.imcra_scan(y2)
    first, st = imcra.imcra_scan(y2[:, :37].contiguous())
    second, st = imcra.imcra_scan(y2[:, 37:].contiguous(), st, l0=37)
    torch.cuda.synchronize()
    if not torch.equal(torch.cat([first, second], 1), psd_k):
        raise AssertionError("imcra_scan: chunked scan != whole scan")
    for a, c in zip(st, st_k):
        if not torch.equal(a, c):
            raise AssertionError("imcra_scan: chunked state != whole state")

    # a long request: minimum tracking fires more than U times, so from the
    # (U+1)-th fire on the slot store rolls
    y2_long = noise_power(dev, LONG_BUCKET, 4)
    rec_long = imcra_errors(y2_long)
    if rec_long["tracker_fires"] <= cfg.u_buffers:
        raise AssertionError(f"long IMCRA check fired the tracker only "
                             f"{rec_long['tracker_fires']} times")

    # the claim the kernel's divisions rest on: fast path == IEEE division
    bad, pairs = imcra.fast_divide_check(dev)
    print(f"imcra fast division vs IEEE a / b: {bad} mismatches in {pairs} "
          f"operand pairs")
    if bad or pairs < 10 ** 9:
        raise AssertionError(f"fast division: {bad} mismatches in {pairs}")

    def kernel_only():          # what featurize_batch launches
        return imcra.imcra_scan_packed(y2, None, None, 0, cfg,
                                       keep_state=False)

    def packed_wrapper():       # a scan from imcra_init, its state packed
        return imcra.imcra_scan(y2, imcra.imcra_init(k, y2.dtype, cfg, (b,),
                                                     dev))

    ms = cuda_ms(kernel_only)
    prof_ms = profiler_ms(kernel_only, "imcra_scan_kernel")
    wrapper_ms = cuda_ms(lambda: imcra.imcra_psd(y2, cfg))
    packed_ms = cuda_ms(packed_wrapper)
    plain_ms = cuda_ms(lambda: imcra.imcra_scan_plain(y2), calls=2,
                       samples=3, warmup=1)
    # one, three and five warps on each of an SM's four schedulers
    ms_by_bins = {}
    for bins in (32, k, 513):
        y2_b = torch.from_numpy(np.random.RandomState(bins).rand(b, t, bins)
                                .astype(np.float32)).to(dev)
        ms_by_bins[bins] = cuda_ms(lambda: imcra.imcra_scan_packed(
            y2_b, None, None, 0, cfg, keep_state=False))
    warm = min(t, cfg.is_frames)
    n_bytes = 4 * 2 * b * t * k                   # |Y|^2 in, PSD out
    n_ops = b * k * (warm * IMCRA_OPS_WARM + (t - warm) * IMCRA_OPS_MAIN)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    clock = max_sm_clock_hz()
    chain_ms = ((warm * IMCRA_CHAIN_WARM + (t - warm) * IMCRA_CHAIN_MAIN)
                * FP32_LATENCY_CYCLES / clock * 1e3)
    print(f"imcra_scan: kernel {ms:.4f} ms (events), {prof_ms:.4f} ms "
          f"(profiler), wrapper as featurize_batch calls it {wrapper_ms:.4f} "
          f"ms, packed wrapper from imcra_init {packed_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}), chain "
          f"bound {chain_ms:.6f} ms at {clock / 1e6:.0f} MHz; kernel ms by "
          f"bins (random |Y|^2, [8, bins, {t}]) {ms_by_bins}")
    return {"name": "imcra_scan", "route": "cuda",
            "source": "nelegan_tpu_torch/csrc/imcra.cu",
            "replaces": "nelegan_tpu/dsp/imcra.py:206 (lax.scan of "
                        "imcra_step; no Pallas kernel)",
            "max_abs_err": rec["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "profiler_ms": prof_ms,
            "wrapper_ms": wrapper_ms, "packed_wrapper_ms": packed_ms,
            "chain_bound_ms": chain_ms, "sm_clock_mhz": clock / 1e6,
            "ms_by_bins": ms_by_bins, "divide_check_pairs": pairs,
            "divide_check_mismatches": bad,
            "median_rel_err": rec["median_rel"],
            "p99_rel_err": rec["p99_rel"], "max_rel_err": rec["max_rel"],
            "shape": [b, k, t], "long_shape": [b, k, y2_long.shape[1]],
            "long_max_rel_err": rec_long["max_rel"],
            "long_tracker_fires": rec_long["tracker_fires"]}


def fft_len(n: int) -> int:
    """Smallest 2^k or 3*2^k >= 2n: the FFT size the reference package's
    `ops/iir._fft_len` gives a causal convolution of length n."""
    m = 1
    while m < 2 * n:
        m *= 2
    m3 = 3 * (m // 4)
    return m3 if m3 >= 2 * n else m


def four_pole_ir(a_np: np.ndarray, n: int) -> np.ndarray:
    """h[k] = C(k+3, 3) a^k [R, n], the impulse response of 1/(1 - a z^-1)^4,
    evaluated in float64 in the log domain (`ops/iir.gammatone_ir` without
    its numerator)."""
    k = np.arange(n, dtype=np.float64)
    log_c = np.log1p(k) + np.log(k + 2.0) + np.log(k + 3.0) - np.log(6.0)
    a = a_np.astype(np.float64)[:, None]
    return np.exp(k * np.log(a) + log_c).astype(np.float32)


def cascade_checks(dev, rows: int, n: int, a_np: np.ndarray, seed: int,
                   fft: bool = False) -> dict:
    """The kernel (and with `fft` the cuFFT yardstick) against the plain
    version and `lfilter` in float64 on one seeded input; raises beyond the
    reference package's bar for its Pallas cascade, 2e-5 relative to each
    row's largest value (tests/test_pallas.py)."""
    from scipy.signal import lfilter
    x_np = np.random.RandomState(seed).randn(rows, n).astype(np.float32)
    x, a = torch.from_numpy(x_np).to(dev), torch.from_numpy(a_np).to(dev)
    out = {"kernel": cascade.gammatone_cascade(x, a),
           "plain": cascade.gammatone_cascade_plain(x, a)}
    if fft:
        m = fft_len(n)
        h = torch.from_numpy(four_pole_ir(a_np, n)).to(dev)
        out["fft"] = torch.fft.irfft(torch.fft.rfft(x, m)
                                     * torch.fft.rfft(h, m), m)[:, :n]
    torch.cuda.synchronize()
    got = {key: v.cpu().numpy() for key, v in out.items()}
    refs = []
    for i in range(rows):
        c = float(a_np[i])
        den = np.convolve(np.convolve([1, -c], [1, -c]),
                          np.convolve([1, -c], [1, -c]))
        refs.append(lfilter([1.0], den, x_np[i].astype(np.float64)))
    ref = np.stack(refs)
    scale = np.abs(ref).max(1)        # a = 0.991 rows reach ~1e7, a = 0.5 ~10
    rec = {"shape": [rows, n],
           "rel_vs_plain": float((np.abs(got["kernel"] - got["plain"]).max(1)
                                  / scale).max()),
           "max_abs_err": float(np.abs(got["kernel"] - got["plain"]).max())}
    for key, y in got.items():
        rec[f"{key}_rel_vs_lfilter"] = float((np.abs(y - ref).max(1)
                                              / scale).max())
    print(f"gammatone_cascade at {[rows, n]}, a in [{a_np.min()}, "
          f"{a_np.max()}]: {rec}")
    if not all(v < 2e-5 for key, v in rec.items() if "rel" in key):
        raise AssertionError(f"gammatone_cascade at {[rows, n]} beyond 2e-5: "
                             f"{rec}")
    return rec


def cascade_phase(dev) -> dict:
    rows, n = 64, 36000
    a_np = np.linspace(0.5, 0.991, rows).astype(np.float32)
    main = cascade_checks(dev, rows, n, a_np, 2, fft=True)
    edge_a = np.array([0.991, 0.5], np.float32)
    others = [cascade_checks(dev, 2, m, edge_a, 5 + i)
              for i, m in enumerate((36001, 100000, 1, 1024))]

    x = torch.from_numpy(np.random.RandomState(2).randn(rows, n)
                         .astype(np.float32)).to(dev)
    a = torch.from_numpy(a_np).to(dev)
    m = fft_len(n)
    h = torch.from_numpy(four_pole_ir(a_np, n)).to(dev)   # built once, untimed

    def kernel():
        return cascade.gammatone_cascade(x, a)

    def library():
        return torch.fft.irfft(torch.fft.rfft(x, m) * torch.fft.rfft(h, m),
                               m)[:, :n]

    ms = graph_ms(kernel)
    prof_ms = profiler_ms(kernel, "gammatone_cascade_kernel")
    eager_ms = cuda_ms(kernel)
    library_ms = graph_ms(library)
    library_eager_ms = cuda_ms(library)
    plain_ms = cuda_ms(lambda: cascade.gammatone_cascade_plain(x, a),
                       calls=4, samples=3, warmup=1)
    bound_ms, bound_by = bound(4 * (2 * rows * n + rows), 8 * rows * n)
    print(f"gammatone_cascade: kernel {ms:.4f} ms (graph replay, events), "
          f"{prof_ms:.4f} ms (profiler), {eager_ms:.4f} ms (eager calls, "
          f"events); cuFFT yardstick (FFT size {m}) {library_ms:.4f} ms "
          f"(graph), {library_eager_ms:.4f} ms (eager); plain {plain_ms:.4f} "
          f"ms; bound {bound_ms:.6f} ms ({bound_by}), roofline share "
          f"{bound_ms / ms:.3f}")
    return {"name": "gammatone_cascade", "route": "cuda",
            "source": "nelegan_tpu_torch/csrc/cascade.cu",
            "replaces": "nelegan_tpu/ops/pallas_scan.py:68 "
                        "(gammatone_cascade_pallas, body _cascade_kernel :37)",
            "max_abs_err": main["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "profiler_ms": prof_ms,
            "eager_ms": eager_ms, "library_eager_ms": library_eager_ms,
            "library": f"irfft(rfft(x, {m}) * rfft(h, {m}))[:, :{n}], h the "
                       f"four-pole impulse response",
            "roofline_share": bound_ms / ms,
            "rel_err_vs_plain": main["rel_vs_plain"],
            "rel_err_vs_lfilter": main["kernel_rel_vs_lfilter"],
            "library_rel_err_vs_lfilter": main["fft_rel_vs_lfilter"],
            "shape": [rows, n],
            "other_shapes": [{"shape": o["shape"],
                              "rel_err_vs_plain": o["rel_vs_plain"],
                              "rel_err_vs_lfilter": o["kernel_rel_vs_lfilter"]}
                             for o in others],
            "on_main_path": False}


# --------------------------------------------------------------- serving
def build_requests():
    """Eight requests of the 36864 bucket (the golden utterance among them)
    and two of the 20480 bucket, cut and tiled from the golden speech."""
    clean, noise = speech_signals()
    rng = np.random.RandomState(3)
    reqs = [(clean, noise)]
    for n in [32769 + 512 * i for i in range(7)] + [19999, 20480]:
        off = int(rng.randint(0, clean.size))
        s = float(rng.uniform(0.5, 1.5))
        reqs.append((crop(clean, n, off, s), crop(noise, n, off + 777, s)))
    return reqs


def send_all(address, reqs):
    results = [None] * len(reqs)
    errors = []

    def one(i):
        try:
            t0 = time.perf_counter()
            wav = enhance_remote(*address, *reqs[i], timeout=300.0)
            results[i] = (wav, time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — collected and raised below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serving failed: {errors or 'timeout'}")
    return results


def load_client(address, clients: int, per_client: int, conn) -> None:
    """Closed-loop load from a process of its own, so that it shares no
    interpreter lock with the server: `clients` threads each send
    `per_client` requests of the 36864 bucket back to back and check each
    reply's length and RMS.  Sends (window seconds, latencies, errors)."""
    reqs = build_requests()[:8]
    lat, errors = [], []

    def one(i):
        for r in range(per_client):
            clean, noise = reqs[(i + r) % len(reqs)]
            t0 = time.perf_counter()
            try:
                wav = enhance_remote(*address, clean, noise, timeout=120.0)
            except Exception as e:  # noqa: BLE001 — raised by the parent
                errors.append(f"{type(e).__name__}: {e}")
                return
            lat.append(time.perf_counter() - t0)
            rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
            if wav.size != 256 * (clean.size // 256) or abs(rms - 0.03) >= 1e-6:
                errors.append(f"reply of {wav.size} samples, RMS {rms}")
                return

    threads = [threading.Thread(target=one, args=(i,)) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    conn.send((time.perf_counter() - t0, lat, errors))
    conn.close()


def time_calls(obj, name: str, out: list) -> None:
    """Append the host-clock seconds of every call of `obj.<name>` to `out`."""
    inner = getattr(obj, name)

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return inner(*args)
        finally:
            out.append(time.perf_counter() - t0)

    setattr(obj, name, timed)


def throughput_window(server, step_s: list, group_s: list) -> dict:
    """One window of CLIENTS x PER_CLIENT requests against the running
    server: the rate is all requests over the window's time, the tail is
    over all requests.  `step_s` and `group_s` collect the seconds of the
    server's `_step` (the device program) and `_run_group` (padding, step
    and replies) calls; the window reads its own."""
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=load_client, daemon=True,
                       args=(server.address, CLIENTS, PER_CLIENT, send))
    before = dict(server.stats)
    s0, g0 = len(step_s), len(group_s)
    proc.start()
    send.close()
    try:
        if not recv.poll(600):
            raise RuntimeError("load client did not report within 600 s")
        wall, lat, errors = recv.recv()
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.terminate()
            proc.join()
    n = CLIENTS * PER_CLIENT
    if errors or len(lat) != n:
        raise RuntimeError(f"throughput window: {len(lat)} of {n} replies; "
                           f"{errors[:3]}")
    deadline = time.perf_counter() + 10   # the worker counts after replying
    while ((server.stats["requests"] - before["requests"] < n
            or len(group_s) - g0 < server.stats["batches"] - before["batches"])
           and time.perf_counter() < deadline):
        time.sleep(0.01)
    batches = server.stats["batches"] - before["batches"]
    lat_ms = np.asarray(lat) * 1e3
    steps = np.asarray(step_s[s0:]) * 1e3
    win = {"requests": n, "batches": batches,
           "mean_fill": (server.stats["requests"] - before["requests"])
           / batches, "seconds": wall, "requests_per_s": n / wall,
           "p50_ms": float(np.median(lat_ms)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "max_ms": float(lat_ms.max()),
           "batch_period_ms": wall / batches * 1e3,
           "step_ms_median": float(np.median(steps)),
           "step_ms_p99": float(np.percentile(steps, 99)),
           "worker_busy_share": sum(group_s[g0:]) / wall}
    print(f"window: {n} requests in {batches} batches (mean fill "
          f"{win['mean_fill']:.3f}) over {wall:.3f} s: "
          f"{win['requests_per_s']:.2f} requests/s; latency p50 "
          f"{win['p50_ms']:.3f} ms, p99 {win['p99_ms']:.3f} ms, max "
          f"{win['max_ms']:.3f} ms; batch period "
          f"{win['batch_period_ms']:.3f} ms, step under load median "
          f"{win['step_ms_median']:.3f} ms, p99 {win['step_ms_p99']:.3f} ms, "
          f"worker busy {win['worker_busy_share']:.3f}")
    return win


def plain_noise_psd(y2, cfg):
    """The IMCRA noise PSD from the plain frame loop, on any device."""
    return imcra.imcra_scan_plain(y2, None, 0, cfg)[0]


def direct_pcm16(gen, reqs, dev):
    """Each bucket's requests as one batch of 8 (padded like the server's)
    through featurize_batch with the plain IMCRA and enhance_batch."""
    out = {}
    for blen in sorted({-(-r[0].size // 4096) * 4096 for r in reqs}):
        idx = [i for i, r in enumerate(reqs)
               if -(-r[0].size // 4096) * 4096 == blen]
        cl = [reqs[i][0] for i in idx]
        no = [reqs[i][1] for i in idx]
        while len(cl) < 8:
            cl.append(cl[-1])
            no.append(no[-1])
        cp, lens = pipeline.reflect_pad_batch(cl, blen)
        npd, _ = pipeline.reflect_pad_batch(no, blen)
        with torch.inference_mode():
            feats = pipeline.featurize_batch(cp, npd, lens, device=dev,
                                             noise_psd=plain_noise_psd)
            wav, _, out_len = pipeline.enhance_batch(gen, feats, device=dev)
            q = pipeline.pcm16_quantize_i16(wav).cpu().numpy()
        for j, i in enumerate(idx):
            out[i] = q[j, :int(out_len[j])]
    return out


def profile_step(step, batch_ms: float, reps: int = 5,
                 label: str = "profile"):
    """Device time of one call of `step` (a batch's work) by kernel, from
    torch.profiler, and the share of the batch's host-clock time `batch_ms`
    the device is busy; printed as one JSON line under `label`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((us / reps, e.count / reps, e.key))
    if not rows:
        raise RuntimeError("torch.profiler recorded no device time")
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    out = {"device_ms_per_batch": device_ms,
           "device_ops_per_batch": sum(r[1] for r in rows),
           "busy_share": device_ms / batch_ms,
           "top": [{"name": k[:70], "ms": us / 1e3, "calls": n}
                   for us, n, k in rows[:10]]}
    print(json.dumps({label: out}))
    return out


def serving_phase(dev) -> dict:
    gen = seeded_generator(0)
    gen_cpu = seeded_generator(0).eval()
    reqs = build_requests()

    packs = []                 # state packings on the served path: none
    pack_state = imcra.pack_state
    imcra.pack_state = lambda st: (packs.append(1), pack_state(st))[1]
    kernels.reset_launches()
    server = EnhanceServer(gen, batch_size=8, max_wait_ms=15.0, device=dev)
    step_s, group_s = [], []
    time_calls(server, "_step", step_s)
    time_calls(server, "_run_group", group_s)
    ready = threading.Event()
    serve_thread = threading.Thread(target=server.serve,
                                    args=("127.0.0.1", 0, ready), daemon=True)
    serve_thread.start()
    if not ready.wait(timeout=120):
        raise RuntimeError("server did not come up")
    try:
        t0 = time.perf_counter()
        server.warmup([BUCKET, 20480])
        print(f"warmed buckets {BUCKET}, 20480 in "
              f"{time.perf_counter() - t0:.3f} s")
        replies = send_all(server.address, reqs)
        windows = [throughput_window(server, step_s, group_s)
                   for _ in range(WINDOWS)]
    finally:
        server.stop()
        serve_thread.join(timeout=30)
        imcra.pack_state = pack_state
    if serve_thread.is_alive():
        raise RuntimeError("server thread did not stop")
    launches = dict(kernels.launches)
    batches = server.stats["batches"]
    print(f"main path: {server.stats['requests']} requests in {batches} "
          f"batches; kernel launches {launches}")
    if launches["imcra_scan"] == 0 or launches["imcra_scan"] != batches:
        raise AssertionError(f"imcra_scan launched {launches['imcra_scan']} "
                             f"times for {batches} served batches")
    if packs:
        raise AssertionError(f"the served path packed an IMCRA state "
                             f"{len(packs)} times")

    want = direct_pcm16(gen, reqs, dev)
    n_diff = n_total = max_lsb = 0
    for i, ((clean, _), (wav, _)) in enumerate(zip(reqs, replies)):
        if wav.shape != (256 * (clean.size // 256),):
            raise AssertionError(f"request {i}: length {wav.shape}")
        if not np.isfinite(wav).all():
            raise AssertionError(f"request {i}: non-finite output")
        rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
        if abs(rms - 0.03) >= 1e-6:
            raise AssertionError(f"request {i}: RMS {rms}")
        q = pipeline.pcm16_quantize_i16(torch.from_numpy(wav)).numpy()
        d = np.abs(q.astype(np.int32) - want[i].astype(np.int32))
        n_diff += int((d > 0).sum())
        n_total += d.size
        max_lsb = max(max_lsb, int(d.max()))
    print(f"PCM16 vs enhance_batch with the plain IMCRA: {n_diff} of "
          f"{n_total} samples differ, max {max_lsb} LSB")
    if max_lsb > 1:
        raise AssertionError("served PCM16 differs by more than 1 LSB")

    # the golden utterance against the CPU single-utterance path
    with torch.no_grad():
        ref = pipeline.enhance_utterance(gen_cpu, *reqs[0],
                                         device="cpu").numpy()
    cpu_err = float(np.abs(replies[0][0] - ref).max())
    print(f"golden utterance vs CPU enhance_utterance: max abs err "
          f"{cpu_err:.3e}")
    np.testing.assert_allclose(replies[0][0], ref, rtol=2e-4, atol=2e-5)

    # device time of one served batch, the server's own step, after the run
    burst = reqs[:8]
    cp, lens = pipeline.reflect_pad_batch([r[0] for r in burst], BUCKET)
    npd, _ = pipeline.reflect_pad_batch([r[1] for r in burst], BUCKET)
    step = []
    for _ in range(10):
        t0 = time.perf_counter()
        server._step(cp, npd, lens)
        step.append(time.perf_counter() - t0)
    batch_ms = float(np.median(step)) * 1e3
    prof = profile_step(lambda: server._step(cp, npd, lens), batch_ms)
    rates = [w["requests_per_s"] for w in windows]
    res = {"batch_ms": batch_ms, "profile": prof, "windows": windows,
           "requests_per_s_min": min(rates), "requests_per_s_max": max(rates),
           "pcm16_diff_samples": n_diff, "pcm16_total_samples": n_total,
           "launches": launches, "batches": batches,
           "state_packings": len(packs)}
    print(f"serving: batch of 8 at {BUCKET} samples {res['batch_ms']:.3f} ms "
          f"(median of 10, host clock, ends in the copy to host); "
          f"{min(rates):.2f}-{max(rates):.2f} requests/s over {WINDOWS} "
          f"windows of {CLIENTS * PER_CLIENT} requests from {CLIENTS} "
          f"closed-loop clients")
    return res


# --------------------------------------------------------------- training
def states_equal(a: gan.TrainState, b: gan.TrainState) -> bool:
    """Bit-for-bit equality of two train states, Adam states included."""
    def walk(x, y):
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(walk(x[k], y[k]) for k in x)
        return x == y
    return walk(a.state_dict(), b.state_dict())


def _flat_tensors(state: gan.TrainState) -> dict:
    sd = state.state_dict()
    out = {f"{m}.{k}": v for m in ("gen", "d", "dq") for k, v in sd[m].items()}
    for m in ("gen_opt", "d_opt", "dq_opt"):
        for i, st in sd[m]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"{m}.{i}.{k}"] = st[k]
    return out


def state_errors(got: gan.TrainState, want: gan.TrainState,
                 origin: gan.TrainState) -> dict:
    """`got` against `want` (any devices, in float64): `tensor_rel`, the
    largest over every tensor (parameters, u and v, Adam moments) of
    max|a - b| / max|b|; `update_rel`, the largest over the parameters of
    ||a - b|| / ||b - origin||, the error of the update the steps made."""
    fa, fw, fo = (_flat_tensors(s) for s in (got, want, origin))
    tensor_rel = update_rel = 0.0
    for k, w in fw.items():
        a, w = fa[k].double().cpu(), w.double().cpu()
        tensor_rel = max(tensor_rel, float((a - w).abs().max()
                                           / w.abs().max().clamp_min(1e-300)))
    for m in ("gen", "d", "dq"):
        for name, _ in getattr(want, m).named_parameters():
            k = f"{m}.{name}"
            a, w, o = (f[k].double().cpu() for f in (fa, fw, fo))
            update_rel = max(update_rel, float(
                (a - w).norm() / (w - o).norm().clamp_min(1e-300)))
    return {"tensor_rel": tensor_rel, "update_rel": update_rel}


def train_batch():
    """Seven requests of the 36864 bucket cut from the golden speech and an
    eighth row repeating the seventh as shape padding (row_valid 0), as the
    training loop pads a ragged batch; reflect-padded, with lengths."""
    reqs = build_requests()[:7]
    reqs.append(reqs[-1])
    cp, lens = pipeline.reflect_pad_batch([r[0] for r in reqs], BUCKET)
    npd, _ = pipeline.reflect_pad_batch([r[1] for r in reqs], BUCKET)
    return cp, npd, lens, np.array([1.0] * 7 + [0.0], np.float32)


def parity_run(state: gan.TrainState, cfg, bands, eband, targets, row_valid):
    """PARITY_STEPS G steps, then PARITY_STEPS D steps, on `state` in its
    own device and dtype; returns the losses as floats."""
    cb, nb, fr = bands
    losses = []
    for _ in range(PARITY_STEPS):
        _, loss = gan.g_step_bands(state, cb, nb, fr, cfg, INTEL_COLS, None,
                                   row_valid)
        losses.append(float(loss))
    for tg, tq in targets[:PARITY_STEPS]:
        _, ld, lq = gan.d_step_bands(state, eband, nb, cb, fr, tg, tq, cfg,
                                     intel_cols=INTEL_COLS,
                                     row_valid=row_valid)
        losses += [float(ld), float(lq)]
    return losses


def short_run(state, feats, cfg, targets, row_valid, dev):
    """Two G steps, enhancement, the enhanced rows' bands, two D steps: the
    loop's phases 2 and 7 in small."""
    for _ in range(2):
        gan.g_step(state, feats, cfg, INTEL_COLS, None, row_valid)
    with torch.no_grad():
        wav, _, out_len = pipeline.enhance_batch(state.gen, feats, device=dev)
    eband = gan.eband_from_enhanced(wav, out_len, cfg, device=dev)
    for tg, tq in targets[:2]:
        gan.d_step_bands(state, eband, feats.noise_band, feats.clean_band,
                         feats.frames, tg, tq, cfg, intel_cols=INTEL_COLS,
                         row_valid=row_valid)
    return state


def resume_checks(state: gan.TrainState, cfg, feats, eband, targets,
                  row_valid, dev) -> None:
    """Exact resume through save_checkpoint and through AsyncSaver (a G step
    taken while the save is in flight): the loaded state equals the saved
    one, and one more G and D step from each are equal, bit for bit."""
    tg, tq = targets[0]

    def one_more(st):
        _, lg = gan.g_step(st, feats, cfg, INTEL_COLS, None, row_valid)
        _, ld, lq = gan.d_step_bands(st, eband, feats.noise_band,
                                     feats.clean_band, feats.frames, tg, tq,
                                     cfg, intel_cols=INTEL_COLS,
                                     row_valid=row_valid)
        return [float(lg), float(ld), float(lq)]

    BUILD.mkdir(parents=True, exist_ok=True)
    rng = torch.Generator().manual_seed(11)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        live = copy.deepcopy(state)
        checkpoint.save_checkpoint(f"{tmp}/sync", 1, live, rng)
        loaded, rng2, epoch, _ = checkpoint.load_checkpoint(
            f"{tmp}/sync", gan.init_train_state(cfg, 1, dev))
        if not (epoch == 1 and states_equal(loaded, live)
                and torch.equal(rng2.get_state(), rng.get_state())):
            raise AssertionError("checkpoint: loaded state != saved state")
        if one_more(loaded) != one_more(live) or not states_equal(loaded,
                                                                  live):
            raise AssertionError("checkpoint: resumed step != live step")

        saver = checkpoint.AsyncSaver()
        before = copy.deepcopy(live)
        saver.save_async(f"{tmp}/async", 2, live, rng)
        gan.g_step(live, feats, cfg, INTEL_COLS, None, row_valid)  # in flight
        saver.wait()
        loaded, _, epoch, _ = checkpoint.load_checkpoint(
            f"{tmp}/async", gan.init_train_state(cfg, 2, dev))
        if not (epoch == 2 and states_equal(loaded, before)):
            raise AssertionError("AsyncSaver: loaded state != state at save")
        if one_more(loaded) != one_more(before) or not states_equal(loaded,
                                                                    before):
            raise AssertionError("AsyncSaver: resumed step != live step")
    print("exact resume: saved, loaded and stepped states bit-equal to the "
          "live ones (save_checkpoint; AsyncSaver with a G step in flight)")


def training_phase(dev) -> dict:
    """The GAN training steps at full width, batch 8, bucket 36864, as
    train/loop.py's phases 2 (G steps) and 7 (D steps) drive them; every
    check raises.  Launch counts are zeroed at the start and read at the
    end: the IMCRA kernel runs once per batch featurized with it."""
    cfg = Config()
    cudnn = torch.backends.cudnn
    deterministic = cudnn.deterministic
    # bit-for-bit checks need deterministic convolution backward passes
    cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        checks, timing_args = training_checks(dev, cfg)
        res = dict(checks, **time_training(cfg, *timing_args))
        res["phase_s"] = time.perf_counter() - t0
    finally:
        cudnn.deterministic = deterministic
    print(f"training phase: {res['phase_s']:.1f} s")
    return res


def training_checks(dev, cfg):
    """Every check of the training phase; returns (results, the state and
    inputs `time_training` times)."""
    t_phase = time.perf_counter()
    cp, npd, lens, row_valid = train_batch()
    rng = np.random.RandomState(7)
    targets = [(rng.uniform(0.2, 0.9, (8, 3)).astype(np.float32),
                rng.uniform(0.2, 0.9, (8, 2)).astype(np.float32))
               for _ in range(max(TRAIN_D_STEPS, PARITY_STEPS))]

    kernels.reset_launches()
    featurized = 0
    with torch.no_grad():
        feats = pipeline.featurize_batch(cp, npd, lens, cfg.train.p_power,
                                         cfg.imcra, device=dev)
        feats_plain = pipeline.featurize_batch(
            cp, npd, lens, cfg.train.p_power, cfg.imcra, device=dev,
            noise_psd=plain_noise_psd)
    cb, nb, fr = gan.featurize_bands(cp, npd, lens, cfg, device=dev)
    featurized += 2
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in
               ((feats.clean_band, feats_plain.clean_band),
                (feats.noise_band, feats_plain.noise_band),
                (feats.clean_band, cb), (feats.noise_band, nb),
                (feats.frames, fr))):
        raise AssertionError("training features: IMCRA kernel != plain, or "
                             "featurize_bands != featurize_batch")

    # the main run: G steps with a padding row and a gated column, the
    # enhanced batch's bands, D steps on that fixed batch, a scan of groups
    state0 = gan.init_train_state(cfg, 0, dev)
    state = copy.deepcopy(state0)
    g_losses = [float(gan.g_step(state, feats, cfg, INTEL_COLS, None,
                                 row_valid)[1])
                for _ in range(TRAIN_G_STEPS)]
    with torch.no_grad():
        wav, _, out_len = pipeline.enhance_batch(state.gen, feats, device=dev)
    eband = gan.eband_from_enhanced(wav, out_len, cfg, device=dev)
    enh_np = pipeline.pcm16_quantize(wav).cpu().numpy()
    enh_padded, _ = pipeline.reflect_pad_batch(
        [enh_np[i, :int(n)] for i, n in enumerate(out_len.cpu())], wav.shape[1])
    img3, img2, fr3 = gan.featurize_triple(enh_padded, npd, cp, lens, cfg,
                                           device=dev)
    featurized += 1
    want3, want2 = gan.d_images(eband, nb, cb, fr)
    if not (torch.equal(img3, want3) and torch.equal(img2, want2)
            and torch.equal(fr3, fr)):
        raise AssertionError("featurize_triple != d_images of "
                             "eband_from_enhanced")
    d_losses = []
    for tg, tq in [targets[0]] * TRAIN_D_STEPS:
        _, ld, lq = gan.d_step_bands(state, eband, nb, cb, fr, tg, tq, cfg,
                                     intel_cols=INTEL_COLS,
                                     row_valid=row_valid)
        d_losses.append([float(ld), float(lq)])
    if not all(d_losses[-1][h] < d_losses[0][h] for h in (0, 1)):
        raise AssertionError(f"D losses on a fixed batch did not fall: "
                             f"{d_losses}")
    print(f"training main run: G losses {g_losses}; D losses (intel, "
          f"quality) on one fixed batch {d_losses}")

    # d_steps_scan over 4 groups, the third shape padding: equal to the
    # three valid groups alone, bit for bit
    groups = 4
    flat = [torch.cat([x] * groups) for x in (eband, cb, nb, fr)]
    tgs = np.stack([t[0] for t in targets[:groups]])
    tqs = np.stack([t[1] for t in targets[:groups]])
    rvs = np.stack([row_valid] * groups)
    valid = np.array([True, True, False, True])
    scanned, losses = gan.d_steps_scan(
        copy.deepcopy(state), *flat, tgs, tqs, rvs, valid, cfg,
        intel_cols=INTEL_COLS)
    keep = [0, 1, 3]
    alone, losses3 = gan.d_steps_scan(
        copy.deepcopy(state), *(torch.cat([x] * 3) for x in
                                (eband, cb, nb, fr)),
        tgs[keep], tqs[keep], rvs[keep], [True] * 3, cfg,
        intel_cols=INTEL_COLS)
    if not (states_equal(scanned, alone) and scanned.step_d == state.step_d + 3
            and torch.equal(losses[keep], losses3)
            and not losses[2].any()):
        raise AssertionError("d_steps_scan: a skipped group changed the state")
    print(f"d_steps_scan over {groups} groups, group 2 skipped: state and "
          f"losses bit-equal to the 3 valid groups alone; losses "
          f"{losses.tolist()}")

    # training with the IMCRA kernel's features = with the plain version's
    runs = [short_run(copy.deepcopy(state0), f, cfg, targets, row_valid, dev)
            for f in (feats, feats_plain)]
    if not states_equal(*runs):
        raise AssertionError("training with the IMCRA kernel != with the "
                             "plain IMCRA")
    print("training from IMCRA-kernel features = from plain-IMCRA features, "
          "bit for bit (2 G steps, enhancement, 2 D steps)")

    resume_checks(state, cfg, feats, eband, targets, row_valid, dev)

    # the card against the CPU from state0: float64 on both sides, then
    # float32 on the card against the CPU's float64
    launches = dict(kernels.launches)
    t0 = time.perf_counter()
    bands64 = [x.double().cpu() if x.is_floating_point() else x.cpu()
               for x in (cb, nb, fr)]
    eband64 = eband.double().cpu()
    cpu64 = gan.init_train_state(cfg, 0, "cpu", dtype=torch.float64)
    cpu64.load_state_dict(state0.state_dict())
    origin = copy.deepcopy(cpu64)
    cpu_losses = parity_run(cpu64, cfg, bands64, eband64, targets, row_valid)
    cpu_s = time.perf_counter() - t0
    parity = {"cpu_float64_seconds": cpu_s}
    # float32 with TF32 on is the control: a float32 step of lower
    # precision, which the float32 bars must fail
    for name, dtype, tf32 in (("float64", torch.float64, False),
                              ("float32", torch.float32, False),
                              ("float32_tf32", torch.float32, True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        st = gan.init_train_state(cfg, 0, dev, dtype=dtype)
        st.load_state_dict(state0.state_dict())
        got = parity_run(st, cfg, [x.to(dev) for x in bands64],
                         eband64.to(dev), targets, row_valid)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, cpu_losses))
        parity[name] = dict(state_errors(st, cpu64, origin),
                            loss_rel=loss_rel)
    disable_tf32()
    print(f"card vs CPU float64 ({PARITY_STEPS} G steps, {PARITY_STEPS} D "
          f"steps, from one state): {parity}")
    f64, f32, ctl = (parity[k] for k in ("float64", "float32",
                                         "float32_tf32"))
    if not (max(f64.values()) <= F64_BAR and f32["loss_rel"] <= F32_LOSS_BAR
            and f32["update_rel"] <= F32_UPDATE_BAR):
        raise AssertionError(f"card vs CPU beyond the bars: {parity}")
    if not (ctl["loss_rel"] > F32_LOSS_BAR
            and ctl["update_rel"] > F32_UPDATE_BAR):
        raise AssertionError(f"the float32 bars pass the TF32 control: "
                             f"{parity}")

    checks = {"g_losses": g_losses, "d_losses": d_losses,
              "scan_losses": losses.tolist(), "parity": parity,
              "launches": launches,
              "featurized_batches": featurized,
              "checks_s": time.perf_counter() - t_phase}
    if launches["imcra_scan"] != featurized:
        raise AssertionError(f"imcra_scan launched {launches['imcra_scan']} "
                             f"times for {featurized} featurized batches")
    return checks, (state, feats, eband, targets[0], row_valid)


def time_training(cfg, state, feats, eband, targets, row_valid) -> dict:
    """G-step and D-step times at batch 8 (CUDA events, median of 5 bursts
    of 10 steps), and one G step's device-busy share from torch.profiler,
    with deterministic convolutions off, as a training run uses them."""
    torch.backends.cudnn.deterministic = False
    timed = copy.deepcopy(state)
    tg, tq = targets

    def g_step():
        return gan.g_step(timed, feats, cfg, INTEL_COLS, None, row_valid)

    def d_step():
        return gan.d_step_bands(timed, eband, feats.noise_band,
                                feats.clean_band, feats.frames, tg, tq, cfg,
                                intel_cols=INTEL_COLS, row_valid=row_valid)

    g_ms = cuda_ms(g_step, calls=10)
    d_ms = cuda_ms(d_step, calls=10)
    wall = []
    for _ in range(10):
        t0 = time.perf_counter()
        g_step()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    g_wall_ms = float(np.median(wall)) * 1e3
    prof = profile_step(g_step, g_wall_ms, label="g_step_profile")
    res = {"g_step_ms": g_ms, "d_step_ms": d_ms, "g_step_wall_ms": g_wall_ms,
           "g_utterances_per_s": 8 / g_ms * 1e3,
           "d_utterances_per_s": 8 / d_ms * 1e3,
           "g_device_ms": prof["device_ms_per_batch"],
           "g_device_ops": prof["device_ops_per_batch"],
           "g_busy_share": prof["busy_share"]}
    print(f"training steps at batch 8, bucket {BUCKET} (T = 145), float32, "
          f"TF32 off: G step {g_ms:.3f} ms, D step {d_ms:.3f} ms (CUDA "
          f"events, median of 5 bursts of 10); "
          f"{res['g_utterances_per_s']:.1f} and "
          f"{res['d_utterances_per_s']:.1f} utterances/s; one G step "
          f"{g_wall_ms:.3f} ms host clock, device busy "
          f"{prof['busy_share']:.3f} ({prof['device_ms_per_batch']:.3f} ms, "
          f"{prof['device_ops_per_batch']:.0f} device ops)")
    return res


# -------------------------------------------------------------- streaming
class PsdRecorder:
    """A streaming `noise_psd` hook: runs `fn` and keeps the |Y|^2 each
    chunk step passed and the PSD it got back."""

    def __init__(self, fn):
        self.fn, self.y2, self.psd = fn, [], []

    def __call__(self, y2, rows, ju, l0, cfg):
        psd, rows, ju = self.fn(y2, rows, ju, l0, cfg)
        self.y2.append(y2)
        self.psd.append(psd)
        return psd, rows, ju


def stream_signal(n: int = STREAM_SAMPLES, seed: int = 0):
    clean, noise = speech_signals()
    rng = np.random.RandomState(seed)
    return (crop(clean, n, int(rng.randint(0, clean.size)), 0.8),
            crop(noise, n, int(rng.randint(0, noise.size)), 1.3))


def run_stream(gen, clean, noise, chunk_frames, dev, noise_psd,
               sizes=STREAM_SIZES):
    """The whole stream through a StreamingEnhancer fed in `sizes` pieces,
    then flushed -> (output, enhancer)."""
    se = streaming.StreamingEnhancer(gen, chunk_frames=chunk_frames,
                                     device=dev, noise_psd=noise_psd)
    outs, i, k = [], 0, 0
    while i < clean.size:
        n = sizes[k % len(sizes)]
        k += 1
        outs.append(se.process(clean[i:i + n], noise[i:i + n]))
        i += n
    outs.append(se.flush())
    return np.concatenate(outs), se


def seeded_state(cfg, dev) -> gan.TrainState:
    """A train state whose generator is `seeded_generator(0)`."""
    return gan.init_train_state(cfg, 0, dev,
                                gen_state=seeded_generator(0).state_dict())


def save_seeded_checkpoint(directory: str, cfg, dev) -> str:
    checkpoint.save_checkpoint(directory, 1, seeded_state(cfg, dev),
                               torch.Generator().manual_seed(0),
                               extra={"config": config_to_dict(cfg)})
    return directory


def host_ms(fn, reps: int = 10) -> float:
    """Median host-clock time of `fn` followed by a device synchronise."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def stream_frames(clean, noise, b: int, f: int, step: int):
    """[b, f, 512] frames of b streams at chunk step `step` (stream i
    starts 7 * i hops, modulo 300, into the signals), as clean and noise
    tensors."""
    def one(x, i):
        o = ((7 * i) % 300 + step * f) * 256
        return np.stack([x[o + j * 256:o + j * 256 + 512] for j in range(f)])
    return tuple(torch.from_numpy(np.stack([one(x, i) for i in range(b)]))
                 for x in (clean, noise))


def streaming_checks(gen, dev, cfg) -> dict:
    clean, noise = stream_signal()
    n_frames = 1 + clean.size // 256
    res = {"samples": clean.size, "frames": n_frames}

    # 1. the kernel's stateful launches, chunk by chunk, = one fresh launch
    runs = {}
    for chunk in (8, 1, 16):
        rec = PsdRecorder(streaming.carried_noise_psd)
        kernels.reset_launches()
        out, se = run_stream(gen, clean, noise, chunk, dev, rec)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        launches = counts["imcra_scan"]
        y2, psd = torch.cat(rec.y2, 1), torch.cat(rec.psd, 1)
        fresh = imcra.imcra_psd(y2, cfg.imcra)      # not a stream launch
        fires = int(se.state.imcra_ju[0, 1])
        if not (launches == se.steps == len(rec.psd) and launches > 0):
            raise AssertionError(f"stream at {chunk} frames: {launches} IMCRA "
                                 f"launches for {se.steps} steps")
        if not (y2.shape[1] == n_frames and fires > cfg.imcra.u_buffers):
            raise AssertionError(f"stream: {y2.shape[1]} frames, {fires} "
                                 f"tracker fires")
        if not torch.equal(psd, fresh):
            raise AssertionError(f"stream at {chunk} frames: chunked IMCRA "
                                 f"launches != one fresh launch")
        runs[chunk] = (out, psd, y2, se)
        res[f"chunk{chunk}"] = {"steps": se.steps, "launches": launches,
                                "tracker_fires": fires}
        if chunk == 8:
            res["launches_all"] = counts
    out, psd, y2, se = runs[8]
    res["launches"] = res["chunk8"]["launches"]
    res["steps"] = se.steps
    # the generator's float32 sums round with the chunk's length
    res["chunk_max_diff"] = max(float(np.abs(runs[c][0] - out).max())
                                for c in (1, 16))
    if res["chunk_max_diff"] > STREAM_BAR:
        raise AssertionError(f"stream output depends on the chunk size: "
                             f"{res['chunk_max_diff']}")
    print(f"stream of {clean.size} samples ({n_frames} frames) in pieces "
          f"{list(STREAM_SIZES)}: IMCRA PSD from the chunked stateful "
          f"launches = one fresh launch, bit for bit, at 1, 8 and 16 frames "
          f"a chunk ({res['chunk1']['launches']}, {res['chunk8']['launches']}"
          f", {res['chunk16']['launches']} launches for as many steps; "
          f"{res['chunk8']['tracker_fires']} tracker fires); outputs at 1 and "
          f"16 frames within {res['chunk_max_diff']:.3e} of those at 8")

    # 2. the same stream through the plain IMCRA on the card
    rec = PsdRecorder(streaming.carried_noise_psd_plain)
    out_p, _ = run_stream(gen, clean, noise, 8, dev, rec)
    if not (torch.equal(torch.cat(rec.psd, 1), psd)
            and np.array_equal(out_p, out)):
        raise AssertionError("stream through the plain IMCRA != kernel")
    print("stream through the plain IMCRA on the card: PSDs and output "
          "bit-equal to the kernel's")

    # 3. against the offline causal path on the card
    with torch.inference_mode():
        ref = streaming.enhance_offline_causal(gen, clean, noise,
                                               cfg.train.p_power, cfg.imcra,
                                               dev).cpu().numpy()
        spec = stft(torch.from_numpy(noise).to(dev))
        y2_off = (spec.real * spec.real + spec.imag * spec.imag).T[None]
    res["offline_max_dev"] = float(np.abs(out - ref).max())
    res["offline_peak"] = float(np.abs(ref).max())
    res["y2_equal_offline"] = bool(torch.equal(y2_off, y2))
    print(f"stream vs offline causal path: max |diff| "
          f"{res['offline_max_dev']:.3e} (peak {res['offline_peak']:.4f}, "
          f"bar {STREAM_BAR}); the stream's |Y|^2 "
          f"{'equals' if res['y2_equal_offline'] else 'differs from'} the "
          f"offline STFT's bit for bit")
    if not (out.shape == ref.shape == (256 * (clean.size // 256),)
            and np.isfinite(out).all()
            and res["offline_max_dev"] <= STREAM_BAR):
        raise AssertionError(f"stream vs offline: {res}")

    # 4. output length and the 512-sample latency
    m = 4096 + 100
    se4 = streaming.StreamingEnhancer(gen, chunk_frames=1, device=dev)
    first, total = None, 0
    for i in range(0, m, 256):
        got = se4.process(clean[i:min(i + 256, m)], noise[i:min(i + 256, m)])
        if got.size and first is None:
            first = i + 256
        total += got.size
    total += se4.flush().size
    if not (total == 256 * (m // 256)
            and first == streaming.StreamingEnhancer.LATENCY_SAMPLES):
        raise AssertionError(f"stream of {m}: {total} samples out, first "
                             f"block at {first} samples in")
    print(f"stream of {m} samples: {total} out; the first block came once "
          f"{first} samples were in")

    # 5. B streams in one step = B single streams
    b, f, steps = 8, 8, 3
    singles = [streaming.init_stream_state(gen, 1, device=dev)
               for _ in range(b)]
    batch = streaming.stack_stream_states(singles)
    rec = PsdRecorder(streaming.carried_noise_psd)
    kernels.reset_launches()
    outs_b = []
    with torch.inference_mode():
        for st in range(steps):
            fc, fn = (x.to(dev) for x in stream_frames(clean, noise, b, f, st))
            batch, o = streaming.streaming_step_batch(
                gen, batch, fc, fn, cfg.train.p_power, cfg.imcra, rec)
            outs_b.append(o)
        torch.cuda.synchronize()
        batch_launches = kernels.launches["imcra_scan"]
        worst = 0.0
        for i in range(b):
            st_i = singles[i]
            rows, ju = st_i.imcra_rows, st_i.imcra_ju
            for st in range(steps):
                fc, fn = (x[i].to(dev) for x in stream_frames(clean, noise, b,
                                                              f, st))
                st_i, o = streaming.streaming_step(gen, st_i, fc, fn,
                                                   cfg.train.p_power,
                                                   cfg.imcra)
                worst = max(worst, float((o - outs_b[st][i]).abs().max()))
                # stream i alone through the kernel, on the batch's |Y|^2
                p1, rows, ju = streaming.carried_noise_psd(
                    rec.y2[st][i:i + 1].contiguous(), rows, ju, st * f,
                    cfg.imcra)
                if not torch.equal(p1, rec.psd[st][i:i + 1]):
                    raise AssertionError(f"batched IMCRA, stream {i}, step "
                                         f"{st}: != the stream alone")
    res.update(batch_streams=b, batch_steps=steps,
               batch_launches=batch_launches, batch_max_diff=worst)
    print(f"{b} streams x {steps} steps of {f} frames: {batch_launches} IMCRA "
          f"launches; each stream's IMCRA = the stream alone bit for bit; "
          f"outputs within {worst:.3e} of the single streams")
    if batch_launches != steps or worst > STREAM_BAR:
        raise AssertionError(f"batched streams: {res}")
    return res, se.state, y2


def stateful_kernel_timings(y2: torch.Tensor, cfg) -> dict:
    """The IMCRA kernel's stateful launch as a stream step makes it: 8
    frames (l0 = 100, past the warm-up) from a carried state, for 1 and 64
    streams; graph-replay time beside its bound."""
    rows, ju = imcra.pack_state(imcra.imcra_init(y2.shape[-1], y2.dtype, cfg,
                                                 (1,), y2.device))
    _, rows, ju = streaming.carried_noise_psd(y2[:, :100].contiguous(), rows,
                                              ju, 0, cfg)
    out = {}
    for b in STREAM_BATCHES[1:] + (1,):
        yb, rb, jb = (x.expand((b,) + x.shape[1:]).contiguous()
                      for x in (y2[:, 100:108], rows, ju))
        ms = graph_ms(lambda: imcra.imcra_scan_packed(yb, rb, jb, 100, cfg,
                                                      keep_state=True))
        k = y2.shape[-1]
        n_bytes = 4 * (2 * b * 8 * k + 2 * b * rows.shape[1] * k + 4 * b)
        bound_ms, by = bound(n_bytes, b * k * 8 * IMCRA_OPS_MAIN)
        out[f"streams{b}"] = {"ms": ms, "bound_ms": bound_ms, "bound_by": by}
    print(f"imcra_scan, stateful launch of 8 frames (graph replay): "
          + ", ".join(f"{b} stream(s) {v['ms']:.4f} ms, bound "
                      f"{v['bound_ms']:.6f} ms ({v['bound_by']})"
                      for b, v in ((k[7:], v) for k, v in out.items())))
    return out


def streaming_timings(gen, dev, cfg, state, y2, tmp: str) -> dict:
    clean, noise = stream_signal()
    res = {"imcra_stateful": stateful_kernel_timings(y2, cfg.imcra)}
    with torch.inference_mode():
        steps = {}
        for f in (1, 8):
            fc, fn = (x[0].to(dev) for x in stream_frames(clean, noise, 1, f,
                                                          5))
            steps[f] = functools.partial(streaming.streaming_step, gen, state,
                                         fc, fn, cfg.train.p_power, cfg.imcra)
        # in turns, twice each: one reading of each was seen to depend on
        # its place in the run
        for f in (1, 8, 1, 8):
            res.setdefault(f"step_ms_{f}", []).append(cuda_ms(steps[f]))
            res.setdefault(f"step_host_ms_{f}", []).append(host_ms(steps[f]))
        prof = profile_step(steps[8], float(np.median(res["step_host_ms_8"])),
                            label="stream_step_profile")
        res["busy_share_8"] = prof["busy_share"]
        res["device_ms_8"] = prof["device_ms_per_batch"]
        res["device_ops_8"] = prof["device_ops_per_batch"]
        for b in STREAM_BATCHES:
            batch = streaming.stack_stream_states([state] * b)
            fc, fn = (x.to(dev) for x in stream_frames(clean, noise, b, 8, 0))
            ms = cuda_ms(lambda: streaming.streaming_step_batch(
                gen, batch, fc, fn, cfg.train.p_power, cfg.imcra))
            res[f"batch{b}_step_ms"] = ms
            res[f"batch{b}_frames_per_s"] = b * 8 / ms * 1e3
    # the CLI: real-time factor at two feed sizes
    ck = save_seeded_checkpoint(f"{tmp}/stream_ckpt", cfg, dev)
    write_wav_pcm16(f"{tmp}/c.wav", clean)
    write_wav_pcm16(f"{tmp}/n.wav", noise)
    for chunk_ms in (16, 128):
        r = stream.main(["--clean", f"{tmp}/c.wav", "--noise", f"{tmp}/n.wav",
                         "--out", f"{tmp}/e.wav", "--checkpoint", ck,
                         "--chunk-ms", str(chunk_ms), "--compare-offline",
                         "--device", "cuda"])
        if not (r["samples"] == 256 * (clean.size // 256)
                and r["offline_max_dev"] <= STREAM_BAR):
            raise AssertionError(f"cli.stream at {chunk_ms} ms: {r}")
        res[f"rtf_{chunk_ms}ms"] = r["rtf"]
        res[f"chunk_ms_p50_{chunk_ms}ms"] = r["chunk_ms_p50"]
    print(f"streaming, one stream: step {res['step_ms_1']} ms at 1 frame, "
          f"{res['step_ms_8']} ms at 8 (CUDA events, in turns; host clock "
          f"{res['step_host_ms_1']}, {res['step_host_ms_8']} ms), "
          f"device busy {res['busy_share_8']:.3f} of an 8-frame step; RTF "
          f"{res['rtf_16ms']:.4f} at 16 ms chunks, {res['rtf_128ms']:.4f} at "
          f"128 ms; " + ", ".join(
              f"B = {b}: {res[f'batch{b}_frames_per_s']:.0f} frames/s "
              f"({res[f'batch{b}_step_ms']:.3f} ms a step of 8 frames)"
              for b in STREAM_BATCHES))
    return res


def streaming_phase(dev) -> dict:
    """The streaming path at full width, float32, TF32 off; every check
    raises.  Launch counts are zeroed before each run and read after it:
    the IMCRA kernel runs once per chunk step."""
    cfg = Config()
    gen = seeded_generator(0).to(dev).eval()
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        res, state, y2 = streaming_checks(gen, dev, cfg)
        res.update(streaming_timings(gen, dev, cfg, state, y2, tmp))
    res["phase_s"] = time.perf_counter() - t0
    print(f"streaming phase: {res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------------------ infer
def write_corpus(root: str) -> int:
    """INFER_PER_BUCKET utterances in each of INFER_BUCKETS, cut from the
    golden speech and noise at seeded offsets and scales, as PCM16 wavs
    under root/Clean and root/Noise."""
    clean, noise = speech_signals()
    rng = np.random.RandomState(9)
    for sub in ("Clean", "Noise"):
        Path(root, sub).mkdir(parents=True)
    k = 0
    for lo, hi in INFER_BUCKETS:
        for _ in range(INFER_PER_BUCKET):
            n = int(rng.randint(lo, hi + 1))
            off, s = int(rng.randint(0, clean.size)), float(rng.uniform(0.5,
                                                                        1.5))
            name = f"u{k:02d}#Cafeteria#{k}.wav"
            write_wav_pcm16(f"{root}/Clean/{name}", crop(clean, n, off, s))
            write_wav_pcm16(f"{root}/Noise/{name}",
                            crop(noise, n, off + 99, s))
            k += 1
    return k


def infer_phase(dev) -> dict:
    """cli.infer over a corpus written here, from a port checkpoint of the
    seeded generator; every check raises.  Launch counts are zeroed before
    the CLI runs and read after it and one `mmse_lsa_enhance` call."""
    cfg = Config()
    gen = seeded_generator(0).to(dev).eval()
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        n_utts = write_corpus(f"{tmp}/corpus")
        ck = save_seeded_checkpoint(f"{tmp}/ckpt", cfg, dev)
        args = ["--test-clean", f"{tmp}/corpus/Clean", "--test-noise",
                f"{tmp}/corpus/Noise", "--checkpoint", ck, "--metrics", "",
                "--device", "cuda"]
        kernels.reset_launches()
        first = infer.main(args + ["--output", f"{tmp}/out"])
        g = speech_signals()
        spec = stft(torch.from_numpy(g[0] + g[1]).to(dev))
        enh = mmse.mmse_lsa_enhance(spec)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        if not (len(first["written"]) == n_utts
                and launches["imcra_scan"] == first["batches"] + 1):
            raise AssertionError(f"infer: {len(first['written'])} files, "
                                 f"{launches} launches for "
                                 f"{first['batches']} batches + 1 MMSE call")
        warm = infer.main(args + ["--output", f"{tmp}/out2"])

        # 1. the files = enhance_batch on the same batches; 2. the plain
        # IMCRA path within 1 LSB
        index = CorpusIndex(sorted(get_filepaths(f"{tmp}/corpus/Clean")),
                            f"{tmp}/corpus/Noise")
        n_diff = n_total = max_lsb = 0
        for batch in BucketedLoader(index, 8, shuffle=False)():
            q = {}
            with torch.inference_mode():
                for key, psd in (("kernel", imcra.imcra_psd),
                                 ("plain", plain_noise_psd)):
                    feats = pipeline.featurize_batch(
                        batch.clean, batch.noise, batch.lengths,
                        cfg.train.p_power, cfg.imcra, device=dev,
                        noise_psd=psd)
                    wav, _, out_len = pipeline.enhance_batch(gen, feats,
                                                             device=dev)
                    q[key] = pipeline.pcm16_quantize_i16(wav).cpu().numpy()
            for i, name in enumerate(batch.names):
                m = int(out_len[i])
                path = f"{tmp}/out/{name[:-4]}@1.wav"
                got = (read_wav(path)[0] * 32768.0).astype(np.int16)
                if not np.array_equal(got, q["kernel"][i, :m]):
                    raise AssertionError(f"infer: {path} != enhance_batch")
                d = np.abs(got.astype(np.int32) - q["plain"][i, :m])
                n_diff += int((d > 0).sum())
                n_total += d.size
                max_lsb = max(max_lsb, int(d.max()))
        print(f"infer: {n_utts} files equal enhance_batch on the same "
              f"batches; against the plain IMCRA path {n_diff} of {n_total} "
              f"samples differ, max {max_lsb} LSB")
        if max_lsb > 1:
            raise AssertionError("infer PCM16 beyond 1 LSB of the plain path")

        # 3. mmse_lsa_enhance's IMCRA (its own config) = the plain loop
        mcfg = ImcraConfig(alpha_dd=0.92, xi_min=10.0 ** (-25.0 / 20.0),
                           is_frames=10)
        y2 = (spec.real * spec.real
              + spec.imag * spec.imag).T[None].contiguous()
        k_psd = imcra.imcra_estimate_psd(spec, mcfg).T[None]
        p_psd = imcra.imcra_scan_plain(y2, None, 0, mcfg)[0]
        if not (torch.equal(k_psd, p_psd) and torch.isfinite(enh).all()
                and enh.shape == spec.shape):
            raise AssertionError("mmse_lsa_enhance: kernel IMCRA != plain")
        print(f"mmse_lsa_enhance on {list(spec.shape)}: its IMCRA (is_frames "
              f"10) bit-equal to the plain loop")
    res = {"utterances": n_utts, "batches": first["batches"],
           "launches": launches, "pcm16_diff_samples": n_diff,
           "pcm16_total_samples": n_total, "max_lsb": max_lsb,
           "phase_s": time.perf_counter() - t0}
    for key, r in (("first", first), ("warm", warm)):
        res[key] = {k: r[k] for k in ("seconds", "read_s", "write_s",
                                      "fetch_s", "dispatch_s")}
        res[key]["utterances_per_s"] = n_utts / r["seconds"]
        res[key]["io_s"] = r["read_s"] + r["write_s"]
        res[key]["device_s"] = r["dispatch_s"] + r["fetch_s"]
    print(f"infer: {res['warm']['utterances_per_s']:.1f} utterances/s end to "
          f"end on the second run ({res['first']['utterances_per_s']:.1f} on "
          f"the first, with new cuFFT plans); wav I/O "
          f"{res['warm']['io_s']:.4f} s, dispatch and device "
          f"{res['warm']['device_s']:.4f} s; phase {res['phase_s']:.1f} s")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    disable_tf32()

    secs = kernels.build()
    print(f"built {sorted(kernels.KERNELS)} in {secs:.2f} s")

    records = [imcra_phase(dev), cascade_phase(dev)]
    serving = serving_phase(dev)
    training = training_phase(dev)
    streamed = streaming_phase(dev)
    inferred = infer_phase(dev)
    for rec in records:
        rec["launches"] = serving["launches"][rec["name"]]
        rec["training_launches"] = training["launches"][rec["name"]]
        rec["infer_launches"] = inferred["launches"][rec["name"]]
    records[0]["training_featurized_batches"] = training["featurized_batches"]
    records[0]["streaming_steps"] = streamed["steps"]
    for rec in records:
        rec["streaming_launches"] = streamed["launches_all"][rec["name"]]
    records[0]["infer_batches_plus_mmse_calls"] = inferred["batches"] + 1
    print(json.dumps({"serving": {k: v for k, v in serving.items()
                                  if k not in ("launches", "profile")}}))
    print(json.dumps({"training": training}))
    print(json.dumps({"streaming": streamed}))
    print(json.dumps({"infer": inferred}))
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
