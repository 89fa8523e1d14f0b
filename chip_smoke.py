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
  5. one JSON line of kernel records, the card line again, and last
     `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import multiprocessing
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from nelegan_tpu_torch import kernels, pipeline
from nelegan_tpu_torch.cli.serve import EnhanceServer, enhance_remote
from nelegan_tpu_torch.config import ImcraConfig
from nelegan_tpu_torch.device import disable_tf32
from nelegan_tpu_torch.dsp import imcra
from nelegan_tpu_torch.dsp.stft import stft
from nelegan_tpu_torch.models.generator import Generator
from nelegan_tpu_torch.ops import cascade

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "goldens" / "features.npz"

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
            feats = pipeline.featurize_batch(
                cp, npd, lens, device=dev,
                noise_psd=lambda y2, cfg: imcra.imcra_scan_plain(y2, None, 0,
                                                                 cfg)[0])
            wav, _, out_len = pipeline.enhance_batch(gen, feats, device=dev)
            q = pipeline.pcm16_quantize_i16(wav).cpu().numpy()
        for j, i in enumerate(idx):
            out[i] = q[j, :int(out_len[j])]
    return out


def profile_step(server, cp, npd, lens, batch_ms: float, reps: int = 5):
    """Device time of one served batch by kernel, from torch.profiler, and
    the share of the batch's host-clock time the device is busy."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            server._step(cp, npd, lens)
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
    print(json.dumps({"profile": out}))
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
    prof = profile_step(server, cp, npd, lens, batch_ms)
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
    for rec in records:
        rec["launches"] = serving["launches"][rec["name"]]
    print(json.dumps({"serving": {k: v for k, v in serving.items()
                                  if k not in ("launches", "profile")}}))
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
