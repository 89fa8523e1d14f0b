"""Traffic kind `enhance_closed`: batched enhancement, one batch in flight.

As `cli/infer --batch-size B` dispatches a corpus: each batch is B
utterances of one 4096-sample bucket, reflect-padded on the host as PCM16
(`pipeline.reflect_pad_batch`), then `featurize_batch` (STFT, bands, the
IMCRA kernel's noise PSD), `enhance_batch` (generator, beta^2,
resynthesis, RMS) and `pcm16_quantize_i16`, and the int16 rows come back to
the host.  A batch's time runs from its host PCM16 rows to its PCM16
output on the host.  The client holds both in page-locked host memory,
as a server keeps its request buffers: copies through pageable memory
cost the host a memcpy and page faults a batch, on a shared host the
noisiest part of a batch's time.

Set-up makes one batch for each bucket of `len_s` from the seed (every
seed the same lengths; only the content and the order change), draws the
generator from the seed by the port's own draw, and runs every batch once.
The window cycles through the batches in an order drawn from the seed
until `--seconds` have passed.  `enhance_utts_per_s` is the utterances
returned over the window, `enhance_batch_p95_ms` the 95th percentile of
the window's batch times.  A traced run then runs eight more passes over
the batches under the profiler (the device's activity only), each call
into the program a host span.

The comparison (`reference/enhance.py`) holds the PCM16 of the window's
first pass over the batches and of a sample of later batches, drawn from
the seed, against the reference's.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import statistics
import time

import numpy as np
import torch

from portbench import compare, trace
from portbench.traffic import corpus


def pool_lengths(t: dict) -> list:
    """[(bucket, lengths)] of one batch a bucket: the same for every seed."""
    lo, hi = (int(round(x * corpus.FS)) for x in t["len_s"])
    q, bs = int(t["bucket_quant"]), int(t["batch_size"])
    out = []
    for b in range(-(-lo // q) * q, -(-hi // q) * q + 1, q):
        a, z = max(lo, b - q + 1), min(hi, b)
        out.append((b, np.round(np.linspace(a, z, bs)).astype(np.int64)))
    return out


def make_pool(seed: int, t: dict, device) -> list:
    """[(clean int16 [B, b + 512], noise, lengths)] reflect-padded for the
    program (page-locked on a card), each with its raw rows, lengths and
    bucket for the reference."""
    from nelegan_tpu_torch.pipeline import reflect_pad_batch
    rng = np.random.default_rng([seed, 29])
    pool = []
    for k, (b, lens) in enumerate(pool_lengths(t)):
        n = len(lens)
        kinds = [corpus.NOISE_KINDS[i % 4] for i in rng.permutation(n)]
        snrs = [corpus.SNRS_DB[i % 3] for i in rng.permutation(n)]
        rows = corpus.make_rows(seed, 8 + k, lens, kinds, snrs, device)
        cp, ln = reflect_pad_batch([rows["clean"][i, :lens[i]]
                                    for i in range(n)], b)
        npad, _ = reflect_pad_batch([rows["noise"][i, :lens[i]]
                                     for i in range(n)], b)
        pinned = [torch.from_numpy(a).pin_memory()
                   if torch.device(device).type == "cuda"
                   else torch.from_numpy(a) for a in (cp, npad)]
        pool.append((*pinned, ln, rows["clean"], rows["noise"], lens, b))
    return pool


def run(ctx, control: bool = False) -> None:
    from nelegan_tpu_torch import kernels, pipeline
    from nelegan_tpu_torch.config import config_from_dict
    from nelegan_tpu_torch.device import disable_tf32
    from nelegan_tpu_torch.models.generator import Generator

    t, dev = ctx.traffic, ctx.device
    t_setup = time.perf_counter()
    disable_tf32()                      # as cli/infer runs
    if dev.type == "cuda":
        kernels.build()
        torch.cuda.synchronize(dev)         # the context exists
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = config_from_dict(ctx.config)
    p, rms = cfg.train.p_power, cfg.train.target_rms
    pool = make_pool(ctx.seed, t, dev)
    with torch.random.fork_rng(devices=[]):
        gen = Generator.from_config(cfg.model)
    gen.reset_parameters(torch.Generator().manual_seed(int(ctx.seed)))
    gen = gen.to(dev).eval()
    if ctx.fault is not None:
        ctx.fault("generator", gen)

    traced = []                     # the trace.Window while one is open

    def span(name):
        return traced[0].span(name) if traced else contextlib.nullcontext()

    # one page-locked output buffer a batch shape, reused
    outs = {}
    for cp, _, ln, *_rest in pool:
        shape = (len(ln), cp.shape[1] - 512)
        outs[shape] = torch.empty(shape, dtype=torch.int16,
                                  pin_memory=dev.type == "cuda")

    def batch(k):
        cp, npad, ln = pool[k][:3]
        with span("pb.featurize"):
            feats = pipeline.featurize_batch(cp, npad, ln, p, cfg.imcra,
                                             device=dev)
        with span("pb.enhance"):
            wavs, _, _ = pipeline.enhance_batch(gen, feats, p, rms,
                                                device=dev)
        with span("pb.quantize"):
            q = pipeline.pcm16_quantize_i16(wavs)
        with span("pb.to_host"):
            out = outs[tuple(q.shape)]
            out.copy_(q)
        out = out.numpy()
        if ctx.fault is not None:
            out = ctx.fault("output", out)
        return out

    with torch.no_grad():
        for k in range(len(pool)):
            batch(k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_setup

    def shape(k):
        return (len(pool[k][2]),
                pipeline.valid_frames(pool[k][0].shape[1] - 512))

    rng = np.random.default_rng([ctx.seed, 31])
    order = rng.permutation(len(pool)).tolist()
    kept = {}                  # (window batch index, pool batch) -> output
    sample_every = int(t["sample_every"])
    times = []
    i = 0
    with torch.no_grad():
        t0 = time.perf_counter()
        while True:
            k = order[i % len(order)]
            tb = time.perf_counter()
            out = batch(k)
            times.append(time.perf_counter() - tb)
            if i < len(order) or rng.integers(sample_every) == 0:
                kept[(i, k)] = out.copy()
            i += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
        if dev.type == "cuda":
            ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
        if ctx.trace:
            # the traced window: eight more passes over the batches
            with trace.Window(dev) as window:
                traced.append(window)
                for _ in range(8):
                    for k in order:
                        batch(k)
            traced.clear()
            ctx.window = window
            ctx.layer["batches"] = [shape(k) for k in order] * 8
    # (rows, frames, batches) of the window's batches, for its FLOPs
    ran = collections.Counter(order[j % len(order)] for j in range(i))
    ctx.layer["window_batches"] = [(*shape(k), c) for k, c in ran.items()]
    ctx.layer["model"] = ctx.config["model"]
    bs = int(t["batch_size"])
    ctx.attempted = i * bs
    ctx.report("enhance_utts_per_s", ctx.attempted / window_s, "utts/s")
    p95 = (statistics.quantiles(times, n=20)[-1] if len(times) > 1
           else times[0])
    ctx.report("enhance_batch_p95_ms", p95 * 1e3, "ms")
    ctx.report("setup_s", setup_s, "s")

    del gen
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from portbench.reference import enhance as ref_enhance
    side = {"pcm": {key: out for key, out in kept.items()}}
    ref = ref_enhance.Reference(ctx.config, ctx.seed, pool, dev)
    t1 = time.perf_counter()
    rec_r = ref.records(kept, precision="stated")
    ctx.layer["reference_s"] = time.perf_counter() - t1
    ctx.layer["window"] = {"batches": i, "window_s": window_s,
                           "kept": len(kept),
                           "batch_ms_quartiles": [
                               1e3 * q for q in statistics.quantiles(
                                   times, n=4)] if len(times) > 1 else None}
    compare.define_all(ctx.checks, compare.enhance_numbers(side, rec_r))
    if control:
        ctx.layer["program"] = compare.enhance_numbers(side, rec_r)
        ctx.layer["control"] = compare.enhance_numbers(
            ref.records(kept, precision="lower"), rec_r)
        ctx.layer["faults"] = {
            f: compare.enhance_numbers(ref.records(kept, fault=f), rec_r)
            for f in ("half_batch", "altered_answer")}
