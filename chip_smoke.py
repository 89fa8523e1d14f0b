#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, `nelegan_tpu_torch`.

    python3 chip_smoke.py

Needs one CUDA GPU (sm_90a: H100) and `nvcc`; exits non-zero without them,
and in a directory that holds this file and nothing else of the repository.
`python3 chip_smoke.py --fault-hunt N [SECONDS]` runs only the hunt for
the fault of ROADMAP section 3 (see `fault_hunt`); `python3 chip_smoke.py
--sanitize-launches` only launches the trainer path's kernels once each at
its shapes, for `compute-sanitizer` to watch (see `sanitize_launches`).
Phases, in order; any failure raises.  From the trainer phase on, every
Trainer the script makes, in this process, in a spawned rank or in a CLI
run, is under the generator guard (`install_generator_guard`): its
generator must leave epoch 1 bit-equal to its draw, checked after
`init_train_state`, after `Trainer.__init__`, after each phase of epoch 1
and at its end; a violation names the point, the tensor and the changed
elements, and fails the run:

  1. the card, as `nvidia-smi --query-gpu=name,power.limit` prints it;
  2. build the kernels from nelegan_tpu_torch/csrc (one nvcc per source,
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
     packed wrapper of a scan from `imcra_init`.  The first-order
     recurrence `linrec` (ops/iir) with an initial state at [32, 55296]
     with one pole a row and [8, 55296] with a pole per step, float32 and
     complex64 (synthetic long rows: no path runs linrec at these shapes
     yet), against its plain loop on the card (bar LINREC_BAR) and one
     row against the host's float64, over several windows of a cluster
     (2 x 200001), at one sample and in the short-row form (8 x 143); its
     backward (`linrec_bwd`: db, da, dy0) at the same shapes, every row
     against the plain adjoint in float64 on the card (bar LINREC_BAR of
     each row's largest |lam|; a per-row da of the sum of its terms'
     magnitudes) and row 0 (at 2 x 200001 every row) against the host's
     float64 adjoint (a per-row da and dy0 relative to their own values),
     two runs bit for bit, at [4, 4096] against autograd through the plain
     loop on the card, and the gradients of `middle_ear` and `biquad`
     against the port's CPU float64; every form forward and backward timed by graph replay on the
     same inputs and rotating through more than ROTATE_BYTES of inputs (the
     roofline share on the latter), [8, 143] beside the launch floor (the
     short form at one sample), and the cuFFT convolution with the
     truncated impulse response as the yardstick for one pole a row (for
     the backward on the reversed rows); the scan-form middle ear (three
     linrec launches) against the spectral fold the ear model uses (bar
     MIDDLE_EAR_BAR);
     `one_pole_cascade` (both forms) and `linear_recurrence_2x2` on the
     card against the host's float64; float64 linrec and linrec_bwd (one
     pole a row and a pole per step, with y0) at [8, 143] and [2, 200001]
     against linrec_plain and linrec_backward_plain in float64 on the card
     (LINREC_F64_BAR), timed by graph replay beside float32; then IMCRA,
     linrec and linrec_bwd at the trainer path's shapes on outputs fenced
     by GUARD_ELEMENTS sentinel elements on each side (`guard_checks`, in
     place of compute-sanitizer, which does not run on the card's machine):
     no guard byte changed, every output element written, the inputs
     unchanged, the outputs equal to the wrappers' bit for bit;
  3b. gradient phase: a loss through the scan form of HASPI's middle ear
     on [8, 55296] (eight 36864-sample utterances at 24 kHz; synthetic, as
     no path of either package differentiates it: HASPI folds it into its
     spectrum) and through PESQ of eight rows of the 36864-sample bucket
     with their n_valid (its gain memory one linrec of [8, 143]), then its
     backward; launch counts zeroed just before and read just after (4
     `linrec`, 4 `linrec_bwd`); the middle ear's gradient against its
     spectral adjoint (MIDDLE_EAR_BAR), PESQ's scores and its gradient with
     respect to the degraded rows against the CPU's float64 (SCORE_BARS,
     PESQ_GRAD_BAR in norm), zero past each row's n_valid;
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
  8. scoring phase (`metrics/`, `cli/infer --metrics`), float32, TF32 off:
     the infer phase's 24 utterances go through `cli/infer --metrics
     siib,haspi,estoi,pesq,visqol` (launch counts zeroed before and read
     after: one `linrec` launch for each of its 24 PESQ calls) and through
     `score_corpus` with vmap_chunk 8 (one `linrec` launch a chunk);
     score_corpus (padded rows) against score_batch within the reference
     package's bucketed bars; a chunk-keyed clean-cache hit equal to its
     cold fill and within CACHE_BAR of the pair path; a CleanSidePool in
     chunks of 4: cold, warm on the same chunks and with enhanced_keys on
     the PCM16 files, each equal to the upload path bit for bit; warm on
     reshuffled chunks within CACHE_BAR of cold and of the uncached path
     on those chunks; with its hits and misses; three utterances, one a
     bucket, against the CPU's float64 within SCORE_BARS, which the
     controls (TF32 on; SIIB's KLT in float32) must fail; PESQ with all three alignment stages on the
     two-jump burst train against the CPU's float64; the ear model against
     tests/goldens/ear_model.npz (EAR_GOLDEN_BAR); utterances/s per metric
     and for all five, cold and warm, by host clock and CUDA events; one
     profile (busy share, top device operations); SIIB's eigh time against
     its warm time;
  9. trainer phase (`train/loop.py`, `train/resilience.py`), float32, TF32
     off, deterministic cuDNN; first the initial state's draw on this
     host's CPU (`draw_invariance`: init_train_state(Config(), seed 0) in
     fresh processes under ATEN_CPU_CAPABILITY=default at one thread and
     at the host's own capability at all threads, every tensor bit-equal;
     the digest printed beside the CPU test's); then over PCM16 corpora
     written under the temporary directory: at full width (Config(),
     batch 8; 32 training utterances with a pre-enhanced copy at half
     gain, 8 test ones, in the three infer buckets; 16 sampled and 8
     validated an epoch; all five metrics) three epochs, launch counts
     zeroed just before each epoch and read just after (IMCRA once per
     featurized batch, linrec once per PESQ chunk, the cascade and
     linrec_bwd never), every scoring lookup of the enhanced rows the
     loop parked in the pool a hit; exact resume: a second
     run of epochs 1-2, then a fresh Trainer resumes from a copy of its
     checkpoints and runs epoch 3, bit for bit against that run with its
     caches emptied before epoch 3 (state with Adam moments and u/v,
     replay, history, log.txt), and within CACHE_BAR (scores) and
     F32_UPDATE_BAR (state) of the straight run with warm caches; a fourth
     epoch profiled (torch.profiler, the device's activity alone) for the
     device-busy share of g_train and d_train.  At a small config (hidden
     32, 2 blocks, batch 4, 8 training
     utterances, ESTOI and PESQ): run_with_recovery with a fault injected
     in epoch 2 against a straight run emptied before epoch 2, bit for bit;
     the card against the CPU from the same initial state, the card's D
     trained on the CPU's scores (names and replay paths identical, the
     card's own scores within SCORE_BARS of the CPU's float64 scores of
     the same files, as the bars are defined; G's epoch loss within
     F32_LOSS_BAR, the D heads' epoch losses and the state within
     F32_UPDATE_BAR; the card's scores against the CPU run's scores of
     its own files within ROUNDOFF_MULTIPLE times the same gap of the CPU
     against itself from an initial state one float32 ulp away, or within
     SCORE_BARS).  At the paper's epoch size (300 sampled of 300
     training utterances, 480 validated), two epochs, cold and warm, with
     their launch counts.  Per epoch: phase seconds, G and D steps, pool
     hits, misses and bytes, training utterances/s;
 10. mixed-precision phase (`compute_dtype="bfloat16"`, models/), full
     width, batch 8, bucket 36864, TF32 off: the same weights and inputs
     under both policies (equal float32 initial states), the bfloat16 mask
     against float32 on valid frames within the reference package's bars
     (mean and max relative, MP_MEAN_BAR and MP_MAX_BAR) and both
     discriminators' scores within MP_SCORE_BAR, all outputs float32; one
     bfloat16 G step and D step (finite losses; parameters, u and v float32,
     finite, moved); G-step and D-step times, busy shares and top device
     operations under each policy; a bfloat16 Trainer for two epochs (cold,
     warm) on the trainer phase's corpus, beside that phase's float32
     epochs, IMCRA and linrec once per featurized batch and PESQ chunk;
 11. direct phase (`train/direct.py`): the seeded full-width generator and
     the training batch's eight rows, featurized once (one IMCRA launch);
     the direct loss with ESTOI, HASPI and PESQ (weights 1) and its
     gradient in float32 on the card against the CPU's float64 on
     DIRECT_CPU_ROWS rows (DIRECT_LOSS_BAR, DIRECT_GRAD_BAR for each
     parameter in norm); DIRECT_STEPS ESTOI steps: the loss falls and the
     real ESTOI (PCM16 enhanced output plus noise) rises over the seeded
     weights'; a step's time by term (ESTOI; + HASPI; + PESQ; CUDA events),
     its peak memory, one step's busy share; linrec and linrec_bwd once per
     step that weighs PESQ and never otherwise, IMCRA never in the steps;
     one ESTOI + PESQ step under the bfloat16 policy, finite;
 12. eval phase (`cli/eval_reverb`, `cli/collect_norm`,
     `cli/export_torch`, `dsp/reverb.py`, P.56, MMSE-LSA; `eval_phase`):
     the synthetic corpus of tools/make_synth_corpus.py (seed 1234,
     EVAL_UTTS training and test utterances), synthetic RIRs of T60 0.3
     and 0.9 s, the seeded full-width checkpoint; `fir_filter` against
     lfilter (FIR_BAR, float64); eval_reverb (NO_rev and both RIRs, all
     five metrics, batch EVAL_BATCH) through its main, IMCRA once a batch
     and condition and linrec once a PESQ call, its first EVAL_CPU_UTTS
     utterances against the same CLI on the CPU (EVAL_BARS on each
     mean); collect_norm with --rir-dir, calibrated and raw (calibrated =
     make_mappers_np of raw; the first values' means against the CPU
     run); export_torch generator-only and full bit-equal to the CPU's
     export and the checkpoint, the exported generator's PCM16 bit-equal
     on a serving batch; P.56 at [16, 33536] float64 against the golden
     (ASL_GOLDEN_BAR) and the CPU (ASL_F64_BAR); mmse_lsa_enhance against
     the CPU's float64 (MMSE_BAR); rates, shares and launches;
 13. parallel phase (`parallel/`, torch.distributed), float32, TF32 off,
     deterministic cuDNN: NCCL probed with two ranks on the one card (it
     refuses: its words are printed); the mesh's collectives (replicate,
     all-reduce, all-gather) over NCCL in a world of this process alone,
     each bit-equal to its input; `cli/train --data-parallel` in a
     torchrun world of one over NCCL against the CLI without it, one after
     the other (one epoch of the small corpus; log.txt and the checkpoint
     bit for bit), then two plain CLI runs side by side under torch's
     deterministic-algorithms check, their initial states, checkpoints
     and generators through epoch 1 bit-equal (ROADMAP section 3's fault,
     fixed: the host's draw of the initial state); the recovery of a
     torchrun world: the CLI with `--data-parallel --max-retries 1`
     under `--max-restarts 1`, a world of one over NCCL, RECOVERY_EPOCHS
     epochs of the small corpus, its
     first attempt failing at the start of epoch FAULT_EPOCH once
     `latest` names the epoch before, against the world of one above
     resumed by hand (`--resume`) to RECOVERY_EPOCHS: log.txt and the
     checkpoint's state, key, replay and history bit for bit, every
     attempt launching IMCRA and linrec (each attempt's launches and
     seconds, and the agent's restart time, reported); then two gloo
     ranks on the card (`parallel.launch`, CUDA
     tensors staged through the host) train the trainer phase's
     full-width run for two epochs, their D on the single run's scores,
     against that phase's straight run of the same epochs: the ranks'
     states bit-equal after every epoch, names and replay paths equal,
     epoch-1 PCM16 within 1 LSB, rank 0's scores within SCORE_BARS of
     the CPU's float64 scores of the same files and within ROUNDOFF_MULTIPLE
     times (or SCORE_BARS) the gap of a single run on the card one ulp
     away from the single run's scores, G's
     epoch loss within F32_LOSS_BAR, the D heads' and the state within
     F32_UPDATE_BAR, epoch 2's pool misses at most the single run's, one
     all-reduce per optimizer step, IMCRA and linrec once per featurized
     shard and PESQ chunk on each rank, each rank's PESQ rows fewer than
     the single run's (scoring sharded); a third epoch profiled for the
     device-busy shares as the single run's; epoch seconds by phase,
     utterances/s and
     all-reduce ms per G and D step per rank, beside the single run's;
     then, in the same world, tensor parallelism: a second mesh of model
     axis TP_MODEL (data axis 1), the full-width state from one seed
     sharded over it (`shard_params`), one G and one D step at batch 8 of
     the 36864 bucket featurized on each rank's card (IMCRA once a rank)
     against the same steps on rank 0 alone: G's loss within
     F32_LOSS_BAR, the D losses and the gathered state's update
     (`gather_params`) within F32_UPDATE_BAR, the replicated leaves
     bit-equal on both ranks; G- and D-step times for single, dp
     (4 rows a rank) and tp, with each step's collectives by tag and
     their host-clock ms;
 14. report phase (`cli/train_report.py`): the report for REPORT_EPOCHS
     epochs of one seed of `b8_f32` on the small corpus, launch counts
     zeroed just before and read just after (IMCRA and linrec must run);
     its multiseed.json and MULTISEED.md written, its untrained baseline
     within SCORE_BARS of a fresh Trainer's `validate(epoch=0)`, and a
     second call skipping the recorded seed without a launch;
 15. one JSON line per phase, one of kernel records (each with its launches
     on the serving, training, streaming, infer, scoring, gradient,
     trainer, mixed-precision, direct, eval and report paths, per rank on the
     parallel one and its tensor-parallel part, per attempt of the
     recovered world, and in the kernel phase;
     `launches` is its own path's: serving for IMCRA and the cascade,
     scoring for linrec, the direct phase for linrec_bwd), the card line
     again, and last `{"ok": true, "device": ...}`.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import copy
import dataclasses
import functools
import glob
import hashlib
import io
import itertools
import inspect
import json
import math
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

from nelegan_tpu_torch import kernels, metrics, parallel, pipeline, streaming
from nelegan_tpu_torch.cli import (collect_norm, eval_reverb, export_torch,
                                   infer, stream, train_report)
from nelegan_tpu_torch.cli.serve import EnhanceServer, enhance_remote
from nelegan_tpu_torch.config import Config, ImcraConfig, config_to_dict
from nelegan_tpu_torch.data.pipeline import (BucketedLoader, CorpusIndex,
                                             get_filepaths)
from nelegan_tpu_torch.data.wavio import read_wav, write_wav_pcm16
from nelegan_tpu_torch.device import disable_tf32
from nelegan_tpu_torch.dsp import asl_p56, imcra, mmse
from nelegan_tpu_torch.dsp.reverb import fir_filter
from nelegan_tpu_torch.dsp.stft import stft
from nelegan_tpu_torch.metrics.calibrate import make_mappers_np
from nelegan_tpu_torch.metrics.clean_pool import CleanSidePool
from nelegan_tpu_torch.metrics.haspi.ear_model import (_ME_A, _ME_B,
                                                       ear_model, middle_ear,
                                                       middle_ear_response)
from nelegan_tpu_torch.metrics.siib import (_capacity, _klt, _stack_pair,
                                            siib_prepare)
from nelegan_tpu_torch.models import convert
from nelegan_tpu_torch.models.generator import Generator
from nelegan_tpu_torch.ops import cascade, iir
from nelegan_tpu_torch.parallel import launch
from nelegan_tpu_torch.train import checkpoint, direct, gan
from nelegan_tpu_torch.train.loop import Trainer, TrainPaths
from nelegan_tpu_torch.train.replay import ReplayEntry
from nelegan_tpu_torch.train.resilience import run_with_recovery

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
# linrec kernel, synthetic long rows: no path of either package runs linrec
# at these shapes (the ear model folds the middle ear into its spectrum; the
# one queued caller, PESQ's gain memory, is [8, PESQ_FRAMES]).  The length
# is HASPI's 24 kHz length of a 36864-sample utterance; 32 rows with one pole
# each and 8 rows with a pole per step.
LINREC_N = 55296
LINREC_BAR = 1e-5        # relative to each row's largest |y|, float32
# (the backward: of each row's largest |lam|; against the host's float64, a
# per-row da and dy0 relative to their own values; against the float64 plain
# adjoint on every row, a per-row da to the sum of its terms' magnitudes)
LINREC_FORMS = (("real_per_row", 32, False, False, 20),
                ("real_per_step", 8, True, False, 21),
                ("complex_per_row", 32, False, True, 22),
                ("complex_per_step", 8, True, True, 23))
ROTATE_BYTES = 100e6     # rotating timings: over twice the H100's 50 MB L2
PESQ_FRAMES = 143        # P.862 frames (512, hop 256) of 36864 samples
MIDDLE_EAR_BAR = 1e-5    # the scan against the spectral fold, relative
# Scoring phase bars against the CPU's float64 score of the same file, on
# |card - cpu| / max(|cpu|, 1) (rel_errors), fixed in PERF.md before the
# phase first ran: ~10 times the port's float32 error on the CPU, below the
# control's (TF32 on; for SIIB its KLT and capacity in float32, its
# arithmetic without the float64 the reference package gets under x64),
# which must fail each.  PESQ's and ViSQOL's: the port's float32 on
# the CPU is 1.0e-7 to 1.9e-7 from its float64 on 1-2.3 s crops of the
# golden speech, so PESQ's bar is 2e-6; ViSQOL's is 1e-5, with room for the
# algorithm cuDNN picks for its 3x3 box; TF32 (emulated on the CPU by
# rounding the matrix products' and the box's operands) moves them by
# 8.5e-6 to 9.7e-6 and 9.4e-5 to 3.8e-4.
SCORE_BARS = {"estoi": 5e-6, "haspi": 5e-5, "siib": 5e-4, "pesq": 2e-6,
              "visqol": 1e-5}
# SCORE_BARS hold a score against the CPU's float64 score of the same file.
# Two training runs' scores of their own files also differ by each run's
# float32 round-off carried through its epochs, which a run one float32
# ulp away from the same initial state measures (the control, in the same
# call): such a gap is held to the larger of SCORE_BARS and this many times
# the control's.  The card's gaps read 1.07 and 1.37 times the control's
# (PESQ, ESTOI, on an H100, PERF.md); a fault (a score given to another file, a
# wrong kernel) moves scores by orders of magnitude more.
ROUNDOFF_MULTIPLE = 4
HASPI_F32_BAR = 2e-3     # the reference package's own (COMPONENTS.md:38)
EAR_GOLDEN_BAR = 5e-5    # float32 ear model on the card against the golden
CACHE_BAR = 1e-5         # a clean-cache hit against the pair path
# score_corpus against score_batch: tests/test_metrics_bucketed.py's bars
CORPUS_BARS = {"estoi": 1e-3, "haspi": 5e-3, "pesq": 1e-3, "visqol": 1e-3}
SCORE_METRICS = ("siib", "haspi", "estoi", "pesq", "visqol")
# PESQ's gradient with respect to the degraded rows on the card (float32)
# against the CPU's float64, in norm, fixed in PERF.md before the first run:
# the port's float32 on the CPU reads 2.4e-6 at [4, 36864].
PESQ_GRAD_BAR = 5e-5
# float64 linrec and linrec_bwd against their plain loops in float64 on the
# card, relative as LINREC_BAR: float64 round-off.
LINREC_F64_BAR = 1e-12
# Trainer phase: the loop at full width over TRAINER_TRAIN training and
# TRAINER_TEST test utterances in INFER_BUCKETS' three buckets, for
# TRAINER_EPOCHS epochs; its recovery and CPU checks at a small config
# (hidden 32, 2 blocks, batch 4) over TRAINER_SMALL_TRAIN and
# TRAINER_SMALL_TEST utterances, scoring TRAINER_SMALL_METRICS; and two
# epochs at the paper's size, PAPER_SAMPLED of PAPER_SAMPLED training
# utterances sampled and PAPER_VALID validated an epoch (train_nele.py's
# num_sampling and validation set).
TRAINER_TRAIN, TRAINER_TEST, TRAINER_EPOCHS = 32, 8, 3
TRAINER_SMALL_TRAIN, TRAINER_SMALL_TEST = 8, 4
TRAINER_SMALL_METRICS = ("estoi", "pesq")
PAPER_SAMPLED, PAPER_VALID, PAPER_EPOCHS = 300, 480, 2
# Parallel phase: DP_WORLD ranks on the one card train DP_EPOCHS epochs of
# the trainer phase's full-width run (and a traced one after them); then
# the same ranks on a mesh of model axis TP_MODEL take G and D steps,
# TP_TIMED of each timed per form after two warm ones, TP_TRACED more with
# the mesh's collectives timed
DP_WORLD, DP_EPOCHS = 2, 2
TP_MODEL, TP_TIMED, TP_TRACED = 2, 10, 2
# the recovered torchrun world runs RECOVERY_EPOCHS epochs of the small
# corpus, its first attempt failing at the start of FAULT_EPOCH; the
# report phase trains REPORT_EPOCHS epochs of one seed
RECOVERY_EPOCHS, FAULT_EPOCH = 3, 2
REPORT_EPOCHS, REPORT_SEED = 2, 101
# Mixed-precision phase: the bfloat16 mask against float32 on valid frames
# within the reference package's bars (tests/test_mixed_precision.py:68-69:
# mean and max relative difference), both discriminators' scores within
# MP_SCORE_BAR (:83); the bfloat16 trainer runs MP_EPOCHS epochs.
MP_MEAN_BAR, MP_MAX_BAR, MP_SCORE_BAR = 0.03, 0.25, 0.02
MP_EPOCHS = 2
# Direct phase: the card's float32 direct loss (ESTOI + HASPI + PESQ,
# weights 1) and each parameter's gradient against the CPU's float64 on
# DIRECT_CPU_ROWS rows, fixed in PERF.md before the first run at about ten
# times the port's float32 on the CPU against its float64 on the same
# inputs (loss 5.6e-7, gradients up to 3.3e-6 in norm); DIRECT_STEPS ESTOI
# steps; each term's step timed DIRECT_TIMED times.
DIRECT_CPU_ROWS = 2
DIRECT_LOSS_BAR = 5e-6
DIRECT_GRAD_BAR = 3e-5
DIRECT_STEPS = 12
DIRECT_TIMED = 5
DIRECT_TERMS = (("estoi", 0.0, 0.0), ("estoi_haspi", 1.0, 0.0),
                ("estoi_haspi_pesq", 1.0, 1.0))
# tests/test_pesq.py's burst train with a delayed middle section, for the
# alignment stages on the card
BURSTS, BURST_LEN, GAP_LEN, JUMP = 10, 1920, 2880, 1900


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


def profiler_ms(fn, kernel: str, calls: int = 10,
                attempts: int = 3) -> float:
    """Device time per call of the kernels named `kernel`, torch.profiler
    over `calls` calls.  A trace that holds none of the kernel's device
    time is taken again, up to `attempts` traces: a second run of this
    script on one machine once read an empty trace of `linrec_bwd`'s
    kernel after an earlier one of the same kernel had recorded it."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(_device_us(e) for e in prof.key_averages()
                 if kernel in e.key)
        if us > 0:
            return us / calls / 1e3
    raise RuntimeError(f"torch.profiler recorded no device time for "
                       f"{kernel} in {attempts} traces")


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


# ---------------------------------------------------------------- linrec
def linrec_inputs(dev, rows: int, n: int, per_step: bool, cplx: bool,
                  seed: int, f64: bool = False):
    """Seeded a, b, y0 on the card: |a| in [0.5, 0.99] (complex: any
    phase), b and y0 standard normal; float32 (f64: float64)."""
    rng = np.random.RandomState(seed)
    shape = (rows, n) if per_step else (rows,)
    a = rng.uniform(0.5, 0.99, shape) * rng.choice([-1.0, 1.0], shape)
    b = rng.randn(rows, n)
    y0 = rng.randn(rows)
    dt = torch.float64 if f64 else torch.float32
    if cplx:
        a = np.abs(a) * np.exp(1j * rng.uniform(-np.pi, np.pi, shape))
        b = b + 1j * rng.randn(rows, n)
        y0 = y0 + 1j * rng.randn(rows)
        dt = torch.complex64
    return tuple(torch.as_tensor(v).to(dt).to(dev).contiguous()
                 for v in (a, b, y0))


def host_recurrence(a: np.ndarray, b: np.ndarray, y0) -> np.ndarray:
    """One row in float64 (complex128) on the host: lfilter for one pole a
    row, a loop for a pole per step."""
    from scipy.signal import lfilter
    if a.ndim == 0:
        return lfilter([1.0], [1.0, -a], b, zi=[a * y0])[0]
    y, s = np.empty_like(b), y0
    for i in range(b.size):
        s = a[i] * s + b[i]
        y[i] = s
    return y


def linrec_checks(dev, rows: int, n: int, per_step: bool, cplx: bool,
                  seed: int, plain: bool = True) -> dict:
    """The kernel against its plain version on the card (when `plain`) and
    row 0 against the host's float64; raises beyond LINREC_BAR."""
    a, b, y0 = linrec_inputs(dev, rows, n, per_step, cplx, seed)
    y = iir.linrec(a, b, y0)
    ref = iir.linrec_plain(a, b, y0) if plain else None
    torch.cuda.synchronize()
    wide = np.complex128 if cplx else np.float64
    got = y.cpu().numpy()
    row0 = host_recurrence(a[0].cpu().numpy().astype(wide),
                           b[0].cpu().numpy().astype(wide),
                           y0[0].cpu().numpy().astype(wide))
    rec = {"shape": [rows, n], "a": "per step" if per_step else "per row",
           "type": "complex64" if cplx else "float32",
           "rel_vs_host_f64": float(np.abs(got[0] - row0).max()
                                    / np.abs(row0).max())}
    if plain:
        want = ref.cpu().numpy()
        scale = np.abs(want).max(1)
        rec["rel_vs_plain"] = float((np.abs(got - want).max(1) / scale).max())
        rec["max_abs_err"] = float(np.abs(got - want).max())
        rec["plain_rel_vs_host_f64"] = float(np.abs(want[0] - row0).max()
                                             / np.abs(row0).max())
    print(f"linrec at {rec['shape']} ({rec['a']}, {rec['type']}, with y0): "
          f"{rec}")
    if not all(v < LINREC_BAR for k, v in rec.items() if "rel" in k):
        raise AssertionError(f"linrec beyond {LINREC_BAR}: {rec}")
    return rec


def host_adjoint(a: np.ndarray, g: np.ndarray, y: np.ndarray, y0):
    """One row's adjoint in float64 (complex128) on the host, from the
    float64 forward y: lam[n] = g[n] + conj(a[n+1]) lam[n+1] (lfilter of
    the reversed row for one pole a row, a loop for a pole per step), then
    da (per step, or its sum) and dy0."""
    from scipy.signal import lfilter
    ca = np.conj(a)
    if a.ndim == 0:
        lam = lfilter([1.0], [1.0, -ca], g[::-1])[::-1]
    else:
        lam, s = np.empty_like(g), 0.0
        for i in range(g.size - 1, -1, -1):
            s = (ca[i + 1] * s if i + 1 < g.size else 0.0) + g[i]
            lam[i] = s
    d = lam * np.conj(np.concatenate([[y0], y[:-1]]))
    return lam, (d if a.ndim else d.sum()), (ca[0] if a.ndim else ca) * lam[0]


def adjoint_errors(got, want) -> dict:
    """(db, da, dy0) of rows against their float64 values: db and a per-step
    da relative to each row's largest magnitude, a per-row da and dy0 each
    relative to its own value."""
    def rows_rel(x, w):
        x, w = np.atleast_2d(x), np.atleast_2d(w)
        return float((np.abs(x - w).max(1) / np.abs(w).max(1)).max())

    def each_rel(x, w):
        return float((np.abs(x - w) / np.abs(w)).max())
    db, da, dy0 = got
    wb, wa, wy = want
    return {"db_rel": rows_rel(db, wb),
            "da_rel": rows_rel(da, wa) if np.ndim(wa) == np.ndim(wb)
            else each_rel(da, wa), "dy0_rel": each_rel(dy0, wy)}


def adjoint_rows_errors(got, want, y, y0) -> dict:
    """(db, da, dy0) of every row against `want`, on the card in float64:
    db and dy0 relative to the row's largest |lam|, a per-step da to the
    row's largest |da|, a per-row da to the sum of its terms' magnitudes,
    sum_n |lam[n] y[n-1]| with y[-1] = y0 (y, y0 those `want` was formed
    from).  That sum is the scale of a sum's rounding: the per-row sums at
    the seeded inputs cancel by up to ~6000 times, so their own values are
    no scale for float32 (`da_rel_own` reports it, ungated)."""
    wide = torch.complex128 if want[0].is_complex() else torch.float64
    db, da, dy0, wb, wa, wy, y, y0 = (t.to(wide) for t in (*got, *want, y, y0))
    lam = wb.abs().amax(1)

    def worst(err, scale):
        return float((err / scale).max())
    rec = {"db_rel": worst((db - wb).abs().amax(1), lam),
           "dy0_rel": worst((dy0 - wy).abs(), lam)}
    if wa.dim() == 2:
        rec["da_rel"] = worst((da - wa).abs().amax(1), wa.abs().amax(1))
    else:
        prev = torch.cat([y0[:, None], y[:, :-1]], 1)
        rec["da_rel"] = worst((da - wa).abs(), (wb.abs() * prev.abs()).sum(1))
        rec["da_rel_own"] = worst((da - wa).abs(), wa.abs())
    return rec


def linrec_backward_checks(dev, rows: int, n: int, per_step: bool,
                           cplx: bool, seed: int, plain: bool = True) -> dict:
    """The kernel's adjoint (db, da, dy0) for a seeded output gradient:
    every row against the plain adjoint in float64 on the card (when
    `plain`; adjoint_rows_errors), row 0 (every row without `plain`)
    against the host's float64 adjoint of the float64 forward, and two runs
    bit for bit; raises beyond LINREC_BAR."""
    a, b, y0 = linrec_inputs(dev, rows, n, per_step, cplx, seed)
    rng = np.random.RandomState(seed + 100)
    g = rng.randn(rows, n) + (1j * rng.randn(rows, n) if cplx else 0)
    g = torch.as_tensor(g).to(b.dtype).to(dev)
    y = iir.linrec(a, b, y0)
    got = iir.linrec_backward(a, g, y, y0)
    again = iir.linrec_backward(a, g, y, y0)
    if plain:
        a64, b64, y064, g64 = (t.to(torch.complex128 if cplx
                                    else torch.float64) for t in (a, b, y0, g))
        y64 = iir.linrec_plain(a64, b64, y064)
        vs_plain = adjoint_rows_errors(
            got, iir.linrec_backward_plain(a64, g64, y64, y064), y64, y064)
    torch.cuda.synchronize()
    wide = np.complex128 if cplx else np.float64
    host = {}
    for r in (0,) if plain else range(rows):
        ar, br, y0r, gr = (t[r].cpu().numpy().astype(wide)
                           for t in (a, b, y0, g))
        errs = adjoint_errors(
            [t[r].cpu().numpy() for t in got],
            host_adjoint(ar, gr, host_recurrence(ar, br, y0r), y0r))
        host = {k: max(v, host.get(k, 0.0)) for k, v in errs.items()}
    rec = {"shape": [rows, n], "a": "per step" if per_step else "per row",
           "type": "complex64" if cplx else "float32",
           "host_f64_rows": 1 if plain else rows, **host,
           "bit_equal_runs": all(torch.equal(u, v)
                                 for u, v in zip(got, again))}
    if plain:
        rec["vs_plain_f64"] = vs_plain
    print(f"linrec backward at {rec['shape']} ({rec['a']}, {rec['type']}, "
          f"with y0) against float64: {rec}")
    errs = [v for k, v in rec.items() if k.endswith("_rel")]
    errs += [v for k, v in rec.get("vs_plain_f64", {}).items()
             if k.endswith("_rel")]
    if not rec["bit_equal_runs"] or not all(v < LINREC_BAR for v in errs):
        raise AssertionError(f"linrec backward: {rec}")
    return rec


def linrec_backward_vs_autograd(dev) -> dict:
    """The adjoint kernel against autograd through the raw plain loop on the
    card at [4, 4096], all four forms; raises beyond LINREC_BAR."""
    rows, n = 4, 4096
    out = {}
    for per_step, cplx in ((False, False), (True, False), (False, True),
                           (True, True)):
        a, b, y0 = (t.requires_grad_() for t in linrec_inputs(
            dev, rows, n, per_step, cplx, 30 + 2 * per_step + cplx))
        rng = np.random.RandomState(40)
        g = rng.randn(rows, n) + (1j * rng.randn(rows, n) if cplx else 0)
        g = torch.as_tensor(g).to(b.dtype).to(dev)
        want = torch.autograd.grad(iir.linrec_plain(a, b, y0), (b, a, y0), g)
        got = torch.autograd.grad(iir.linrec(a, b, y0), (b, a, y0), g)
        key = (f"{'complex' if cplx else 'real'}_"
               f"{'per_step' if per_step else 'per_row'}")
        out[key] = adjoint_errors([t.cpu().numpy() for t in got],
                                  [t.cpu().numpy() for t in want])
    print(f"linrec backward at [{rows}, {n}] against the plain loop's "
          f"autograd: {out}")
    if not all(v < LINREC_BAR for r in out.values() for v in r.values()):
        raise AssertionError(f"linrec backward vs autograd: {out}")
    return out


def filter_gradient_checks(dev) -> dict:
    """d sum(w * f(x)) / dx through middle_ear and biquad on the card
    (float32, the adjoint kernel) against the port's CPU in float64 (the
    plain adjoint); raises beyond LINREC_BAR of the largest gradient."""
    rng = np.random.RandomState(14)
    x, w = rng.randn(2, 6000), rng.randn(2, 6000)
    fns = {"middle_ear": middle_ear,
           "biquad": lambda v: iir.biquad(v, _ME_B, _ME_A)}
    rec = {}
    for name, fn in fns.items():
        grads = []
        for d, dt in ((dev, torch.float32), ("cpu", torch.float64)):
            xt = torch.as_tensor(x, dtype=dt, device=d).requires_grad_()
            (torch.as_tensor(w, dtype=dt, device=d) * fn(xt)).sum().backward()
            grads.append(xt.grad.double().cpu().numpy())
        rec[name] = float(np.abs(grads[0] - grads[1]).max()
                          / np.abs(grads[1]).max())
    print(f"gradients on the card against the CPU's float64: {rec}")
    if not all(v < LINREC_BAR for v in rec.values()):
        raise AssertionError(f"filter gradients: {rec}")
    return rec


def middle_ear_check(dev) -> dict:
    """The scan-form middle ear (a 2-tap FIR, then linrec for the one-pole
    and the biquad's two complex poles) against the closed-form response
    `_ear_core` folds into its spectrum, at the ear core's FFT size."""
    x = torch.from_numpy(np.random.RandomState(11).randn(2, LINREC_N)
                         .astype(np.float32)).to(dev)
    m = iir._fft_len_ir(LINREC_N, 4096)

    def fold():
        spec = torch.fft.fft(x.to(torch.complex64), m)
        return torch.fft.ifft(spec * middle_ear_response(
            m, torch.complex64, dev))[:, :LINREC_N].real

    before = kernels.launches["linrec"]
    scan = middle_ear(x)
    launched = kernels.launches["linrec"] - before
    want = fold()
    torch.cuda.synchronize()
    rel = float((scan - want).abs().max() / want.abs().max())
    rec = {"shape": [2, LINREC_N], "fft_size": m, "rel_err": rel,
           "linrec_launches": launched, "scan_ms": cuda_ms(
               lambda: middle_ear(x)), "fold_ms": cuda_ms(fold)}
    print(f"middle ear, scan (linrec) against the spectral fold: {rec}")
    if rel >= MIDDLE_EAR_BAR or launched != 3:
        raise AssertionError(f"middle ear scan vs fold: {rec}")
    return rec


def iir_checks(dev) -> dict:
    """ops/iir's other users of linrec on the card against the host's
    float64: a four-stage cascade (one_pole_cascade, both forms) and a
    constant 2x2 system (linear_recurrence_2x2, run as its two complex
    one-poles); raises beyond LINREC_BAR."""
    from scipy.signal import lfilter
    rng = np.random.RandomState(12)
    x = rng.randn(4, 20000)
    m = np.array([[0.5, 0.3], [-0.2, 0.8]])
    v = rng.randn(20000, 2)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    before = kernels.launches["linrec"]
    got = {"cascade": iir.one_pole_cascade(xt, 0.97, 4),
           "cascade_blocked": iir.one_pole_cascade(xt, 0.97, 4, blocked=True),
           "recurrence_2x2": iir.linear_recurrence_2x2(
               torch.as_tensor(m, dtype=torch.float32, device=dev),
               torch.as_tensor(v, dtype=torch.float32, device=dev))}
    launched = kernels.launches["linrec"] - before
    den = np.poly([0.97] * 4)
    want = {"cascade": lfilter([1.0], den, x), "cascade_blocked":
            lfilter([1.0], den, x), "recurrence_2x2":
            iir.linear_recurrence_2x2(torch.from_numpy(m),
                                      torch.from_numpy(v)).numpy()}
    rec = {k: float(np.abs(got[k].cpu().numpy() - w).max() / np.abs(w).max())
           for k, w in want.items()}
    rec["linrec_launches"] = launched
    print(f"ops/iir on the card against float64: {rec}")
    if launched != 9 or not all(v < LINREC_BAR for k, v in rec.items()
                                if k != "linrec_launches"):
        raise AssertionError(f"ops/iir on the card: {rec}")
    return rec


def linrec_work(rows: int, n: int, per_step: bool, cplx: bool,
                backward: bool) -> tuple[int, int]:
    """Bytes (each input read once, each output written once) and operations
    of one call: forward b, a, y0 in and y out, 2 (real) or 8 (complex)
    flops a sample; backward g, y, a, y0 in and db, da, dy0 out, twice the
    flops (lam and da)."""
    item = 8 if cplx else 4
    a = rows * (n if per_step else 1)
    if backward:
        n_bytes = item * (3 * rows * n + 2 * a + 2 * rows)
    else:
        n_bytes = item * (2 * rows * n + a + rows)
    return n_bytes, (8 if cplx else 2) * (2 if backward else 1) * rows * n


def rotating_ms(fn, sets: list) -> float:
    """graph_ms of fn over the argument sets in turn, so that no call finds
    its inputs in the L2 cache."""
    it = itertools.cycle(sets)
    return graph_ms(lambda: fn(*next(it)), calls=max(20, len(sets)))


def linrec_timings(dev) -> dict:
    """Every form, forward and backward, replayed on the same inputs and
    rotating through input sets of more than ROTATE_BYTES; the roofline
    share on the rotating time.  Then PESQ's gain-memory shape [8, 143]
    beside the launch floor: the short form at one sample, a launch that
    does next to nothing."""
    timed = {}
    for key, rows, per_step, cplx, seed in LINREC_FORMS:
        def one_set(i):
            a, b, y0 = linrec_inputs(dev, rows, LINREC_N, per_step, cplx,
                                     seed + 1000 * i)
            g = torch.randn(b.shape, dtype=b.dtype, device=dev,
                            generator=torch.Generator(dev).manual_seed(i))
            return a, b, y0, g, iir.linrec(a, b, y0)
        for backward in (False, True):
            n_bytes, n_ops = linrec_work(rows, LINREC_N, per_step, cplx,
                                         backward)
            sets = [one_set(i) for i in range(
                int(np.ceil(ROTATE_BYTES / n_bytes)) + 1)]
            if backward:
                def fn(a, b, y0, g, y):
                    return iir.linrec_backward(a, g, y, y0)
            else:
                def fn(a, b, y0, g, y):
                    return iir.linrec(a, b, y0)
            bms, by = bound(n_bytes, n_ops)
            ms = rotating_ms(fn, sets)
            timed[f"{key}_{'backward' if backward else 'forward'}"] = {
                "shape": [rows, LINREC_N], "ms": ms,
                "same_inputs_ms": graph_ms(lambda: fn(*sets[0])),
                "rotating_sets": len(sets), "bound_ms": bms, "bound_by": by,
                "roofline_share": bms / ms}
            del sets
    rng = np.random.RandomState(26)
    a, y0 = (torch.full((8,), v, device=dev) for v in (0.2, 1.0))
    b = torch.as_tensor(0.8 * rng.uniform(0, 1, (8, PESQ_FRAMES)),
                        dtype=torch.float32, device=dev)
    g = torch.as_tensor(rng.randn(8, PESQ_FRAMES), dtype=torch.float32,
                        device=dev)
    y = iir.linrec(a, b, y0)
    a1, b1 = torch.ones(1, device=dev), torch.ones(1, 1, device=dev)
    short = {"shape": [8, PESQ_FRAMES],
             "forward_ms": graph_ms(lambda: iir.linrec(a, b, y0)),
             "backward_ms": graph_ms(lambda: iir.linrec_backward(a, g, y, y0)),
             "one_sample_launch_ms": graph_ms(lambda: iir.linrec(a1, b1)),
             "plain_forward_ms": cuda_ms(lambda: iir.linrec_plain(a, b, y0),
                                         calls=1, samples=3, warmup=1),
             "plain_backward_ms": cuda_ms(
                 lambda: iir.linrec_backward_plain(a, g, y, y0), calls=1,
                 samples=3, warmup=1)}
    for key, backward in (("forward", False), ("backward", True)):
        short[f"{key}_bound_ms"], short[f"{key}_bound_by"] = bound(
            *linrec_work(8, PESQ_FRAMES, False, False, backward))
    print(f"linrec times (graph replay; share on rotating inputs): {timed}; "
          f"[8, {PESQ_FRAMES}]: {short}")
    return {"forms": timed, "short_rows": short}


def linrec_f64_checks(dev) -> dict:
    """float64 linrec and linrec_bwd (db, da, dy0) with an initial state,
    one pole a row and a pole per step, in the short-row form ([8, 143],
    PESQ's gain memory) and over several windows of a cluster ([2,
    200001]), against linrec_plain and linrec_backward_plain in float64 on
    the card (bar LINREC_F64_BAR; the backward as adjoint_rows_errors),
    and two backward runs bit for bit; then graph-replay times of one pole
    a row at both shapes, float64 beside float32."""
    checks = []
    for rows, n, per_step, seed in ((8, PESQ_FRAMES, False, 60),
                                    (8, PESQ_FRAMES, True, 61),
                                    (2, 200001, False, 62),
                                    (2, 200001, True, 63)):
        a, b, y0 = linrec_inputs(dev, rows, n, per_step, False, seed,
                                 f64=True)
        g = torch.as_tensor(np.random.RandomState(seed + 100).randn(rows, n),
                            device=dev)
        y = iir.linrec(a, b, y0)
        got = iir.linrec_backward(a, g, y, y0)
        again = iir.linrec_backward(a, g, y, y0)
        want = iir.linrec_plain(a, b, y0)
        want_b = iir.linrec_backward_plain(a, g, want, y0)
        torch.cuda.synchronize()
        rec = {"shape": [rows, n], "a": "per step" if per_step else "per row",
               "type": "float64",
               "rel_vs_plain": float(((y - want).abs().amax(1)
                                      / want.abs().amax(1)).max()),
               "max_abs_err": float((y - want).abs().max()),
               "backward_vs_plain": adjoint_rows_errors(got, want_b, want,
                                                        y0),
               "bit_equal_runs": all(torch.equal(u, v)
                                     for u, v in zip(got, again))}
        checks.append(rec)
        errs = [rec["rel_vs_plain"]] + [
            v for k, v in rec["backward_vs_plain"].items()
            if k.endswith("_rel")]
        print(f"linrec float64 at {rec['shape']} ({rec['a']}, with y0) "
              f"against the plain loops in float64: {rec}")
        if not rec["bit_equal_runs"] or not all(v < LINREC_F64_BAR
                                                for v in errs):
            raise AssertionError(f"linrec float64: {rec}")
    times = {}
    for rows, n in ((8, PESQ_FRAMES), (2, 200001)):
        for f64 in (False, True):
            a, b, y0 = linrec_inputs(dev, rows, n, False, False, 64, f64=f64)
            g = torch.randn(b.shape, dtype=b.dtype, device=dev,
                            generator=torch.Generator(dev).manual_seed(3))
            y = iir.linrec(a, b, y0)
            times[f"{rows}x{n}_{'float64' if f64 else 'float32'}"] = {
                "forward_ms": graph_ms(lambda: iir.linrec(a, b, y0)),
                "backward_ms": graph_ms(
                    lambda: iir.linrec_backward(a, g, y, y0))}
    print(f"linrec float64 against float32, graph replay, one pole a row: "
          f"{times}")
    return {"checks": checks, "times": times}


def linrec_phase(dev) -> list:
    main = linrec_checks(dev, 32, LINREC_N, False, False, 20)
    others = [linrec_checks(dev, 8, LINREC_N, True, False, 21),
              linrec_checks(dev, 32, LINREC_N, False, True, 22),
              linrec_checks(dev, 8, LINREC_N, True, True, 23),
              # several windows of a cluster, and the shortest row
              linrec_checks(dev, 2, 200001, True, True, 24, plain=False),
              linrec_checks(dev, 3, 1, True, False, 25),
              # the short-row form
              linrec_checks(dev, 8, PESQ_FRAMES, False, False, 27)]
    backward = [linrec_backward_checks(dev, rows, LINREC_N, per_step, cplx,
                                       seed)
                for _, rows, per_step, cplx, seed in LINREC_FORMS]
    backward += [linrec_backward_checks(dev, 2, 200001, True, True, 24,
                                        plain=False),
                 linrec_backward_checks(dev, 8, PESQ_FRAMES, False, False,
                                        27)]
    vs_autograd = linrec_backward_vs_autograd(dev)
    gradients = filter_gradient_checks(dev)
    me = middle_ear_check(dev)
    users = iir_checks(dev)
    f64 = linrec_f64_checks(dev)
    times = linrec_timings(dev)
    timed = times["forms"]

    a, b, y0 = linrec_inputs(dev, 32, LINREC_N, False, False, 20)
    g = torch.as_tensor(np.random.RandomState(120).randn(32, LINREC_N),
                        dtype=torch.float32, device=dev)
    y = iir.linrec(a, b, y0)
    prof_ms = profiler_ms(lambda: iir.linrec(a, b, y0), "linrec_tiles")
    prof_bwd_ms = profiler_ms(lambda: iir.linrec_backward(a, g, y, y0),
                              "linrec_tiles")
    eager_ms = cuda_ms(lambda: iir.linrec(a, b, y0))
    plain_ms = cuda_ms(lambda: iir.linrec_plain(a, b, y0), calls=1,
                       samples=1, warmup=0)
    got = iir.linrec_backward(a, g, y, y0)
    t0 = time.perf_counter()
    want = iir.linrec_backward_plain(a, g, y, y0)
    torch.cuda.synchronize()
    plain_bwd_ms = (time.perf_counter() - t0) * 1e3
    bwd_err = max(float((u - v).abs().max()) for u, v in zip(got, want))
    bwd_rel = adjoint_rows_errors(got, want, y, y0)
    if not all(v < LINREC_BAR for k, v in bwd_rel.items()
               if k.endswith("_rel")):
        raise AssertionError(f"linrec backward vs plain: {bwd_rel}")
    # yardstick for one pole a row: the cuFFT convolution with the impulse
    # response a^k, truncated where max|a|^L falls below 1e-7 (from y0 = 0);
    # for the backward the same on the reversed rows of g
    amax = float(a.abs().max())
    ir_len = int(np.ceil(np.log(1e-7) / np.log(amax)))
    m = iir._fft_len_ir(LINREC_N, ir_len)
    k = torch.arange(ir_len, device=dev, dtype=torch.float32)
    h = torch.sign(a)[:, None] ** k * a.abs()[:, None] ** k   # built once

    def library():
        return torch.fft.irfft(torch.fft.rfft(b, m) * torch.fft.rfft(h, m),
                               m)[:, :LINREC_N]

    def library_bwd():
        return torch.fft.irfft(torch.fft.rfft(g.flip(1), m)
                               * torch.fft.rfft(h, m), m)[:, :LINREC_N].flip(1)

    lib, lib_b = library(), library_bwd()
    zero = iir.linrec(a, b)
    torch.cuda.synchronize()
    lib_rel = float((lib - zero).abs().max() / zero.abs().max())
    lib_b_rel = float((lib_b - got[0]).abs().max() / got[0].abs().max())
    library_ms, library_bwd_ms = graph_ms(library), graph_ms(library_bwd)
    fwd_t = timed["real_per_row_forward"]
    bwd_t = timed["real_per_row_backward"]
    print(f"linrec [32, {LINREC_N}] one pole a row: forward {fwd_t['ms']:.5f} "
          f"ms rotating, {fwd_t['same_inputs_ms']:.5f} same inputs, "
          f"{prof_ms:.5f} (profiler), {eager_ms:.4f} (eager); plain "
          f"{plain_ms:.1f} ms; cuFFT yardstick (size {m}, impulse response "
          f"{ir_len}) {library_ms:.4f} ms, {lib_rel:.2e} from the kernel; "
          f"bound {fwd_t['bound_ms']:.6f} ms, share "
          f"{fwd_t['roofline_share']:.3f}.  Backward {bwd_t['ms']:.5f} ms "
          f"rotating, {bwd_t['same_inputs_ms']:.5f} same inputs, "
          f"{prof_bwd_ms:.5f} (profiler); plain {plain_bwd_ms:.1f} ms "
          f"({bwd_rel} from it); yardstick {library_bwd_ms:.4f} ms; "
          f"bound {bwd_t['bound_ms']:.6f} ms, share "
          f"{bwd_t['roofline_share']:.3f}")
    common = {"route": "cuda", "source": "nelegan_tpu_torch/csrc/linrec.cu",
              "bound_by": "bytes", "shape": [32, LINREC_N]}
    forward_rec = {
        "name": "linrec", **common,
        "replaces": "nelegan_tpu/ops/iir.py:38 (one_pole's associative_scan;"
                    " also :83, one_pole_blocked's carries, and :240, "
                    "linear_recurrence_2x2; no Pallas kernel)",
        "max_abs_err": main["max_abs_err"], "ms": fwd_t["ms"],
        "same_inputs_ms": fwd_t["same_inputs_ms"], "plain_ms": plain_ms,
        "bound_ms": fwd_t["bound_ms"], "bound_by": fwd_t["bound_by"],
        "library_ms": library_ms,
        "library": f"irfft(rfft(b, {m}) * rfft(h, {m}))[:, :{LINREC_N}], "
                   f"h = a^k truncated at {ir_len} (zero initial state)",
        "library_rel_err": lib_rel, "profiler_ms": prof_ms,
        "eager_ms": eager_ms, "roofline_share": fwd_t["roofline_share"],
        "forms": timed, "short_rows": times["short_rows"],
        # the path's shape: PESQ's gain memory, [8, 143] a batch
        "path_shape": [8, PESQ_FRAMES],
        "path_ms": times["short_rows"]["forward_ms"],
        "path_plain_ms": times["short_rows"]["plain_forward_ms"],
        "path_bound_ms": times["short_rows"]["forward_bound_ms"],
        "rel_err_vs_plain": main["rel_vs_plain"],
        "rel_err_vs_host_f64": main["rel_vs_host_f64"],
        "other_shapes": others, "middle_ear": me, "iir_users": users,
        "float64": f64}
    backward_rec = {
        "name": "linrec_bwd", **common,
        "replaces": "nelegan_tpu/ops/iir.py:38 (JAX's autodiff of "
                    "one_pole's associative_scan; also :83 and :240; no "
                    "Pallas kernel)",
        "max_abs_err": bwd_err, "rel_err_vs_plain": bwd_rel,
        "ms": bwd_t["ms"],
        "same_inputs_ms": bwd_t["same_inputs_ms"], "plain_ms": plain_bwd_ms,
        "bound_ms": bwd_t["bound_ms"], "bound_by": bwd_t["bound_by"],
        "library_ms": library_bwd_ms,
        "library": f"the same cuFFT convolution on g's reversed rows (db)",
        "library_rel_err": lib_b_rel, "profiler_ms": prof_bwd_ms,
        "roofline_share": bwd_t["roofline_share"], "checks": backward,
        "path_shape": [8, PESQ_FRAMES],
        "path_ms": times["short_rows"]["backward_ms"],
        "path_plain_ms": times["short_rows"]["plain_backward_ms"],
        "path_bound_ms": times["short_rows"]["backward_bound_ms"],
        "vs_plain_autograd": vs_autograd, "filter_gradients": gradients}
    return [forward_rec, backward_rec]


GUARD_ELEMENTS = 16384      # sentinel elements on each side of an output
SENTINEL = 0xA5             # every byte of a guard and of an unwritten output


def guarded(shape, dtype, dev) -> tuple:
    """(output, buffer): a contiguous output of `shape` inside a flat buffer
    with GUARD_ELEMENTS elements before and after it, every byte SENTINEL."""
    n = int(np.prod(shape))
    buf = torch.empty(n + 2 * GUARD_ELEMENTS, dtype=dtype, device=dev)
    buf.view(torch.uint8).fill_(SENTINEL)
    return buf[GUARD_ELEMENTS:GUARD_ELEMENTS + n].view(shape), buf


def fence_errors(out: torch.Tensor, buf: torch.Tensor) -> dict:
    """Guard bytes a launch changed around `out`, and elements of `out`
    (4-byte) it left unwritten."""
    g = GUARD_ELEMENTS * buf.element_size()
    raw = buf.view(torch.uint8)
    word = int.from_bytes(bytes([SENTINEL] * 4), "little", signed=True)
    return {"guard_bytes_changed": int((raw[:g] != SENTINEL).sum()
                                       + (raw[-g:] != SENTINEL).sum()),
            "unwritten": int((out.reshape(-1).view(torch.int32)
                              == word).sum())}


def guard_checks(dev) -> dict:
    """Out-of-bounds writes, without a sanitizer: IMCRA (fresh with its
    state kept, then resumed from that state, at the trainer's [8, 145,
    257]; fresh without state at [4, 97, 257]), linrec and linrec_bwd (one
    pole a row, y0, PESQ's [8, PESQ_FRAMES]) launched on outputs fenced by
    GUARD_ELEMENTS sentinel elements on each side: no guard byte changed,
    every output element written, the inputs unchanged bit for bit, and
    the outputs equal to the wrappers' bit for bit."""
    cfg = ImcraConfig()
    stream = torch.cuda.current_stream(dev).cuda_stream
    coef = imcra._kernel_coefficients(cfg).ctypes.data
    rows = len(imcra._FIELDS) + 2 * imcra.KERNEL_U
    res = {}

    out = object()              # marks the fenced outputs' pointers

    def check(name, kernel, inputs, outs, args, wrapper):
        """Launch `kernel` with `args` (`out` stands for each fenced output
        in turn) and read the fences; `wrapper` gives the same outputs."""
        before = [x.clone() for x in inputs]
        ptrs = iter(o.data_ptr() for o, _ in outs)
        kernels.launch(kernel, *(next(ptrs) if a is out else a
                                 for a in args), stream)
        torch.cuda.synchronize()
        rec = {"inputs_changed": sum(
            int(not torch.equal(a.view(torch.uint8), b.view(torch.uint8)))
            for a, b in zip(before, inputs)),
            "guard_bytes_changed": 0, "unwritten": 0}
        for o, buf in outs:
            for key, v in fence_errors(o, buf).items():
                rec[key] += v
        rec["equal_to_wrapper"] = all(
            torch.equal(o.view(torch.uint8), w.contiguous().view(torch.uint8))
            for (o, _), w in zip(outs, wrapper()))
        res[name] = rec
        return [o for o, _ in outs]

    def imcra_fenced(name, y2, st_in=None, ju_in=None, l0=0, keep=True):
        b, t, k = y2.shape
        outs = [guarded((b, t, k), torch.float32, dev)]
        if keep:
            outs += [guarded((b, rows, k), torch.float32, dev),
                     guarded((b, 2), torch.int32, dev)]
        ins = [y2] if st_in is None else [y2, st_in, ju_in]
        kept = out if keep else None
        return check(name, "imcra_scan", ins, outs, (
            y2.data_ptr(), out, st_in if st_in is None else st_in.data_ptr(),
            kept, ju_in if ju_in is None else ju_in.data_ptr(), kept, b, t,
            k, l0, coef, cfg.is_frames, cfg.v_frames), lambda: [
            x for x in imcra.imcra_scan_packed(y2, st_in, ju_in, l0, cfg,
                                               keep) if x is not None])

    y2 = noise_power(dev, BUCKET, 6)
    _, st, ju = imcra_fenced("imcra_fresh_state", y2[:, :60].contiguous())
    imcra_fenced("imcra_resumed", y2[:, 60:].contiguous(), st.clone(),
                 ju.clone(), l0=60)
    imcra_fenced("imcra_stateless_b4",
                 noise_power(dev, 24576, 7)[:4].contiguous(), keep=False)

    gen = torch.Generator().manual_seed(8)
    a = torch.full((8,), 0.2, device=dev)
    b = torch.rand(8, PESQ_FRAMES, generator=gen).to(dev)
    g = torch.randn(8, PESQ_FRAMES, generator=gen).to(dev)
    y0 = torch.ones(8, device=dev)
    (y,) = check("linrec", "linrec", [a, b, y0],
                 [guarded((8, PESQ_FRAMES), torch.float32, dev)],
                 (a.data_ptr(), b.data_ptr(), y0.data_ptr(), out, 8,
                  PESQ_FRAMES, 0, 0), lambda: [iir.linrec(a, b, y0)])
    y = y.clone()
    check("linrec_bwd", "linrec_bwd", [a, g, y0, y],
          [guarded((8, PESQ_FRAMES), torch.float32, dev),
           guarded((8,), torch.float32, dev),
           guarded((8,), torch.float32, dev)],
          (a.data_ptr(), g.data_ptr(), y0.data_ptr(), y.data_ptr(), out,
           out, out, 8, PESQ_FRAMES, 0, 0),
          lambda: list(iir.linrec_backward(a, g, y, y0)))
    return res


def pesq_rows(seed: int, rows: int = 8):
    """[rows, BUCKET] float32 reference and degraded rows cut from the
    golden speech and noise at seeded offsets and scales, zero past each
    row's n_valid (from 30001 to BUCKET samples, the first row full)."""
    clean, noise = speech_signals()
    rng = np.random.RandomState(seed)
    nv = rng.randint(30001, BUCKET + 1, rows)
    nv[0] = BUCKET
    ref = np.zeros((rows, BUCKET), np.float32)
    deg = np.zeros((rows, BUCKET), np.float32)
    for j, m in enumerate(nv):
        off, sc = int(rng.randint(0, clean.size)), float(rng.uniform(0.5, 1.5))
        ref[j, :m] = crop(clean, m, off, sc)
        deg[j, :m] = (rng.uniform(0.6, 1.2) * ref[j, :m]
                      + crop(noise, m, off + 99, 0.3 * sc))
    return ref, deg, nv


def gradient_phase(dev) -> dict:
    """The gradient path: a loss through the scan form of HASPI's middle ear
    over eight 36864-sample utterances at 24 kHz ([8, 55296]: a one-pole,
    then the biquad's complex pole pair; synthetic, as HASPI folds it into
    its spectrum) and through PESQ (`pesq_p862_16k`) of eight rows of the
    36864-sample bucket with their n_valid, whose gain memory is one linrec
    of [8, 143], then backward.  Launch counts are zeroed just before and
    read just after: 4 forward and 4 backward launches.  The middle ear's
    gradient against its spectral adjoint (the response's conjugate on the
    DFT grid, MIDDLE_EAR_BAR); PESQ's scores and its gradient with respect
    to the degraded rows against the port's CPU float64 (SCORE_BARS,
    PESQ_GRAD_BAR, in norm)."""
    rng = np.random.RandomState(28)
    x, w = (torch.as_tensor(rng.randn(8, LINREC_N), dtype=torch.float32,
                            device=dev) for _ in range(2))
    ref_np, deg_np, nv_np = pesq_rows(29)
    w2_np = rng.uniform(0.5, 1.5, 8)
    ref = torch.as_tensor(ref_np, device=dev)
    deg = torch.as_tensor(deg_np, device=dev)
    nv = torch.as_tensor(nv_np, device=dev)
    w2 = torch.as_tensor(w2_np, dtype=torch.float32, device=dev)
    x.requires_grad_()
    deg.requires_grad_()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    scores = metrics.pesq_p862_16k(ref, deg, nv)
    loss = (w * middle_ear(x)).sum() + (w2 * scores).sum()
    loss.backward()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launches)

    m = iir._fft_len_ir(LINREC_N, 4096)
    adjoint = torch.fft.ifft(torch.fft.fft(w.to(torch.complex64), m)
                             * middle_ear_response(m, torch.complex64, dev)
                             .conj())[:, :LINREC_N].real
    me_rel = float((x.grad - adjoint).abs().max() / adjoint.abs().max())
    deg64 = torch.from_numpy(deg_np.astype(np.float64)).requires_grad_()
    scores64 = metrics.pesq_p862_16k(torch.from_numpy(
        ref_np.astype(np.float64)), deg64, torch.from_numpy(nv_np))
    (torch.from_numpy(w2_np) * scores64).sum().backward()
    g32 = deg.grad.double().cpu()
    grad_rel = float((g32 - deg64.grad).norm() / deg64.grad.norm())
    score_err = max(rel_errors({"pesq": float(a)}, {"pesq": float(b)})["pesq"]
                    for a, b in zip(scores.detach().cpu(), scores64.detach()))
    res = {"middle_ear_shape": [8, LINREC_N], "pesq_shape": [8, BUCKET],
           "n_valid": nv_np.tolist(), "gain_memory_shape": [8, PESQ_FRAMES],
           "launches": launches, "loss": float(loss.detach()),
           "pesq": scores.detach().cpu().tolist(),
           "finite": bool(torch.isfinite(x.grad).all()
                          and torch.isfinite(deg.grad).all()),
           "middle_ear_grad_rel_vs_spectral_adjoint": me_rel,
           "pesq_rel_vs_cpu_f64": score_err,
           "pesq_grad_rel_vs_cpu_f64": grad_rel,
           "padded_grad_zero": bool(all(
               not deg.grad[j, int(nv_np[j]):].any() for j in range(8))),
           "wall_ms": wall_ms}
    print(f"gradient path: {res}")
    if (launches["linrec"] != 4 or launches["linrec_bwd"] != 4
            or not res["finite"] or me_rel >= MIDDLE_EAR_BAR
            or score_err >= SCORE_BARS["pesq"]
            or grad_rel >= PESQ_GRAD_BAR or not res["padded_grad_zero"]):
        raise AssertionError(f"gradient path: {res}")
    return res


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


def step_times(cfg, state, feats, eband, targets, row_valid) -> dict:
    """G-step and D-step times at batch 8 (CUDA events, median of 5 bursts
    of 10 steps), each step's host-clock time (median of 10) and, from
    torch.profiler, its device time, busy share and top device operations,
    deterministic convolutions off, as a training run uses them."""
    cudnn = torch.backends.cudnn
    deterministic, cudnn.deterministic = cudnn.deterministic, False
    timed = copy.deepcopy(state)
    tg, tq = targets
    steps = {
        "g": lambda: gan.g_step(timed, feats, cfg, INTEL_COLS, None,
                                row_valid),
        "d": lambda: gan.d_step_bands(
            timed, eband, feats.noise_band, feats.clean_band, feats.frames,
            tg, tq, cfg, intel_cols=INTEL_COLS, row_valid=row_valid)}
    res = {}
    try:
        for name, step in steps.items():
            ms = cuda_ms(step, calls=10)
            wall = []
            for _ in range(10):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
            wall_ms = float(np.median(wall)) * 1e3
            prof = profile_step(step, wall_ms,
                                label=f"{name}_step_profile_"
                                      f"{cfg.model.compute_dtype}")
            res[name] = {"ms": ms, "wall_ms": wall_ms,
                         "utterances_per_s": 8 / ms * 1e3,
                         "device_ms": prof["device_ms_per_batch"],
                         "device_ops": prof["device_ops_per_batch"],
                         "busy_share": prof["busy_share"],
                         "top": prof["top"]}
    finally:
        cudnn.deterministic = deterministic
    return res


def time_training(cfg, state, feats, eband, targets, row_valid) -> dict:
    """G-step and D-step times at batch 8 (`step_times`) under the float32
    policy, the training phase's summary of them."""
    g, d = (step_times(cfg, state, feats, eband, targets, row_valid)[k]
            for k in ("g", "d"))
    res = {"g_step_ms": g["ms"], "d_step_ms": d["ms"],
           "g_step_wall_ms": g["wall_ms"],
           "g_utterances_per_s": g["utterances_per_s"],
           "d_utterances_per_s": d["utterances_per_s"],
           "g_device_ms": g["device_ms"], "g_device_ops": g["device_ops"],
           "g_busy_share": g["busy_share"], "d_busy_share": d["busy_share"]}
    print(f"training steps at batch 8, bucket {BUCKET} (T = 145), float32, "
          f"TF32 off: G step {g['ms']:.3f} ms, D step {d['ms']:.3f} ms (CUDA "
          f"events, median of 5 bursts of 10); "
          f"{g['utterances_per_s']:.1f} and {d['utterances_per_s']:.1f} "
          f"utterances/s; one G step {g['wall_ms']:.3f} ms host clock, "
          f"device busy {g['busy_share']:.3f} ({g['device_ms']:.3f} ms, "
          f"{g['device_ops']:.0f} device ops)")
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


def infer_phase(dev, tmp: str) -> dict:
    """cli.infer over a corpus written under `tmp`, from a port checkpoint
    of the seeded generator; every check raises.  Launch counts are zeroed
    before the CLI runs and read after it and one `mmse_lsa_enhance`
    call.  The corpus and checkpoint stay for the scoring phase."""
    cfg = Config()
    gen = seeded_generator(0).to(dev).eval()
    t0 = time.perf_counter()
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
           "checkpoint": ck, "launches": launches,
           "pcm16_diff_samples": n_diff,
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


# ---------------------------------------------------------------- scoring
def rel_errors(got: dict, want: dict) -> dict:
    """|got - want| / max(|want|, 1) per metric: relative for SIIB and
    HASPI, absolute for ESTOI, which lies in [-1, 1] and can be 0 (the
    reference package's normalisation, tests/test_metrics_bucketed.py)."""
    return {m: abs(got[m] - want[m]) / max(abs(want[m]), 1.0) for m in want}


def max_rel(rows_got, rows_want) -> dict:
    errs = [rel_errors(g, w) for g, w in zip(rows_got, rows_want)]
    return {m: max(e[m] for e in errs) for m in errs[0]}


def siib_f32_klt(clean: np.ndarray, noise: np.ndarray, enh: np.ndarray,
                 dev) -> float:
    """The control for SIIB: the same score with its KLT and capacity in
    float32 (the reference package's arithmetic without x64)."""
    n = min(len(clean), len(noise), len(enh))
    x, y, _ = siib_prepare(clean[:n], noise[:n] + enh[:n])
    xt = torch.as_tensor(x, device=dev)[None]
    yt = torch.as_tensor(y, device=dev)[None]
    vx, vy, scnt = _stack_pair(xt, yt, None)
    vx, vy, scnt = vx.float(), vy.float(), scnt.float()
    return float(_capacity(vx, vy, _klt(vx, scnt))[0])


def timed_corpus(triple, metric_names, vmap_chunk: int = 8, **kw) -> dict:
    """score_corpus of the corpus: host clock around the call, which ends in
    its one device-to-host copy, and CUDA events; the kernels' launches in
    the call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    start.record()
    scores = metrics.score_corpus(*triple, norm=False, metrics=metric_names,
                                  vmap_chunk=vmap_chunk, device="cuda", **kw)
    end.record()
    end.synchronize()
    host = time.perf_counter() - t0
    return {"host_s": host, "events_s": start.elapsed_time(end) / 1e3,
            "utterances_per_s": len(scores) / host, "scores": scores,
            "launches": {k: v - before[k] for k, v in kernels.launches.items()
                         if v != before[k]}}


def pool_checks(triple, keys, names) -> dict:
    """score_corpus of all five metrics through a CleanSidePool, in chunks
    of 4: cold; warm on the same chunks (every clean-side half and raw
    clean and noise row a hit), equal to cold bit for bit; warm on
    reshuffled chunks (other compositions, all hits), within CACHE_BAR of
    cold and of the uncached call on those chunks (a row's neighbours in
    its chunk set its buffers and so its round-off, pool or not); then
    with enhanced_keys on the PCM16 files (the enhanced rows kept on the
    card as int16), cold and warm equal to the upload path on the same
    chunks bit for bit; hits, misses and resident bytes after each; times
    by host clock and CUDA events."""
    pool = CleanSidePool()
    n = len(keys)
    runs, counts = {}, {}

    def run(label, order, cache=pool, **kw):
        tr = tuple([lst[i] for i in order] for lst in triple)
        if cache is not None:
            kw.update(clean_cache=cache, clean_keys=[keys[i] for i in order])
        r = timed_corpus(tr, SCORE_METRICS, vmap_chunk=4, **kw)
        r["scores"] = [r["scores"][order.index(i)] for i in range(n)]
        runs[label] = r
        if cache is not None:
            counts[label] = {"hits": pool.hits, "misses": pool.misses,
                             "rows": len(pool),
                             "resident_bytes": pool.resident_bytes}

    ident = list(range(n))
    shuffled = [int(i) for i in np.random.RandomState(5).permutation(n)]
    run("cold", ident)
    run("warm", ident)
    run("warm_reshuffled", shuffled)
    run("uncached_reshuffled", shuffled, cache=None)
    run("enhanced_keys_cold", ident, enhanced_keys=names)
    run("enhanced_keys_warm", ident, enhanced_keys=names)
    cold = runs["cold"]["scores"]
    shuffled_scores = runs["warm_reshuffled"]["scores"]
    res = {"counts": counts,
           "equal_to_cold": {k: runs[k]["scores"] == cold for k in (
               "warm", "enhanced_keys_cold", "enhanced_keys_warm")},
           "reshuffled_vs_cold": max_rel(shuffled_scores, cold),
           "reshuffled_vs_uncached": max_rel(
               shuffled_scores, runs["uncached_reshuffled"]["scores"]),
           "times": {k: {f: v for f, v in r.items() if f != "scores"}
                     for k, r in runs.items()}}
    chunks = counts["cold"]["misses"] // 5     # 5 pooled signatures a chunk
    want = {"cold": (0, 5), "warm": (5, 5), "warm_reshuffled": (10, 5),
            "enhanced_keys_cold": (15, 6), "enhanced_keys_warm": (21, 6)}
    want = {k: (h * chunks, m * chunks) for k, (h, m) in want.items()}
    got = {k: (c["hits"], c["misses"]) for k, c in counts.items()}
    print(f"CleanSidePool: {json.dumps(res)}")
    if not (all(res["equal_to_cold"].values()) and got == want
            and all(v < CACHE_BAR for k in ("reshuffled_vs_cold",
                                            "reshuffled_vs_uncached")
                    for v in res[k].values()) and chunks > 0):
        raise AssertionError(f"CleanSidePool: {res}, hits and misses {got}, "
                             f"expected {want}")
    return res


def burst_pair():
    """tests/test_pesq.py's burst train, and a copy whose middle section is
    delayed by JUMP samples (delay 0 -> JUMP -> 0), float64."""
    rng = np.random.default_rng(0)
    base = np.concatenate([g for _ in range(BURSTS) for g in (
        0.3 * rng.standard_normal(BURST_LEN),
        0.003 * rng.standard_normal(GAP_LEN))])
    p = BURST_LEN + GAP_LEN
    a, b = 3 * p, 7 * p
    return base, np.concatenate([base[:a], np.zeros(JUMP), base[a:b - JUMP],
                                 base[b:]])


def alignment_check(dev) -> dict:
    """PESQ with all three alignment stages (align_bad_intervals) on the
    two-jump burst train: card float32 against CPU float64 (SCORE_BARS's
    PESQ bar), and above the utterance stage alone, as the bad-interval
    stage repairs the second jump."""
    ref, deg = burst_pair()
    card = {}
    for key, kw in (("bad_intervals", {"align_bad_intervals": True}),
                    ("utterances", {"align_utterances": True})):
        card[key] = float(metrics.pesq_p862(
            torch.as_tensor(ref, dtype=torch.float32, device=dev),
            torch.as_tensor(deg, dtype=torch.float32, device=dev), **kw))
    cpu = float(metrics.pesq_p862(torch.from_numpy(ref), torch.from_numpy(deg),
                                  align_bad_intervals=True))
    res = {"samples": int(ref.size), "card_f32": card, "cpu_f64": cpu,
           "rel": rel_errors({"pesq": card["bad_intervals"]},
                             {"pesq": cpu})["pesq"]}
    print(f"PESQ, all alignment stages, on the card: {res}")
    if not (res["rel"] < SCORE_BARS["pesq"]
            and card["bad_intervals"] > card["utterances"] + 0.3):
        raise AssertionError(f"PESQ alignment on the card: {res}")
    return res


def scoring_phase(dev, tmp: str, inferred: dict) -> dict:
    """The five metrics of the infer phase's 24 utterances on the card
    through `cli/infer --metrics` (the path; launch counts zeroed before
    and read after: one linrec launch for each PESQ call, one a
    `score_batch` row) and `score_corpus`, plain, with a chunk-keyed clean
    cache and with a CleanSidePool; PESQ's alignment stages; every check
    raises."""
    t0 = time.perf_counter()
    corpus = f"{tmp}/corpus"
    args = ["--test-clean", f"{corpus}/Clean", "--test-noise",
            f"{corpus}/Noise", "--checkpoint", inferred["checkpoint"],
            "--metrics", ",".join(SCORE_METRICS), "--subsets", "Cafeteria",
            "--output", f"{tmp}/scored", "--device", "cuda"]
    kernels.reset_launches()
    cli = infer.main(args)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    sub = cli["scores"]["Cafeteria"]
    names, batch = sub["names"], sub["scores"]
    n = len(names)
    if not (n == inferred["utterances"]
            and launches["imcra_scan"] == cli["batches"]
            and launches["linrec"] == n and launches["linrec_bwd"] == 0
            and all(set(r) == set(SCORE_METRICS) for r in batch)
            and all(np.isfinite(v) for r in batch for v in r.values())):
        raise AssertionError(f"scoring CLI: {n} scored, {launches} launches "
                             f"for {cli['batches']} batches and {n} PESQ "
                             f"calls")
    print(f"cli/infer --metrics: {n} utterances scored in {sub['seconds']:.3f}"
          f" s on the card (first scoring of the run); means {sub['means']}; "
          f"launches {launches}")

    def read(sub_dir, name):
        return read_wav(f"{sub_dir}/{name}")[0]

    bases = [nm.replace("@1", "") for nm in names]
    cleans = [read(f"{corpus}/Clean", b) for b in bases]
    noises = [read(f"{corpus}/Noise", b) for b in bases]
    enhs = [read(f"{tmp}/scored", nm) for nm in names]
    triple = (cleans, noises, enhs)

    # times: each metric alone, then all five, cold (first call at the
    # bucketed shapes) and warm; PESQ launches linrec once a chunk
    times = {}
    for key, mm in [(m, (m,)) for m in SCORE_METRICS] + [("all",
                                                          SCORE_METRICS)]:
        cold, warm = timed_corpus(triple, mm), timed_corpus(triple, mm)
        times[key] = {k: {f: v for f, v in r.items() if f != "scores"}
                      for k, r in (("cold", cold), ("warm", warm))}
    corpus_scores = warm["scores"]
    lens = np.array([min(len(c), len(z), len(e)) for c, z, e in
                     zip(*triple)])
    per_bucket = np.unique(-(-lens // 16384), return_counts=True)[1]
    n_chunks = int(sum(-(-per_bucket // 8)))
    if times["pesq"]["warm"]["launches"].get("linrec") != n_chunks:
        raise AssertionError(f"score_corpus PESQ: {times['pesq']['warm']} "
                             f"for {n_chunks} chunks")
    t1 = time.perf_counter()
    warm_batch = metrics.score_batch(*triple, norm=False, device="cuda")
    times["score_batch_warm"] = {"host_s": time.perf_counter() - t1}
    times["score_batch_warm"]["utterances_per_s"] = (
        n / times["score_batch_warm"]["host_s"])
    if warm_batch != batch:
        raise AssertionError("score_batch differs from the CLI's scores")

    # 1. score_corpus (padded rows, n_valid) against score_batch (trimmed)
    corpus_err = {m: 0.0 for m in SCORE_METRICS}
    for c, b in zip(corpus_scores, batch):
        for m in CORPUS_BARS:
            err = abs(c[m] - b[m]) / max(abs(b[m]), 1.0)
            corpus_err[m] = max(corpus_err[m], err)
        corpus_err["siib"] = max(corpus_err["siib"], abs(c["siib"] - b["siib"])
                                 / max(b["siib"], 10.0))
    print(f"score_corpus against score_batch, largest error: {corpus_err}")
    if not (all(corpus_err[m] < CORPUS_BARS[m] for m in CORPUS_BARS)
            and corpus_err["siib"] < 0.05):
        raise AssertionError(f"score_corpus vs score_batch: {corpus_err}")

    # 2. a clean-cache hit against its cold fill and the pair path
    cache = {}
    cold = metrics.score_corpus(*triple, norm=False, vmap_chunk=8,
                                device="cuda", clean_cache=cache,
                                clean_keys=bases)
    t1 = time.perf_counter()
    hit = metrics.score_corpus(*triple, norm=False, vmap_chunk=8,
                               device="cuda", clean_cache=cache,
                               clean_keys=bases)
    hit_s = time.perf_counter() - t1
    cache_err = max_rel(hit, corpus_scores)
    if hit != cold or not all(v < CACHE_BAR for v in cache_err.values()):
        raise AssertionError(f"clean cache: hit == cold {hit == cold}, "
                             f"against the pair path {cache_err}")
    print(f"clean-cache hit: equal to its cold fill; against the pair path "
          f"{cache_err}; {len(cache)} entries; warm {hit_s:.3f} s")
    pooled = pool_checks(triple, bases, names)
    if (pooled["times"]["cold"]["launches"].get("linrec")
            != int(sum(-(-per_bucket // 4)))):
        raise AssertionError(f"pool: {pooled['times']['cold']['launches']}")

    # 3. the card's float32 against the CPU's float64, one per bucket
    pick = [names.index(nm) for nm in names if nm.startswith(("u00", "u08",
                                                              "u16"))]
    f64 = [tuple(lst[i].astype(np.float64) for lst in triple) for i in pick]
    t1 = time.perf_counter()
    cpu = metrics.score_batch(*zip(*f64), norm=False, device="cpu")
    cpu_s = time.perf_counter() - t1
    card = [batch[i] for i in pick]
    card_err = max_rel(card, cpu)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = metrics.score_batch(*zip(*[tuple(lst[i] for lst in triple)
                                          for i in pick]),
                                   norm=False, device="cuda")
    finally:
        disable_tf32()
    control = max_rel(tf32, cpu)
    klt32 = [{"siib": siib_f32_klt(*(lst[i] for lst in triple), dev)}
             for i in pick]
    control["siib"] = max_rel(klt32, [{"siib": r["siib"]}
                                      for r in cpu])["siib"]
    control["tf32_siib"] = max_rel(tf32, cpu)["siib"]
    haspi_ref_bar = card_err["haspi"] < HASPI_F32_BAR
    per_utt = [{"name": names[i], "cpu_f64": w, "card": g, "tf32": t,
                "siib_f32_klt": k["siib"]}
               for i, w, g, t, k in zip(pick, cpu, card, tf32, klt32)]
    print(f"scores of {json.dumps(per_utt)}")
    print(f"card float32 against CPU float64 ({[names[i] for i in pick]}): "
          f"{card_err}, bars {SCORE_BARS}; controls (TF32 on; "
          f"SIIB: KLT in float32) {control}; CPU float64 took {cpu_s:.1f} s")
    if not all(card_err[m] < SCORE_BARS[m] for m in SCORE_BARS):
        raise AssertionError(f"card scores beyond the bars: {card_err}")
    if not all(control[m] >= SCORE_BARS[m] for m in SCORE_BARS):
        raise AssertionError(f"a control passes the bars: {control}")

    aligned = alignment_check(dev)

    # 4. the ear model on the card against the golden
    g = np.load(REPO / "tests" / "goldens" / "ear_model.npz")
    out = ear_model(torch.as_tensor(g["x24"].astype(np.float32), device=dev),
                    torch.as_tensor(g["y24"].astype(np.float32), device=dev))
    ear_err = {k: float(np.abs(v.cpu().numpy() - g[k]).max()
                        / np.abs(g[k]).max())
               for v, k in ((out.xdb, "xdB"), (out.ydb, "ydB"),
                            (out.xbm, "xBM"), (out.ybm, "yBM"))}
    print(f"ear model on the card (float32) against ear_model.npz: {ear_err}")
    if not all(v < EAR_GOLDEN_BAR for v in ear_err.values()):
        raise AssertionError(f"ear model golden on the card: {ear_err}")

    # 5. one profile of a warm score_corpus; SIIB's eigh share
    warm_all_ms = times["all"]["warm"]["host_s"] * 1e3
    prof = profile_step(lambda: metrics.score_corpus(
        *triple, norm=False, vmap_chunk=8, device="cuda"), warm_all_ms,
        reps=1, label="scoring_profile")
    eigh_ms = 0.0
    lens = np.array([min(len(c), len(z), len(e)) for c, z, e in
                     zip(*triple)])
    for blen in sorted({int(-(-m // 16384) * 16384) for m in lens}):
        rows = [i for i, m in enumerate(lens)
                if -(-m // 16384) * 16384 == blen]
        sv = [metrics.siib_tiled_length(cleans[i][:lens[i]]) for i in rows]
        sb = -(-max(sv) // 16384) * 16384
        ref = torch.zeros(len(rows), blen, device=dev)
        for j, i in enumerate(rows):
            ref[j, :lens[i]] = torch.as_tensor(cleans[i][:lens[i]])
        nv = torch.as_tensor(lens[rows], device=dev)
        tiled = metrics._tile(ref, nv, torch.as_tensor(sv, device=dev), sb)
        vx, _, scnt = _stack_pair(tiled, None,
                                  torch.as_tensor(sv, device=dev))
        cov = (vx.transpose(-1, -2) @ vx) / scnt[:, None, None]
        eigh_ms += cuda_ms(lambda: torch.linalg.eigh(cov), calls=2,
                           samples=3, warmup=1)
    siib_ms = times["siib"]["warm"]["events_s"] * 1e3
    res = {"utterances": n, "launches": launches, "cli_means": sub["means"],
           "cli_first_scoring_s": sub["seconds"],
           "cli_first_utterances_per_s": n / sub["seconds"],
           "times": times, "corpus_vs_batch": corpus_err,
           "cache_vs_pair": cache_err, "cache_hit_s": hit_s,
           "pool": pooled, "alignment": aligned,
           "card_vs_cpu_f64": card_err, "bars": SCORE_BARS,
           "scores_checked": per_utt,
           "control": control, "haspi_within_reference_bar": haspi_ref_bar,
           "cpu_f64_s": cpu_s, "ear_golden": ear_err,
           "busy_share": prof["busy_share"],
           "device_ms": prof["device_ms_per_batch"],
           "device_ops": prof["device_ops_per_batch"], "top": prof["top"],
           "siib_eigh_ms": eigh_ms, "siib_warm_ms": siib_ms,
           "siib_eigh_share": eigh_ms / siib_ms,
           "phase_s": time.perf_counter() - t0}
    print(f"scoring: warm {times['all']['warm']['utterances_per_s']:.1f} "
          f"utterances/s (all five, score_corpus), cold "
          f"{times['all']['cold']['utterances_per_s']:.1f}; busy "
          f"{res['busy_share']:.3f}; SIIB eigh {eigh_ms:.2f} of {siib_ms:.2f}"
          f" ms; phase {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------- trainer
class Tally:
    """Calls of the functions that launch the trainer's kernels, counted at
    the call sites the loop goes through (`featurize_batch`: one IMCRA
    launch each; `score_corpus`'s PESQ: one linrec launch a chunk, and the
    rows it scores, "pesq_rows"), and
    the scoring pool's lookups by signature, caller (score_corpus or the
    loop), whether the keys are files the loop wrote, hit or miss."""

    def __init__(self):
        self.calls = collections.Counter()
        self._undo = []
        self._scoring = False
        for module, name, key in ((pipeline, "featurize_batch", "featurize"),
                                  (gan, "featurize_batch", "featurize"),
                                  (metrics, "pesq_proxy_16k", "pesq"),
                                  (metrics, "score_corpus", "score_corpus")):
            self._wrap(module, name, key)

    def _wrap(self, module, name, key):
        fn = getattr(module, name)

        def counted(*args, **kw):
            self.calls[key] += 1
            if key == "pesq":
                self.calls["pesq_rows"] += args[0].shape[0]
            scoring, self._scoring = self._scoring, (
                self._scoring or key == "score_corpus")
            try:
                return fn(*args, **kw)
            finally:
                self._scoring = scoring

        setattr(module, name, counted)
        self._undo.append((module, name, fn))

    def watch_pool(self, pool: CleanSidePool) -> None:
        ensure = pool.ensure

        def counted(sig, keys, compute, mesh=None):
            hits = pool.hits
            out = ensure(sig, keys, compute, mesh)
            written = isinstance(keys[0][0], str) and "@" in keys[0][0]
            self.calls[(sig[0], "scoring" if self._scoring else "loop",
                        "written" if written else "corpus",
                        "hit" if pool.hits > hits else "miss")] += 1
            return out

        pool.ensure = counted

    def restore(self) -> None:
        for module, name, fn in reversed(self._undo):
            setattr(module, name, fn)


def cross_run_bars(control: dict) -> dict:
    """Each metric's bar for a gap between two runs' scores of their own
    files, given the control's gap (ROUNDOFF_MULTIPLE)."""
    return {m: max(SCORE_BARS[m], ROUNDOFF_MULTIPLE * v)
            for m, v in control.items()}


def score_gap(got: dict, want: dict, names) -> dict:
    """Each metric's largest gap of `got`'s score from `want`'s, relative
    (to 1 below 1), over the files of `want` that `got` scored."""
    return {m: max(abs(got[k][m] - v[m]) / max(abs(v[m]), 1.0)
                   for k, v in want.items() if k in got)
            for m in names}


def one_ulp_up(trainer: Trainer) -> None:
    """Every parameter of `trainer`'s G, D and D_Qua one float32 ulp up
    (the round-off control), its generator guard rebased on it."""
    with torch.no_grad():
        for p in itertools.chain(trainer.state.gen.parameters(),
                                 trainer.state.d.parameters(),
                                 trainer.state.dq.parameters()):
            p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    trainer.gen_guard.rebase("one float32 ulp up (the control)",
                             trainer.state.gen)


def cpu_f64_scores(index, enhanced_paths, norm: bool, names,
                   fs: int) -> list:
    """The files' scores on the CPU in float64, as `Trainer._score_files`
    pairs them (each enhanced file with its clean and noise files)."""
    def read64(path):
        return read_wav(path)[0].astype(np.float64)
    cleans, noises, enhs = [], [], []
    for p in enhanced_paths:
        base = os.path.basename(p)
        name = base.split("@")[0] + ".wav" if "@" in base else base
        cleans.append(read64(index.clean_path_for(name)))
        noises.append(read64(os.path.join(index.noise_dir, name)))
        enhs.append(read64(p))
    return metrics.score_corpus(cleans, noises, enhs, fs, norm=norm,
                                metrics=names, device="cpu")


class SmokeTrainer(Trainer):
    """The loop as a user runs it, with what the trainer phase reads off
    it: per epoch the kernels' launches (counted from 0 just before the
    epoch and read just after), the featurized batches and PESQ chunks
    (`Tally`), phase seconds, steps and pool telemetry; every D pass's
    losses; and when `traced` the device-busy share of g_train and d_train
    (torch.profiler of the device's activity alone, the one instrument of
    the single run and of every rank)."""

    tally: Tally = None

    def __init__(self, *args, targets=None, **kw):
        super().__init__(*args, **kw)
        self.traced = False
        self.epochs = []
        self.d_losses = []
        self.busy = {}
        # every score this run computed, by (file without the run's
        # directory, calibrated); with `targets`, another run's such map,
        # the loop takes those scores in place of its own (both still
        # computed)
        self.scored = {}
        self.targets = targets
        # a dict: the CPU's float64 scores of the files this run scores
        self.rescored = None
        if self.tally is not None:
            self.tally.watch_pool(self._clean_side_cache)

    def _score_files(self, index, enhanced_paths, norm, metrics):
        out = super()._score_files(index, enhanced_paths, norm, metrics)
        root = run_roots(self)[0]
        keys = [(p.replace(root, "/"), norm) for p in enhanced_paths]
        self.scored.update(zip(keys, out))
        if self.rescored is not None:
            # the rescoring runs no kernel: its calls are not the loop's
            calls = self.tally and collections.Counter(self.tally.calls)
            self.rescored.update(zip(keys, cpu_f64_scores(
                index, enhanced_paths, norm, metrics, self.cfg.train.fs)))
            if calls is not None:
                self.tally.calls.clear()
                self.tally.calls.update(calls)
        if self.targets is not None:
            out = [dict(self.targets[k]) for k in keys]
        return out

    def _traced(self, name, fn, *args):
        if not self.traced:
            return fn(*args)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA
                                 if self.dev.type == "cuda"
                                 else ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            out = fn(*args)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_s = sum(_device_us(e) for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA")) / 1e6
        acc = self.busy.setdefault(name, {"device_s": 0.0, "wall_s": 0.0})
        acc["device_s"] += dev_s
        acc["wall_s"] += wall
        acc["busy_share"] = acc["device_s"] / acc["wall_s"]
        return out

    def train_generator_epoch(self, sampled):
        return self._traced("g_train", super().train_generator_epoch,
                            sampled)

    def train_discriminator_pass(self, entries):
        out = self._traced("d_train", super().train_discriminator_pass,
                           entries)
        self.d_losses += out
        return out

    def run_epoch(self, epoch):
        tally = self.tally.calls if self.tally is not None else None
        before = dict(tally) if tally is not None else {}
        phases = dict(self.timer._total)
        steps = (self.state.step_g, self.state.step_d)
        self.d_losses = []
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launches()
        means = super().run_epoch(epoch)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        rec = {"epoch": epoch, "launches": dict(kernels.launches),
               "epoch_seconds": means["epoch_seconds"],
               "phases_s": {k: v - phases.get(k, 0.0)
                            for k, v in self.timer._total.items()
                            if v != phases.get(k, 0.0)},
               "g_steps": self.state.step_g - steps[0],
               "d_steps": self.state.step_d - steps[1],
               "g_loss": means["g_loss"],
               "d_loss": [float(np.mean([x[k] for x in self.d_losses]))
                          for k in (0, 1)],
               "d_step_losses": self.d_losses,
               "telemetry": self.telemetry[-1],
               "traced": self.traced,
               "utterances_per_s": (self.cfg.train.num_sampling
                                    / means["epoch_seconds"])}
        if tally is not None:
            rec["calls"] = {"_".join(k) if isinstance(k, tuple) else k:
                            v - before.get(k, 0) for k, v in tally.items()
                            if v != before.get(k, 0)}
        self.epochs.append(rec)
        return means


# ------------------------------------------------- the generator invariant
# In epoch 1 the generator takes no step (Trainer.run_epoch trains G from
# epoch 2), so a run must end epoch 1 with the generator it drew.  The
# guard digests every generator tensor's bytes on the host (a) when
# gan.init_train_state returns inside Trainer.__init__ (before any
# replicate), (b) after Trainer.__init__, (c) after each StepTimer phase of
# epoch 1 and (d) at the end of epoch 1, and names the first point where a
# tensor's bytes changed.  Hooked in from here, as HUNT_CLI's kept_init
# is: the package has no switch for it.
class GeneratorGuard:
    """The points of one Trainer's generator: a digest of all its bytes at
    each, and the first change against point (a), by tensor: how many
    elements changed, their flat index ranges (a few contiguous runs point
    to a write; every element to another draw) and their first old and
    new values."""

    def __init__(self, label: str):
        self.label = label
        self.first = None           # point (a): name -> host bytes
        self.points = []            # (point, digest)
        self.violation = None

    def mark(self, point: str, gen: torch.nn.Module) -> None:
        host = {k: v.detach().reshape(-1).to("cpu", copy=True)
                for k, v in gen.state_dict().items()}
        digest = hashlib.sha256()
        for k in sorted(host):
            digest.update(host[k].view(torch.uint8).numpy().tobytes())
        self.points.append((point, digest.hexdigest()[:16]))
        if self.first is None:
            self.first = host
            return
        if self.violation is not None:
            return
        for k, new in host.items():
            old = self.first[k]
            if new.dtype == old.dtype and torch.equal(
                    new.view(torch.uint8), old.view(torch.uint8)):
                continue
            self.violation = {"point": point, "tensor": k,
                              **changed_elements(old, new)}
            return

    def rebase(self, point: str, gen: torch.nn.Module) -> None:
        """Start again from `gen` at `point`: a change the caller made on
        purpose (a control) is not a violation."""
        self.first = None
        self.mark(point, gen)

    @property
    def ok(self) -> bool:
        return self.violation is None and len(self.points) > 1

    def record(self) -> dict:
        return {"label": self.label, "ok": self.ok,
                "points": [p for p, _ in self.points],
                "digests": sorted({d for _, d in self.points}),
                "violation": self.violation}


def changed_elements(old: torch.Tensor, new: torch.Tensor) -> dict:
    """Of two flat host tensors, the elements whose bytes differ: count,
    contiguous index ranges (first 8, and how many), first old and new
    values."""
    if old.shape != new.shape or old.dtype != new.dtype:
        return {"elements": old.numel(), "changed": old.numel(),
                "ranges": [], "n_ranges": 0, "old": [], "new": [],
                "shape_or_dtype": [str(old.dtype), str(new.dtype),
                                   old.numel(), new.numel()]}
    size = old.element_size()
    a = old.view(torch.uint8).reshape(-1, size).numpy()
    b = new.view(torch.uint8).reshape(-1, size).numpy()
    idx = np.flatnonzero((a != b).any(axis=1))
    cuts = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate([idx[:1], idx[cuts + 1]])
    ends = np.concatenate([idx[cuts], idx[-1:]])
    return {"elements": old.numel(), "changed": int(idx.size),
            "ranges": [[int(s), int(e)] for s, e in zip(starts[:8],
                                                         ends[:8])],
            "n_ranges": int(starts.size),
            "old": old[idx[:4]].double().tolist(),
            "new": new[idx[:4]].double().tolist()}


# every guard of this process's Trainers, in order of creation
GUARDS: list = []


def install_generator_guard(record_file: str = None):
    """Hooks the guard into every Trainer made from now on (its
    `gen_guard`, appended to GUARDS) -> undo.  With `record_file`, the
    guards' records are written there as JSON at the process's exit (a
    CLI run in a subprocess)."""
    guards, building = GUARDS, []
    init_state, init, run_epoch = (gan.init_train_state, Trainer.__init__,
                                   Trainer.run_epoch)

    def init_train_state(*args, **kw):
        state = init_state(*args, **kw)
        if building:
            building[-1].mark("init_train_state", state.gen)
        return state

    def guarded_init(self, *args, **kw):
        guard = GeneratorGuard(f"{type(self).__name__} #{len(guards)}")
        building.append(guard)
        try:
            init(self, *args, **kw)
        finally:
            building.pop()
        guard.mark("Trainer.__init__", self.state.gen)
        self.gen_guard = guard
        guards.append(guard)

    def guarded_run_epoch(self, epoch):
        guard = getattr(self, "gen_guard", None)
        if epoch != 1 or guard is None:
            return run_epoch(self, epoch)
        phase = self.timer.phase

        @contextlib.contextmanager
        def marked(name):
            with phase(name):
                yield
            guard.mark(f"epoch 1 {name}", self.state.gen)
        self.timer.phase = marked
        try:
            means = run_epoch(self, epoch)
        finally:
            del self.timer.phase
        guard.mark("end of epoch 1", self.state.gen)
        return means

    gan.init_train_state = init_train_state
    Trainer.__init__ = guarded_init
    Trainer.run_epoch = guarded_run_epoch

    def undo():
        gan.init_train_state = init_state
        Trainer.__init__ = init
        Trainer.run_epoch = run_epoch

    if record_file:
        def write():
            with open(record_file, "w") as f:
                json.dump([g.record() for g in guards], f)
        atexit.register(write)
    return undo


def guard_records(guards: list, gate: str = None) -> list:
    """The guards' records (a resumed Trainer starts past epoch 1: its
    points are (a) and (b) only); with `gate`, raises naming the first
    violation, or when none of them ran epoch 1."""
    recs = [g.record() if isinstance(g, GeneratorGuard) else g
            for g in guards]
    bad = [r for r in recs if r["violation"] is not None]
    if gate and bad:
        raise AssertionError(f"{gate}: the generator changed before its "
                             f"first step: {bad[0]}")
    if gate and not any("end of epoch 1" in r["points"] for r in recs):
        raise AssertionError(f"{gate}: no guarded Trainer ran epoch 1: "
                             f"{recs}")
    return recs


def guard_summary(recs: list) -> dict:
    """Trainers guarded, those that ran epoch 1, violations (the first
    named)."""
    epoch1 = [r for r in recs if "end of epoch 1" in r["points"]]
    bad = [r for r in recs if r["violation"] is not None]
    return {"trainers": len(recs), "ran_epoch_1": len(epoch1),
            "points_per_epoch_1": max((len(r["points"]) for r in epoch1),
                                      default=0),
            "violations": len(bad),
            "first_violation": bad[0] if bad else None}


# a CLI run under the guard: argv as cli/train's own; the records go to
# NELE_GUARD_FILE at exit
GUARDED_CLI = """
import os, runpy
from chip_smoke import install_generator_guard
install_generator_guard(os.environ["NELE_GUARD_FILE"])
runpy.run_module("nelegan_tpu_torch.cli.train", run_name="__main__")
"""


def guarded_env(run: str, env: dict = None) -> dict:
    """The environment of a guarded CLI run into `run`: the repository on
    PYTHONPATH (the script imports this file), the records' file."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (
        str(REPO), env.get("PYTHONPATH"))))
    env["NELE_GUARD_FILE"] = f"{run}/generator_guard.json"
    return env


def read_guard(run: str, attempt: int = None) -> list:
    """The guard records a guarded CLI run into `run` wrote (one torchrun
    attempt's with `attempt`)."""
    suffix = "" if attempt is None else f".{attempt}"
    with open(f"{run}/generator_guard.json{suffix}") as f:
        return json.load(f)


def write_trainer_corpus(root: str, n_train: int, n_test: int,
                         seed: int) -> None:
    """Train/{Clean,Noise,MultiEnh} and Test/{Clean,Noise} under root as
    PCM16 wavs, spread over INFER_BUCKETS' three length buckets, cut from
    the golden speech and noise at seeded offsets and scales; MultiEnh, the
    pre-enhanced corpus, is each clean cut at half gain (any PCM16 stand-in
    serves, as tools/make_synth_corpus.py documents)."""
    clean, noise = speech_signals()
    rng = np.random.RandomState(seed)
    for sub in ("Train/Clean", "Train/Noise", "Train/MultiEnh", "Test/Clean",
                "Test/Noise"):
        Path(root, sub).mkdir(parents=True)
    for split, count in (("Train", n_train), ("Test", n_test)):
        for k in range(count):
            lo, hi = INFER_BUCKETS[k % len(INFER_BUCKETS)]
            n = int(rng.randint(lo, hi + 1))
            off, s = int(rng.randint(0, clean.size)), float(rng.uniform(0.5,
                                                                        1.5))
            name = f"{split[:2].lower()}{k:02d}#Cafeteria#{k}.wav"
            c = crop(clean, n, off, s)
            write_wav_pcm16(f"{root}/{split}/Clean/{name}", c)
            write_wav_pcm16(f"{root}/{split}/Noise/{name}",
                            crop(noise, n, off + 99, s))
            if split == "Train":
                write_wav_pcm16(f"{root}/Train/MultiEnh/{name}", 0.5 * c)


def trainer_paths(corpus: str, run: str) -> TrainPaths:
    return TrainPaths(train_clean=f"{corpus}/Train/Clean",
                      train_noise=f"{corpus}/Train/Noise",
                      test_clean=f"{corpus}/Test/Clean",
                      test_noise=f"{corpus}/Test/Noise",
                      train_enhanced=f"{corpus}/Train/MultiEnh",
                      output=f"{run}/output", checkpoints=f"{run}/chkpt",
                      log_file=f"{run}/log.txt")


def run_roots(*trainers: Trainer) -> list:
    return [str(Path(t.paths.output).parent) + "/" for t in trainers]


def replay_rows(entries, roots) -> list:
    """(path, name, scores) of replay entries, each run directory of
    `roots` cut from the paths (a resumed run replays its predecessor's
    files)."""
    def rel(p):
        for r in roots:
            p = p.replace(r, "/")
        return p
    return [(rel(e.enhanced_path), e.name, e.scores) for e in entries]


def read_log(t: Trainer) -> str:
    with open(t.paths.log_file) as f:
        return f.read()


def same_run(a: Trainer, b: Trainer) -> dict:
    """Bit-for-bit comparison of two runs: state (Adam moments, u and v
    included), replay, history, log."""
    roots = run_roots(a, b)
    return {"state": states_equal(a.state, b.state),
            "replay": (replay_rows(a.replay.entries, roots)
                       == replay_rows(b.replay.entries, roots)),
            "history": a.history == b.history,
            "log": read_log(a) == read_log(b)}


def scores_rel(got, want, roots, names=SCORE_METRICS) -> dict:
    """Per metric, the largest |a - b| / max(|b|, 1) over two lists of
    replay entries, entry for entry; their paths and names must agree."""
    ra, rb = replay_rows(got, roots), replay_rows(want, roots)
    if [r[:2] for r in ra] != [r[:2] for r in rb]:
        raise AssertionError("replay paths differ between the runs")
    return {m: max(abs(x[2][j] - y[2][j]) / max(abs(y[2][j]), 1.0)
                   for x, y in zip(ra, rb))
            for j, m in enumerate(SCORE_METRICS) if m in names}


def check_epoch_launches(t: SmokeTrainer, label: str) -> None:
    """IMCRA launched once per featurized batch, linrec once per PESQ
    chunk, the cascade and linrec_bwd not at all, in every epoch."""
    for rec in t.epochs:
        la, calls = rec["launches"], rec["calls"]
        want = {name: 0 for name in la}
        want["imcra_scan"] = calls.get("featurize", 0)
        want["linrec"] = calls.get("pesq", 0)
        if la != want or not (want["imcra_scan"] > 0 and (
                want["linrec"] > 0 or "pesq" not in t.metric_set)):
            raise AssertionError(f"trainer {label} epoch {rec['epoch']}: "
                                 f"launches {la}, expected {want}")


def small_config(epochs: int) -> Config:
    return Config(model=dataclasses.replace(Config().model, gen_hidden=32,
                                            gen_blocks=2),
                  train=dataclasses.replace(
                      Config().train, batch_size=4, num_sampling=8,
                      num_valid=TRAINER_SMALL_TEST, gan_epochs=epochs))


def trained_config() -> Config:
    """The trainer phase's full-width config (batch 8, 16 sampled, 8
    validated an epoch)."""
    return Config(train=dataclasses.replace(
        Config().train, batch_size=8, num_sampling=16, num_valid=8,
        gan_epochs=TRAINER_EPOCHS))


# a child that draws init_train_state(Config(), seed 0) on the CPU at
# argv[1] threads (0: torch's default) and prints one JSON line: its ATen
# CPU capability, threads, each tensor's digest and the draw's seconds
DRAW_CHILD = """
import hashlib, json, sys, time, torch
from nelegan_tpu_torch.config import Config
from nelegan_tpu_torch.train.gan import init_train_state
if int(sys.argv[1]):
    torch.set_num_threads(int(sys.argv[1]))
init_train_state(Config(), 0, device="cpu")
times = []
for _ in range(3):
    t0 = time.perf_counter()
    s = init_train_state(Config(), 0, device="cpu")
    times.append(time.perf_counter() - t0)
print(json.dumps({
    "capability": torch.backends.cpu.get_cpu_capability(),
    "threads": torch.get_num_threads(), "torch": torch.__version__,
    "draw_s": sorted(times)[1],
    "tensors": {f"{m}.{k}": hashlib.sha256(
        v.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]
        for m in ("gen", "d", "dq")
        for k, v in getattr(s, m).state_dict().items()}}))
"""
# the digest of init_train_state(Config(), seed 0) on the CPU that
# tests/test_torch_init_draw.py computes with torch 2.13.0+cpu on an x86
# host (AVX512 and DEFAULT capabilities alike)
CPU_TEST_DRAW_DIGEST = "c565482213f0ad49"


def draw_digest(tensors: dict) -> str:
    """One digest of a state's per-tensor digests, by name."""
    return hashlib.sha256("".join(f"{k}:{v};" for k, v in sorted(
        tensors.items())).encode()).hexdigest()[:16]


def draw_invariance(root: Path = REPO) -> dict:
    """init_train_state(Config(), seed 0) drawn on this host's CPU in two
    fresh processes of the package under `root`: under
    ATEN_CPU_CAPABILITY=default at one thread, and at the host's own
    capability at all its threads.  Each child's capability, threads and
    draw time (the median of three warm draws); the tensors that differ
    (gated by the caller); the digest beside the CPU test's."""
    kids = {}
    for name, cap, threads in (("default_1_thread", "default", 1),
                               ("host_all_threads", None, 0)):
        env = {k: v for k, v in os.environ.items()
               if k not in ("ATEN_CPU_CAPABILITY", "OMP_NUM_THREADS")}
        if cap:
            env["ATEN_CPU_CAPABILITY"] = cap
        env["PYTHONPATH"] = os.pathsep.join(filter(None, (
            str(root), env.get("PYTHONPATH"))))
        out = subprocess.run([sys.executable, "-c", DRAW_CHILD, str(threads)],
                             cwd=root, env=env, capture_output=True,
                             text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"draw child ({name}) exited "
                                 f"{out.returncode}:\n{out.stderr[-4000:]}")
        kids[name] = json.loads(out.stdout.strip().splitlines()[-1])
    a, b = (kids[k]["tensors"] for k in ("default_1_thread",
                                          "host_all_threads"))
    differ = sorted(k for k in a if a[k] != b.get(k))
    return {"children": {k: {x: v[x] for x in ("capability", "threads",
                                                "torch", "draw_s")}
                         for k, v in kids.items()},
            "tensors": len(a), "tensors_differ": len(differ),
            "first_differ": differ[:6],
            "digest": {k: draw_digest(v["tensors"]) for k, v in kids.items()},
            "cpu_test_digest": CPU_TEST_DRAW_DIGEST}


def trainer_phase(dev, tmp: str) -> dict:
    """The training loop (`train/loop.py`) on the card; every check raises.
    Full width (Config(), batch 8, 16 sampled and 8 validation utterances
    of 32 and 8, all five metrics, three epochs): launch counts per epoch;
    exact resume (epochs 1-2, a fresh Trainer resumes and runs epoch 3)
    bit for bit against the same run with its caches emptied before epoch
    3, and within CACHE_BAR and F32_UPDATE_BAR of the straight run with
    warm caches; a fourth, traced epoch for the busy shares.  Small config
    (hidden 32, 2 blocks, batch 4, 8 training utterances, ESTOI and
    PESQ): recovery from a fault in epoch 2 against a straight run emptied
    before epoch 2; the card against the CPU.  The paper's epoch size
    (PAPER_SAMPLED sampled, PAPER_VALID validated) at full width, cold and
    warm.  First `draw_invariance`, gated."""
    t_phase = time.perf_counter()
    drawn = draw_invariance()
    print(f"trainer phase, the initial state's draw on the host: {drawn}")
    if drawn["tensors_differ"]:
        raise AssertionError(f"the initial state's draw depends on the CPU "
                             f"path: {drawn}")
    cudnn = torch.backends.cudnn
    deterministic = cudnn.deterministic
    cudnn.deterministic = True
    SmokeTrainer.tally = tally = Tally()
    n_guards = len(GUARDS)
    try:
        res = trainer_checks(dev, tmp)
    finally:
        tally.restore()
        SmokeTrainer.tally = None
        cudnn.deterministic = deterministic
    res["draw_invariance"] = drawn
    res["generator_guard"] = guard_summary(guard_records(
        GUARDS[n_guards:], gate="trainer phase"))
    print(f"trainer phase, the generator through epoch 1: "
          f"{res['generator_guard']}")
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"trainer phase: {res['phase_s']:.1f} s")
    return res


def trainer_checks(dev, tmp: str) -> dict:
    corpus, small = f"{tmp}/trainer_corpus", f"{tmp}/trainer_small"
    write_trainer_corpus(corpus, TRAINER_TRAIN, TRAINER_TEST, seed=13)
    write_trainer_corpus(small, TRAINER_SMALL_TRAIN, TRAINER_SMALL_TEST,
                         seed=14)
    cfg = trained_config()

    def full(run, **kw):
        return SmokeTrainer(trainer_paths(corpus, f"{tmp}/{run}"), cfg,
                            metric_set=SCORE_METRICS, device=dev, **kw)

    # 1. the straight run, three epochs, then a fourth traced one
    t0 = time.perf_counter()
    straight = full("straight")
    origin = copy.deepcopy(straight.state)
    straight.run(TRAINER_EPOCHS)
    straight_s = time.perf_counter() - t0
    warm_state = copy.deepcopy(straight.state)
    warm_replay = copy.deepcopy(straight.replay.entries)
    check_epoch_launches(straight, "straight")
    straight.traced = True
    straight.start_epoch = TRAINER_EPOCHS + 1
    straight.run(TRAINER_EPOCHS + 1)
    check_epoch_launches(straight, "traced")
    written = {k: v for k, v in straight.tally.calls.items()
               if isinstance(k, tuple) and k[0] == "raw-enh"}
    if (written.get(("raw-enh", "scoring", "written", "miss"))
            or not written.get(("raw-enh", "scoring", "written", "hit"))):
        raise AssertionError(f"trainer: score_corpus missed the enhanced "
                             f"rows the loop parked: {written}")
    epochs = [{k: v for k, v in r.items() if k != "d_step_losses"}
              for r in straight.epochs]
    print(f"trainer at full width, {TRAINER_EPOCHS} epochs in "
          f"{straight_s:.1f} s: {json.dumps(epochs)}")

    # 2. exact resume: epochs 1-2, then a fresh Trainer resumes epoch 3;
    # the reference is the same run with its caches emptied before epoch 3
    ref = full("resume_ref")
    ref.run(TRAINER_EPOCHS - 1)
    # epochs 1-2 of the straight single-process run, the parallel phase's
    # reference
    single = {"state": copy.deepcopy(ref.state), "origin": origin,
              "replay": copy.deepcopy(ref.replay.entries),
              "scored": copy.deepcopy(ref.scored),
              "epochs": [{k: v for k, v in r.items() if k != "d_step_losses"}
                         for r in ref.epochs],
              "root": run_roots(ref)[0]}
    resumed_dir = f"{tmp}/resumed"
    shutil.copytree(ref.paths.checkpoints, f"{resumed_dir}/chkpt",
                    symlinks=True)
    shutil.copy(ref.paths.log_file, f"{resumed_dir}/log.txt")
    ref.clear_caches()
    ref.start_epoch = TRAINER_EPOCHS
    ref.run(TRAINER_EPOCHS)
    resumed = full("resumed")
    resumed.resume(truncate_log=True)
    if resumed.start_epoch != TRAINER_EPOCHS:
        raise AssertionError(f"resume: start epoch {resumed.start_epoch}")
    resumed.run(TRAINER_EPOCHS)
    for t, label in ((ref, "resume_ref"), (resumed, "resumed")):
        check_epoch_launches(t, label)
    exact = same_run(resumed, ref)
    warm_pair = {"scores": scores_rel(resumed.replay.entries, warm_replay,
                                      run_roots(resumed, straight, ref)),
                 "state": state_errors(resumed.state, warm_state, origin)}
    print(f"exact resume at full width (epochs 1-2, a fresh Trainer resumes "
          f"epoch 3) against the run emptied before epoch 3: {exact}; "
          f"against the straight run with warm caches: {warm_pair} (bars "
          f"CACHE_BAR {CACHE_BAR}, F32_UPDATE_BAR {F32_UPDATE_BAR})")
    if not all(exact.values()):
        raise AssertionError(f"resume is not exact: {exact}")
    if not (all(v < CACHE_BAR for v in warm_pair["scores"].values())
            and warm_pair["state"]["update_rel"] <= F32_UPDATE_BAR):
        raise AssertionError(f"resumed vs warm straight run: {warm_pair}")

    # the pre-enhanced files the resumed run scored in epoch 3, in its
    # order, through a fresh CleanSidePool (each KLT a pool miss, taken
    # alone) and without one (beside the degraded signal)
    files = list(resumed._drc_score_cache)
    names = [os.path.basename(p) for p in files]
    idx = resumed.train_index
    triple = ([read_wav(idx.clean_path_for(n))[0] for n in names],
              [read_wav(idx.noise_path(idx.clean_path_for(n)))[0]
               for n in names], [read_wav(p)[0] for p in files])
    pooled = metrics.score_corpus(*triple, clean_cache=CleanSidePool(),
                                  clean_keys=names, enhanced_keys=files,
                                  device=dev)
    plain = metrics.score_corpus(*triple, device=dev)
    drc_pool = max_rel(pooled, plain)
    print(f"the {len(files)} pre-enhanced files of epoch 3 through a fresh "
          f"CleanSidePool against none (calibrated): {drc_pool}")
    if not all(v < CACHE_BAR for v in drc_pool.values()):
        raise AssertionError(f"pool vs none on the trainer's files: "
                             f"{drc_pool}")

    # 3. recovery at the small config
    scfg = small_config(3)
    attempts = {"n": 0}

    class Flaky(SmokeTrainer):
        def run_epoch(self, epoch):
            if attempts["n"] == 1 and epoch == 2:
                raise RuntimeError("injected device fault")
            return super().run_epoch(epoch)

    def small_trainer(run, cls=SmokeTrainer, c=scfg, device=dev):
        return cls(trainer_paths(small, f"{tmp}/{run}"), c,
                   metric_set=TRAINER_SMALL_METRICS, device=device)

    def make():
        attempts["n"] += 1
        return small_trainer("flaky", Flaky)

    recovered = run_with_recovery(make, epochs=3, max_retries=2,
                                  backoff_seconds=0.01)
    rref = small_trainer("recovery_ref")
    rref.run(1)
    rref.clear_caches()
    rref.start_epoch = 2
    rref.run(3)
    recovery = dict(same_run(recovered, rref), attempts=attempts["n"],
                    log_lines=len(read_log(recovered).splitlines()))
    print(f"recovery (fault in epoch 2, one rebuild) against a straight run "
          f"emptied before epoch 2: {recovery}")
    check_epoch_launches(recovered, "recovered")
    check_epoch_launches(rref, "recovery_ref")
    if not (attempts["n"] == 2 and recovery["log_lines"] == 3
            and all(recovery[k] for k in ("state", "replay", "history",
                                          "log"))):
        raise AssertionError(f"recovery: {recovery}")

    # 4. the card against the CPU, the same config and initial state; the
    # card's D trains on the CPU's scores, so that both devices' D losses
    # have the same targets (the card's own scores are held apart)
    pcfg = small_config(2)
    t0 = time.perf_counter()
    cpu = small_trainer("cpu", c=pcfg, device="cpu")
    cpu.run(2)
    cpu_s = time.perf_counter() - t0
    base = small_trainer("card", c=pcfg)
    base.targets = cpu.scored
    base.rescored = {}
    base.run(2)
    check_epoch_launches(base, "card vs CPU")
    # the CPU against itself from an initial state one float32 ulp up in
    # every parameter: how far float32 round-off alone carries two epochs
    ulp = small_trainer("cpu_ulp", c=pcfg, device="cpu")
    one_ulp_up(ulp)
    ulp.run(2)
    cpu_origin = gan.init_train_state(pcfg, pcfg.train.seed, "cpu")
    if ([(k, sorted(v)) for k, v in sorted(base.scored.items())]
            != [(k, sorted(v)) for k, v in sorted(cpu.scored.items())]
            or replay_rows(base.replay.entries, run_roots(base))
            != replay_rows(cpu.replay.entries, run_roots(cpu))):
        raise AssertionError("trainer card vs CPU: files or replay differ")

    # the card's scores against the CPU's float64 scores of the same files
    # (SCORE_BARS), and against the CPU run's scores of its own files
    # (cross_run_bars of the CPU against itself one ulp away)
    card_err = score_gap(base.scored, base.rescored, TRAINER_SMALL_METRICS)

    def drift(run):
        """`run` against the CPU run: G's epoch loss and each D head's
        epoch mean, relative; each D step's loss relative to its head's
        epoch mean on the CPU (a step near its target has a loss near 0,
        whose own relative error says nothing); the state."""
        if [len(r["d_step_losses"]) for r in run.epochs] != [
                len(r["d_step_losses"]) for r in cpu.epochs]:
            raise AssertionError("trainer: the runs took different D steps")

        def rel(pairs):
            return max((abs(a - b) / abs(b) for a, b in pairs if b != 0),
                       default=0.0)
        return {"g_loss_rel": rel((r["g_loss"], q["g_loss"])
                                  for r, q in zip(run.epochs, cpu.epochs)),
                "d_epoch_loss_rel": rel(
                    x for r, q in zip(run.epochs, cpu.epochs)
                    for x in zip(r["d_loss"], q["d_loss"])),
                "d_step_loss_rel": max(
                    abs(a[k] - b[k]) / abs(q["d_loss"][k])
                    for r, q in zip(run.epochs, cpu.epochs)
                    for a, b in zip(r["d_step_losses"], q["d_step_losses"])
                    for k in (0, 1) if q["d_loss"][k] != 0),
                "epoch_losses": [{"g": (r["g_loss"], q["g_loss"]),
                                  "d": list(zip(r["d_loss"], q["d_loss"]))}
                                 for r, q in zip(run.epochs, cpu.epochs)],
                "state": state_errors(run.state, cpu.state, cpu_origin)}
    vs_cpu = dict(drift(base), scores=card_err,
                  scores_of_each_runs_files=score_gap(
                      base.scored, cpu.scored, TRAINER_SMALL_METRICS),
                  cpu_seconds=cpu_s)
    ulp_pair = dict(drift(ulp), scores_of_each_runs_files=score_gap(
        ulp.scored, cpu.scored, TRAINER_SMALL_METRICS))
    ulp_pair.pop("epoch_losses")
    cross_bars = cross_run_bars(ulp_pair["scores_of_each_runs_files"])
    print(f"trainer, card against CPU (small config, 2 epochs, same initial "
          f"state, the card's D on the CPU's scores): {vs_cpu}; the CPU "
          f"against itself one ulp away: {ulp_pair}; bars {SCORE_BARS} "
          f"(scores), {cross_bars} (scores_of_each_runs_files), "
          f"F32_LOSS_BAR {F32_LOSS_BAR} (G), F32_UPDATE_BAR {F32_UPDATE_BAR}"
          f" (D losses, state)")
    vs_cpu["cpu_one_ulp_away"] = ulp_pair
    vs_cpu["cross_run_bars"] = cross_bars
    # G's epoch loss is held to the one-step bar; a D loss, taken after up
    # to 30 D steps and one G epoch, is a function of the stepped state
    # and is held to the bar of the state's update (one ulp of initial
    # state already moves it past F32_LOSS_BAR on the CPU alone)
    if not (all(card_err[m] < SCORE_BARS[m] for m in card_err)
            and all(vs_cpu["scores_of_each_runs_files"][m] <= cross_bars[m]
                    for m in cross_bars)
            and vs_cpu["g_loss_rel"] <= F32_LOSS_BAR
            and vs_cpu["d_epoch_loss_rel"] <= F32_UPDATE_BAR
            and vs_cpu["d_step_loss_rel"] <= F32_UPDATE_BAR
            and vs_cpu["state"]["update_rel"] <= F32_UPDATE_BAR):
        raise AssertionError(f"trainer card vs CPU: {vs_cpu}")

    # 5. the paper's epoch size: cold, then warm
    paper_corpus = f"{tmp}/trainer_paper"
    write_trainer_corpus(paper_corpus, PAPER_SAMPLED, PAPER_VALID, seed=15)
    paper_cfg = Config(train=dataclasses.replace(
        Config().train, batch_size=8, num_sampling=PAPER_SAMPLED,
        num_valid=PAPER_VALID, gan_epochs=PAPER_EPOCHS))
    t0 = time.perf_counter()
    paper = SmokeTrainer(trainer_paths(paper_corpus, f"{tmp}/paper"),
                         paper_cfg, metric_set=SCORE_METRICS, device=dev)
    paper.run(PAPER_EPOCHS)
    paper_s = time.perf_counter() - t0
    check_epoch_launches(paper, "paper size")
    paper_epochs = [{k: v for k, v in r.items() if k != "d_step_losses"}
                    for r in paper.epochs]
    print(f"trainer at the paper's epoch size ({PAPER_SAMPLED} sampled, "
          f"{PAPER_VALID} validated), {PAPER_EPOCHS} epochs in "
          f"{paper_s:.1f} s: {json.dumps(paper_epochs)}")

    ep = {r["epoch"]: r for r in straight.epochs}
    launches = {name: sum(ep[e]["launches"][name]
                          for e in range(1, TRAINER_EPOCHS + 1))
                for name in kernels.launches}
    return {"epochs": epochs, "straight_s": straight_s,
            "launches": launches,
            "featurized_batches": sum(ep[e]["calls"].get("featurize", 0)
                                      for e in range(1, TRAINER_EPOCHS + 1)),
            "pesq_chunks": sum(ep[e]["calls"].get("pesq", 0)
                               for e in range(1, TRAINER_EPOCHS + 1)),
            "utterances_per_s": {"cold": ep[1]["utterances_per_s"],
                                 "warm": ep[TRAINER_EPOCHS][
                                     "utterances_per_s"]},
            "paper_size": {"epochs": paper_epochs, "seconds": paper_s,
                           "utterances_per_s": {
                               "cold": paper.epochs[0]["utterances_per_s"],
                               "warm": paper.epochs[-1][
                                   "utterances_per_s"]}},
            "busy_share_warm": straight.busy,
            "raw_enh_lookups": {"_".join(k): v for k, v in written.items()},
            "exact_resume": exact, "warm_pair": warm_pair,
            "drc_pool_vs_none": drc_pool,
            "recovery": recovery, "card_vs_cpu": vs_cpu, "_single": single}


# ------------------------------------------------------- mixed precision
def tensors_f32_finite(state: gan.TrainState) -> bool:
    """Every parameter and buffer (u, v) of the three models float32 and
    finite."""
    return all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for m in (state.gen, state.d, state.dq)
               for v in m.state_dict().values())


def mixed_precision_phase(dev, corpus: str, tmp: str,
                          f32_epochs: list) -> dict:
    """The bfloat16 policy (`compute_dtype="bfloat16"`) at full width,
    batch 8, bucket 36864, TF32 off, against float32 from the same weights
    and inputs; every check raises.  Launch counts are zeroed at the start
    and read at the end (the trainer's epochs each zero and read their
    own, which are added): IMCRA once per featurized batch, linrec once per
    PESQ chunk, as in float32.  `corpus` is the trainer phase's, whose
    straight run's first MP_EPOCHS records (`f32_epochs`) are printed
    beside the bfloat16 trainer's."""
    t_phase = time.perf_counter()
    cfg32 = Config()
    cfg16 = Config(model=dataclasses.replace(cfg32.model,
                                             compute_dtype="bfloat16"))
    cp, npd, lens, row_valid = train_batch()
    rng = np.random.RandomState(8)
    targets = (rng.uniform(0.2, 0.9, (8, 3)).astype(np.float32),
               rng.uniform(0.2, 0.9, (8, 2)).astype(np.float32))
    torch.cuda.synchronize()
    kernels.reset_launches()
    with torch.no_grad():
        feats = pipeline.featurize_batch(cp, npd, lens, cfg32.train.p_power,
                                         cfg32.imcra, device=dev)
    states = {"float32": gan.init_train_state(cfg32, 0, dev),
              "bfloat16": gan.init_train_state(cfg16, 0, dev)}
    if not (states_equal(*states.values())
            and tensors_f32_finite(states["bfloat16"])):
        raise AssertionError("bf16: the policies' initial states differ")

    # the same weights and inputs under both policies
    fmask = pipeline.frame_mask(feats.frames, feats.clean_band.shape[1])
    with torch.no_grad():
        masks = {k: s.gen(feats.clean_band, feats.noise_band)
                 for k, s in states.items()}
        wav, _, out_len = pipeline.enhance_batch(states["float32"].gen,
                                                 feats, device=dev)
    eband = gan.eband_from_enhanced(wav, out_len, cfg32, device=dev)
    img3, img2 = gan.d_images(eband, feats.noise_band, feats.clean_band,
                              feats.frames)
    scores = {}
    for k, s in states.items():
        s.d.eval()
        s.dq.eval()
        with torch.no_grad():
            scores[k] = (s.d(img3, feats.frames), s.dq(img2, feats.frames))
        s.d.train()
        s.dq.train()
    rel = ((masks["bfloat16"] - masks["float32"]).abs()
           / masks["float32"])[fmask]
    parity = {"mask_mean_rel": float(rel.mean()),
              "mask_max_rel": float(rel.max()),
              "intel_max_abs": float((scores["bfloat16"][0]
                                      - scores["float32"][0]).abs().max()),
              "quality_max_abs": float((scores["bfloat16"][1]
                                        - scores["float32"][1]).abs().max()),
              "dtypes": sorted({str(x.dtype) for x in
                                (masks["bfloat16"], *scores["bfloat16"])})}
    print(f"bf16 against float32 on the same weights and inputs (valid "
          f"frames): {parity}; bars {MP_MEAN_BAR}, {MP_MAX_BAR} (mask), "
          f"{MP_SCORE_BAR} (scores)")
    if not (parity["mask_mean_rel"] < MP_MEAN_BAR
            and parity["mask_max_rel"] < MP_MAX_BAR
            and parity["intel_max_abs"] < MP_SCORE_BAR
            and parity["quality_max_abs"] < MP_SCORE_BAR
            and parity["dtypes"] == ["torch.float32"]):
        raise AssertionError(f"bf16 against float32: {parity}")

    # one bf16 G step and one D step
    st = copy.deepcopy(states["bfloat16"])
    _, gl = gan.g_step(st, feats, cfg16, INTEL_COLS, None, row_valid)
    _, dl, ql = gan.d_step_bands(st, eband, feats.noise_band,
                                 feats.clean_band, feats.frames, *targets,
                                 cfg16, intel_cols=INTEL_COLS,
                                 row_valid=row_valid)
    step_losses = [float(gl), float(dl), float(ql)]
    origin = states["bfloat16"]
    moved = {m: any(not torch.equal(p, q) for p, q in zip(
        getattr(st, m).parameters(), getattr(origin, m).parameters()))
        for m in ("gen", "d", "dq")}
    if not (all(np.isfinite(step_losses)) and tensors_f32_finite(st)
            and all(moved.values())):
        raise AssertionError(f"bf16 steps: losses {step_losses}, moved "
                             f"{moved}")
    print(f"one bf16 G step and D step: losses {step_losses}; parameters, "
          f"u and v float32 and finite; moved {moved}")

    times = {k: step_times(c, states[k], feats, eband, targets, row_valid)
             for k, c in (("float32", cfg32), ("bfloat16", cfg16))}
    print(f"G and D steps by policy, batch 8, bucket {BUCKET}, TF32 off: " +
          "; ".join(f"{k} G {v['g']['ms']:.3f} ms (busy "
                    f"{v['g']['busy_share']:.3f}), D {v['d']['ms']:.3f} ms "
                    f"(busy {v['d']['busy_share']:.3f})"
                    for k, v in times.items()))
    torch.cuda.synchronize()
    launches = dict(kernels.launches)

    # the bf16 trainer on the trainer phase's corpus, cold then warm
    cfg = Config(model=cfg16.model, train=dataclasses.replace(
        Config().train, batch_size=8, num_sampling=16, num_valid=8,
        gan_epochs=MP_EPOCHS))
    cudnn = torch.backends.cudnn
    deterministic, cudnn.deterministic = cudnn.deterministic, True
    SmokeTrainer.tally = tally = Tally()
    try:
        t = SmokeTrainer(trainer_paths(corpus, f"{tmp}/bf16"), cfg,
                         metric_set=SCORE_METRICS, device=dev)
        t.run(MP_EPOCHS)
        check_epoch_launches(t, "bf16")
    finally:
        tally.restore()
        SmokeTrainer.tally = None
        cudnn.deterministic = deterministic
    if not tensors_f32_finite(t.state):
        raise AssertionError("bf16 trainer: a tensor is not float32 and "
                             "finite")
    guarded = guard_summary(guard_records([t.gen_guard],
                                          gate="bf16 trainer"))
    for rec in t.epochs:
        for name, n in rec["launches"].items():
            launches[name] += n
    epochs = [{k: r[k] for k in ("epoch", "epoch_seconds", "phases_s",
                                 "g_steps", "d_steps", "launches",
                                 "utterances_per_s", "g_loss")}
              for r in t.epochs]
    beside = [{k: r[k] for k in ("epoch", "epoch_seconds", "phases_s",
                                 "utterances_per_s")}
              for r in f32_epochs[:MP_EPOCHS]]
    print(f"bf16 trainer, {MP_EPOCHS} epochs (cold, warm): "
          f"{json.dumps(epochs)}; the trainer phase's float32 epochs: "
          f"{json.dumps(beside)}")
    res = {"parity": parity, "step_losses": step_losses, "moved": moved,
           "steps": times, "trainer_epochs": epochs,
           "trainer_f32_epochs": beside, "launches": launches,
           "generator_guard": guarded,
           "phase_s": time.perf_counter() - t_phase}
    print(f"mixed-precision phase: {res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------------------ direct
def direct_rows():
    """train_batch's eight rows (seven requests of the 36864 bucket and the
    seventh again) as the direct step takes them: reflect-padded for
    featurization, with lengths, and the raw clean and noise rows in
    zero-tailed [8, BUCKET] buffers."""
    reqs = build_requests()[:7]
    reqs.append(reqs[-1])
    cp, lens = pipeline.reflect_pad_batch([r[0] for r in reqs], BUCKET)
    npd, _ = pipeline.reflect_pad_batch([r[1] for r in reqs], BUCKET)
    wc = np.zeros((8, BUCKET), np.float32)
    wn = np.zeros((8, BUCKET), np.float32)
    for i, (c, n) in enumerate(reqs):
        wc[i, :c.size], wn[i, :n.size] = c, n
    return cp, npd, lens, wc, wn


def real_estoi(gen, feats, wc, wn, lens, dev) -> float:
    """Mean ESTOI (`metrics.estoi`) over the seven distinct rows of the
    PCM16 enhanced output plus noise against the clean row, the enhanced
    row cut to the clean row's length, as tests/test_direct.py scores."""
    with torch.no_grad():
        wav = pipeline.enhance_batch(gen, feats, device=dev)[0]
        enh = pipeline.pcm16_quantize(wav)
    return float(np.mean([float(metrics.estoi(
        wc[i, :m], enh[i, :m] + wn[i, :m], 16000))
        for i, m in enumerate(lens[:7].tolist())]))


def launch_delta(before: dict) -> dict:
    torch.cuda.synchronize()
    return {k: v - before.get(k, 0) for k, v in kernels.launches.items()}


def direct_phase(dev) -> dict:
    """The direct-metric G step (`train/direct.py`) at full width: the
    seeded generator, train_batch's eight rows featurized once (one IMCRA
    launch), float32, TF32 off; every check raises.  Launch counts are
    zeroed just before the featurization and read at the end; each part's
    are read as differences: linrec and linrec_bwd once per step that
    weighs PESQ, 0 otherwise, IMCRA 0 in the steps."""
    t_phase = time.perf_counter()
    cfg = Config()
    cp, npd, lens, wc_np, wn_np = direct_rows()
    gen0 = seeded_generator(0).to(dev)
    wc, wn = (torch.from_numpy(a).to(dev) for a in (wc_np, wn_np))
    torch.cuda.synchronize()
    kernels.reset_launches()
    with torch.no_grad():
        feats = pipeline.featurize_batch(cp, npd, lens, cfg.train.p_power,
                                         cfg.imcra, device=dev)
    featurize = launch_delta({})
    if featurize["imcra_scan"] != 1 or sum(featurize.values()) != 1:
        raise AssertionError(f"direct featurization launched {featurize}")

    # 1. the card's float32 against the CPU's float64, all three terms, on
    # DIRECT_CPU_ROWS rows
    r = DIRECT_CPU_ROWS
    sub = pipeline.BatchFeatures(*(x[:r] for x in feats))
    gen = copy.deepcopy(gen0)
    loss32 = direct.direct_metric_loss(gen, sub, wc[:r], wn[:r], cfg, 1.0,
                                       1.0)
    loss32.backward()
    t0 = time.perf_counter()
    gen64 = copy.deepcopy(gen0).cpu().double()
    sub64 = pipeline.BatchFeatures(*(
        x.cpu().double() if x.is_floating_point() else x.cpu() for x in sub))
    loss64 = direct.direct_metric_loss(
        gen64, sub64, wc[:r].cpu().double(), wn[:r].cpu().double(), cfg,
        1.0, 1.0)
    loss64.backward()
    cpu_s = time.perf_counter() - t0
    grads64 = dict(gen64.named_parameters())
    grad_rel = {k: float((p.grad.double().cpu() - grads64[k].grad).norm()
                         / grads64[k].grad.norm())
                for k, p in gen.named_parameters()}
    l32, l64 = loss32.item(), loss64.item()
    vs_cpu = {"rows": r, "loss": l32, "loss_cpu_f64": l64,
              "loss_rel": abs(l32 - l64) / abs(l64),
              "grad_rel_max": max(grad_rel.values()),
              "grad_rel_max_param": max(grad_rel, key=grad_rel.get),
              "finite": all(bool(torch.isfinite(p.grad).all())
                            for p in gen.parameters()),
              "cpu_f64_s": cpu_s}
    print(f"direct loss (ESTOI + HASPI + PESQ, weights 1) and gradient, card "
          f"float32 against CPU float64: {vs_cpu}; bars {DIRECT_LOSS_BAR} "
          f"(loss), {DIRECT_GRAD_BAR} (each parameter's gradient in norm)")
    if not (vs_cpu["finite"] and vs_cpu["loss_rel"] <= DIRECT_LOSS_BAR
            and vs_cpu["grad_rel_max"] <= DIRECT_GRAD_BAR):
        raise AssertionError(f"direct card vs CPU: {vs_cpu}")

    # 2. twelve ESTOI steps: the loss falls, the real ESTOI rises
    gen = copy.deepcopy(gen0)
    opt = torch.optim.Adam(gen.parameters(), lr=cfg.train.lr_g)
    before = dict(kernels.launches)
    losses = [float(direct.direct_g_step(gen, opt, feats, wc, wn, cfg))
              for _ in range(DIRECT_STEPS)]
    estoi_launches = launch_delta(before)
    real = {"seeded": real_estoi(gen0, feats, wc, wn, lens, dev),
            "trained": real_estoi(gen, feats, wc, wn, lens, dev)}
    print(f"{DIRECT_STEPS} direct ESTOI steps: losses {losses}; real ESTOI "
          f"(PCM16 enhanced + noise, mean of 7 rows) {real}; launches "
          f"{estoi_launches}")
    if not (losses[-1] < losses[0] and real["trained"] > real["seeded"]
            and not any(estoi_launches.values())):
        raise AssertionError(f"direct ESTOI steps: {losses}, {real}, "
                             f"{estoi_launches}")

    # 3-4. step time by term, peak memory, launches per step
    terms = {}
    for name, hw, pw in DIRECT_TERMS:
        gen = copy.deepcopy(gen0)
        opt = torch.optim.Adam(gen.parameters(), lr=cfg.train.lr_g)
        calls = [0]

        def step():
            calls[0] += 1
            return direct.direct_g_step(gen, opt, feats, wc, wn, cfg, hw, pw)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(kernels.launches)
        ms = cuda_ms(step, calls=1, samples=DIRECT_TIMED, warmup=1)
        la = launch_delta(before)
        want = {k: 0 for k in la}
        if pw > 0:
            want["linrec"] = want["linrec_bwd"] = calls[0]
        terms[name] = {"ms": ms, "steps": calls[0], "launches": la,
                       "peak_bytes": torch.cuda.max_memory_allocated()}
        if la != want:
            raise AssertionError(f"direct {name}: launches {la}, expected "
                                 f"{want}")
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    terms[name]["wall_ms"] = wall_ms
    terms[name]["profile"] = profile_step(step, wall_ms, reps=1,
                                          label="direct_step_profile")
    print(f"direct step by term, batch 8, bucket {BUCKET} (CUDA events, median "
          f"of {DIRECT_TIMED}): " + "; ".join(
              f"{k} {v['ms']:.2f} ms, peak {v['peak_bytes'] / 2**30:.2f} GiB"
              for k, v in terms.items()))

    # 5. one ESTOI + PESQ step under the bf16 policy
    gen16 = Generator(compute_dtype="bfloat16")
    gen16.load_state_dict(gen0.state_dict())
    gen16.to(dev)
    opt = torch.optim.Adam(gen16.parameters(), lr=cfg.train.lr_g)
    loss16 = float(direct.direct_g_step(gen16, opt, feats, wc, wn, cfg, 0.0,
                                        1.0))
    finite16 = np.isfinite(loss16) and all(
        bool(torch.isfinite(p.grad).all()) and p.dtype == torch.float32
        for p in gen16.parameters())
    print(f"one bf16 direct step (ESTOI + PESQ): loss {loss16}, gradient "
          f"finite {finite16}")
    if not finite16:
        raise AssertionError(f"bf16 direct step: loss {loss16}")
    torch.cuda.synchronize()
    res = {"vs_cpu": vs_cpu, "estoi_steps": losses, "real_estoi": real,
           "terms": terms, "bf16_loss": loss16,
           "launches": dict(kernels.launches),
           "phase_s": time.perf_counter() - t_phase}
    print(f"direct phase: {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------- parallel
def nccl_probe_rank(mesh) -> float:
    """One all-reduce over NCCL (two ranks on one card: NCCL refuses)."""
    x = torch.ones(1, device=mesh.device)
    torch.distributed.all_reduce(x)
    return float(x)


class DpSmokeTrainer(SmokeTrainer):
    """A rank's SmokeTrainer with, per epoch, its collectives (calls and
    seconds by tag, the mesh timed) and its state's replica digest."""

    def run_epoch(self, epoch):
        before = {k: tuple(v) for k, v in self.mesh.stats.items()}
        means = super().run_epoch(epoch)
        rec = self.epochs[-1]
        rec["collectives"] = {
            k: [v[0] - before.get(k, (0, 0.0))[0],
                v[1] - before.get(k, (0, 0.0))[1]]
            for k, v in self.mesh.stats.items()}
        rec["digest"] = parallel.replica_digest(self.state).tolist()
        return means


def nccl_world_of_one(dev) -> dict:
    """The mesh's collectives over NCCL in a world of this process alone
    (`launch.world_of_one`): `replicate` of a full-width TrainState, one
    `all_reduce_sum` of G's 2,093,120 gradients, `all_gather_rows` of a
    column-major leaf, `assert_replicated`; each result bit-equal to its
    input (a world of one sums and gathers nothing else), the calls
    counted and the all-reduce timed (host clock, the device synchronised
    around it; an NCCL kernel on the card that moves no data between
    cards)."""
    state = gan.init_train_state(Config(), 0, dev)
    want = copy.deepcopy(state)
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
             .to(dev) for i, p in enumerate(state.gen.parameters())]
    leaf = torch.randn(6, 5, device=dev).t()          # column-major
    with launch.world_of_one("nccl", dev) as mesh:
        mesh.timed = True
        parallel.replicate(mesh, state)
        summed = parallel.all_reduce_sum(mesh, grads, "all_reduce:gen")
        gathered = parallel.all_gather_rows(mesh, {"x": leaf})["x"]
        parallel.assert_replicated(mesh, state)
        stats = {k: list(v) for k, v in mesh.stats.items()}
        backend = mesh.backend
    out = {"backend": backend,
           "state": states_equal(state, want),
           "all_reduce": all(torch.equal(a, b) for a, b in
                             zip(summed, grads)),
           "all_gather": (torch.equal(gathered, leaf)
                          and gathered.stride() == leaf.stride()),
           "collectives": {k: v[0] for k, v in stats.items()},
           "g_all_reduce_ms": 1e3 * stats["all_reduce:gen"][1],
           "g_all_reduce_mb": sum(g.numel() * 4 for g in grads) / 1e6}
    if not (backend == "nccl" and out["state"] and out["all_reduce"]
            and out["all_gather"] and stats["all_reduce:gen"][0] == 1):
        raise AssertionError(f"NCCL world of one: {out}")
    return out


def dp_trainer_rank(mesh, cfg: Config, corpus: str, run: str,
                    targets: dict) -> dict:
    """One rank of the data-parallel trainer: `Trainer(data_parallel=True)`
    over the world `parallel.launch` made, float32, TF32 off,
    deterministic cuDNN (set here: a spawned process inherits neither);
    its D on `targets`, the single run's scores (its own computed beside
    them).  Epochs 1-DP_EPOCHS, then one more traced for the busy shares,
    on its own scores."""
    disable_tf32()
    torch.backends.cudnn.deterministic = True
    SmokeTrainer.tally = tally = Tally()
    undo = install_generator_guard()
    try:
        t = DpSmokeTrainer(trainer_paths(corpus, run), cfg,
                           metric_set=SCORE_METRICS, data_parallel=True,
                           device=mesh.device, targets=targets)
        if t.mesh is None or t.mesh.world != mesh.world:
            raise AssertionError("the dp trainer built no mesh")
        t.mesh.timed = True
        t.run(DP_EPOCHS)
        # the traced epoch trains on its own scores
        t.targets = None
        t.traced = True
        t.start_epoch = DP_EPOCHS + 1
        t.run(DP_EPOCHS + 1)
    finally:
        undo()
        tally.restore()
        SmokeTrainer.tally = None
    return {"rank": mesh.rank, "generator_guard": t.gen_guard.record(),
            "epochs": [{k: v for k, v in r.items() if k != "d_step_losses"}
                       for r in t.epochs],
            "scored": t.scored, "busy": t.busy,
            "replay": replay_rows(t.replay.entries, run_roots(t)),
            "history": t.history, "tp": tp_rank(mesh)}


def tp_inputs(cfg: Config, dev) -> tuple:
    """The training phase's batch (`train_batch`: 8 rows of the 36864
    bucket, one a padding row) featurized on this rank's card (one IMCRA
    launch), its clean rows at half gain as the enhanced bands (the
    trainer's pre-enhanced stand-in), seeded targets, row_valid."""
    cp, npd, lens, row_valid = train_batch()
    cb, nb, fr = gan.featurize_bands(cp, npd, lens, cfg, device=dev)
    eb = gan.speech_band(0.5 * cp, cfg, device=dev).to(cb.dtype)
    rng = np.random.RandomState(11)
    tg = rng.uniform(0.2, 0.9, (8, 3)).astype(np.float32)
    tq = rng.uniform(0.2, 0.9, (8, 2)).astype(np.float32)
    return cb, nb, eb, fr, tg, tq, row_valid


def tp_step_fns(state, ins, cfg: Config, mesh) -> tuple:
    """(a G step, a D step) of `state` on `mesh`'s rows of `ins` (None:
    all of them), each returning its losses as device scalars."""
    cb, nb, eb, fr, tg, tq, rv = (ins if mesh is None else
                                  parallel.shard_batch(mesh, ins))

    def g():
        return gan.g_step_bands(state, cb, nb, fr, cfg, INTEL_COLS, None,
                                rv, mesh)[1:]

    def d():
        return gan.d_step_bands(state, eb, nb, cb, fr, tg, tq, cfg,
                                intel_cols=INTEL_COLS, row_valid=rv,
                                mesh=mesh)[1:]
    return g, d


def tp_time(state, ins, cfg: Config, mesh, barrier) -> dict:
    """Host-clock ms a G step and a D step (TP_TIMED warm steps, after two
    untimed, the device synchronised at the end; the ranks start each
    burst together) and, with a mesh, each step's collectives by tag:
    calls and ms (TP_TRACED more steps with the mesh timed)."""
    out = {}
    for name, fn in zip("gd", tp_step_fns(state, ins, cfg, mesh)):
        fn()
        fn()
        torch.cuda.synchronize()
        barrier()
        t0 = time.perf_counter()
        for _ in range(TP_TIMED):
            fn()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) / TP_TIMED * 1e3
        if mesh is None:
            continue
        before = {k: tuple(v) for k, v in mesh.stats.items()}
        mesh.timed = True
        for _ in range(TP_TRACED):
            fn()
        mesh.timed = False
        out[f"{name}_collectives"] = {
            k: [(v[0] - before.get(k, (0, 0.0))[0]) / TP_TRACED,
                1e3 * (v[1] - before.get(k, (0, 0.0))[1]) / TP_TRACED]
            for k, v in mesh.stats.items()
            if v[0] != before.get(k, (0, 0.0))[0]}
    return out


def tp_rank(mesh) -> dict:
    """The tensor-parallel part of the parallel phase, on one rank of its
    gloo world (float32, TF32 off, deterministic cuDNN, set by the
    caller): a second mesh over the same ranks, model axis TP_MODEL and
    data axis 1; the full-width state from seed 0 (the same on every rank)
    sharded over it (`shard_params`) takes one G step and one D step on
    `tp_inputs`; rank 0 takes the same steps from the same state alone,
    and compares the losses and the gathered state (`gather_params`).
    The sharded state's replicated leaves bit-equal on both ranks
    (`assert_replicated` raises).  Then step times: single (rank 0 alone,
    the other rank waiting), dp (the world's data mesh, 4 rows a rank)
    and tp."""
    cfg, dev = Config(), mesh.device
    launched = dict(kernels.launches)
    ins = tp_inputs(cfg, dev)
    out = {"rank": mesh.rank}
    origin = gan.init_train_state(cfg, 0, dev)
    tp = parallel.make_mesh(devices=[dev] * mesh.world,
                            model_parallel=TP_MODEL)
    sharded = parallel.shard_params(tp, copy.deepcopy(origin))
    out["tp_losses"] = [float(x) for fn in tp_step_fns(sharded, ins, cfg, tp)
                        for x in fn()]
    parallel.assert_replicated(tp, sharded, "the tensor-parallel state")
    whole = parallel.gather_params(tp, sharded)
    if mesh.rank == 0:
        ref = copy.deepcopy(origin)
        out["single_losses"] = [float(x) for fn in
                                tp_step_fns(ref, ins, cfg, None)
                                for x in fn()]
        out["state"] = state_errors(whole, ref, origin)
    # the checked G and D steps' collectives, gather_params' and the check's
    out["collectives"] = {k: v[0] for k, v in tp.stats.items()}
    times = {}
    mesh.barrier()
    if mesh.rank == 0:
        times["single"] = tp_time(copy.deepcopy(origin), ins, cfg, None,
                                  lambda: None)
    times["dp"] = tp_time(copy.deepcopy(origin), ins, cfg, mesh,
                          mesh.barrier)
    times["tp"] = tp_time(sharded, ins, cfg, tp, tp.barrier)
    out["times"] = times
    out["launches"] = {k: v - launched[k] for k, v in kernels.launches.items()}
    return out


def tp_check(parts: list) -> dict:
    """The tensor-parallel part's gates on what its ranks returned: G's
    loss within F32_LOSS_BAR of the single rank's, the D heads' losses and
    the gathered state's update within F32_UPDATE_BAR; both ranks' losses
    equal; IMCRA once on each rank (its featurization) and no other kernel
    (the steps score nothing)."""
    r0 = parts[0]
    got, want = r0["tp_losses"], r0["single_losses"]

    def rel(a, b):
        return abs(a - b) / abs(b) if b else abs(a)
    vs = {"g_loss_rel": rel(got[0], want[0]),
          "d_loss_rel": max(rel(got[k], want[k]) for k in (1, 2)),
          **r0["state"]}
    launches = [p["launches"] for p in parts]
    res = {"vs_single": vs, "losses": {"single": want, "tp": got},
           "launches_per_rank": launches,
           "collectives_checked_steps": r0["collectives"],
           "times": {f"rank{p['rank']}": p["times"] for p in parts}}
    print(f"tp, model axis {TP_MODEL} over {len(parts)} gloo ranks on one "
          f"card, one G and one D step against the single rank: {vs}; bars "
          f"F32_LOSS_BAR {F32_LOSS_BAR} (G), F32_UPDATE_BAR {F32_UPDATE_BAR}"
          f" (D losses, update); step times and collectives a step: "
          f"{json.dumps(res['times'])}")
    if not (vs["g_loss_rel"] <= F32_LOSS_BAR
            and vs["d_loss_rel"] <= F32_UPDATE_BAR
            and vs["update_rel"] <= F32_UPDATE_BAR
            and all(p["tp_losses"] == got for p in parts)
            and all(n["imcra_scan"] == 1 and sum(n.values()) == 1
                    for n in launches)):
        raise AssertionError(f"tp against the single rank: {res}")
    return res


def step_collective_ms(rec: dict) -> dict:
    """Per epoch record: all-reduces per G step and per D step, and their
    milliseconds (host clock, the device synchronised around each)."""
    c = rec["collectives"]
    g = c.get("all_reduce:gen", [0, 0.0])
    d = [sum(c.get(k, [0, 0.0])[i] for k in ("all_reduce:d",
                                               "all_reduce:dq"))
         for i in (0, 1)]
    return {"g_steps": rec["g_steps"], "d_steps": rec["d_steps"],
            "g_all_reduces": g[0], "d_all_reduces": d[0],
            "g_all_reduce_ms": 1e3 * g[1] / max(rec["g_steps"], 1),
            "d_all_reduce_ms": 1e3 * d[1] / max(rec["d_steps"], 1),
            "gather_ms": 1e3 * sum(v[1] for k, v in c.items()
                                   if k.startswith("all_gather")),
            "gathers": sum(v[0] for k, v in c.items()
                           if k.startswith("all_gather"))}


# the CLI with torch's check for operations that have no deterministic
# implementation on, warning and not raising, its Trainer's initial state
# kept in the run's init.pt: argv as the CLI's own
DETERMINISM_PROBE = (
    "import os, runpy, torch; "
    "from chip_smoke import install_generator_guard, keep_initial_state; "
    "install_generator_guard(os.environ['NELE_GUARD_FILE']); "
    "keep_initial_state(os.path.dirname(os.environ['NELE_GUARD_FILE'])); "
    "torch.use_deterministic_algorithms(True, warn_only=True); "
    "runpy.run_module('nelegan_tpu_torch.cli.train', run_name='__main__')")


def cli_checkpoint(run: str) -> tuple:
    """(state, key, epoch, replay json, extra) of a CLI run's checkpoint."""
    template = gan.init_train_state(Config(), 0, "cpu")
    return checkpoint.load_checkpoint_full(f"{run}/chkpt", template)


def cli_world_of_one(tmp: str, corpus: str, device: str = "cuda") -> dict:
    """`cli/train --data-parallel` under `torch.distributed.run
    --standalone --nproc-per-node 1` (NCCL) and the same CLI without it,
    one after the other, one epoch of the trainer phase's small corpus
    (its batch, samples, validation and metrics; the CLI's model is full
    width) on `device`: log.txt, the checkpoint's state, key, replay and
    history bit for bit.  A world of one trains single-device, as the
    reference package does on one device: no collective runs in it.
    Then the fault of ROADMAP section 3 (side by side, such runs once
    differed, from the host's draw of the initial state): two runs of the
    plain CLI side by side under torch's deterministic-algorithms check
    (warn only), gated bit for bit (`cli_side_by_side`), with the
    operations torch names as having no deterministic implementation
    (reported).  Last,
    the recovery of a world (`cli_world_recovery`), against the world of
    one's run resumed by hand."""
    def args(run, epochs=1):
        return ["--train-clean", f"{corpus}/Train/Clean",
                "--train-noise", f"{corpus}/Train/Noise",
                "--test-clean", f"{corpus}/Test/Clean",
                "--test-noise", f"{corpus}/Test/Noise",
                "--epochs", str(epochs), "--batch-size", "4",
                "--num-sampling", "8",
                "--num-valid", str(TRAINER_SMALL_TEST),
                "--metrics", ",".join(TRAINER_SMALL_METRICS),
                "--device", device, "--output", f"{run}/output",
                "--checkpoints", f"{run}/chkpt", "--log-file",
                f"{run}/log.txt"]
    dp, plain = f"{tmp}/cli_dp", f"{tmp}/cli_plain"
    script = Path(tmp, "guarded_cli.py")
    script.write_text(GUARDED_CLI)
    cmds = {"dp": (dp, [sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "1",
                        str(script), "--data-parallel", *args(dp)]),
            "plain": (plain, [sys.executable, str(script), *args(plain)])}
    seconds, guards = {}, {}
    for k, (run, cmd) in cmds.items():
        os.makedirs(run, exist_ok=True)
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=600, env=guarded_env(run))
        seconds[k] = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"cli/train ({k}) exited {out.returncode}:"
                                 f"\n{(out.stdout + out.stderr)[-4000:]}")
        guards[k] = guard_summary(guard_records(
            read_guard(run), gate=f"cli/train ({k})"))
    (sa, ka, ea, ra, xa), (sb, kb, eb, rb, xb) = (cli_checkpoint(dp),
                                                  cli_checkpoint(plain))
    with open(f"{dp}/log.txt") as f, open(f"{plain}/log.txt") as g:
        log_equal = f.read() == g.read()
    return {"log": log_equal, "state": states_equal(sa, sb),
            "key": torch.equal(ka.get_state(), kb.get_state()),
            "epoch": ea == eb == 1,
            "replay": ra.replace(dp, "") == rb.replace(plain, ""),
            "history": xa["history"] == xb["history"],
            "history_max_diff": max(
                (abs(a - b) for m in xb["history"]
                 for a, b in zip(xa["history"][m], xb["history"][m])),
                default=0.0),
            "seconds": seconds, "generator_guard": guards,
            "side_by_side": cli_side_by_side(tmp, args),
            "recovery": cli_world_recovery(tmp, args, dp, script)}


# the CLI as torchrun's entry script for the recovery of a world: on the
# first attempt the process raises at the start of epoch NELE_FAULT_EPOCH,
# once `latest` names the epoch before it (the checkpoint is published in
# the background while the next epoch runs); at exit every attempt prints
# its kernel launches (counted from 0 just before the CLI starts) and its
# start and end on the host clock
RECOVERY_CLI = """
import atexit, json, os, runpy, time
start = time.time()
from chip_smoke import install_generator_guard
from nelegan_tpu_torch import kernels
from nelegan_tpu_torch.train import loop, resilience
attempt = resilience.restart_count()
install_generator_guard("%s.%d" % (os.environ["NELE_GUARD_FILE"], attempt))
fault = int(os.environ["NELE_FAULT_EPOCH"])
run_epoch = loop.Trainer.run_epoch
def faulty(self, epoch):
    if attempt == 0 and epoch == fault:
        latest = os.path.join(self.paths.checkpoints, "latest")
        want = "chkpt_%d.ptstate" % (epoch - 1)
        deadline = time.monotonic() + 300
        while not (os.path.lexists(latest) and os.readlink(latest) == want):
            if time.monotonic() > deadline:
                raise TimeoutError("%s never named %s" % (latest, want))
            time.sleep(0.02)
        raise RuntimeError("injected fault at epoch %d" % epoch)
    return run_epoch(self, epoch)
loop.Trainer.run_epoch = faulty
def record():
    print("attempt " + json.dumps({"attempt": attempt, "start": start,
                                   "end": time.time(),
                                   "launches": dict(kernels.launches)}),
          flush=True)
atexit.register(record)
kernels.reset_launches()
runpy.run_module("nelegan_tpu_torch.cli.train", run_name="__main__")
"""
ATTEMPT_LINE = re.compile(r"attempt (\{.*\})$", re.MULTILINE)
RESUMED_LINE = re.compile(
    r"\[recovery\] attempt (\d+): resumed at epoch (\d+)")


def torchrun_cli(entry: list, args: list, restarts: int = 0,
                 env: dict = None) -> tuple:
    """The CLI in a torchrun world of one (`--standalone`, a free port)
    -> (its output, seconds); raises when it fails."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "--max-restarts", str(restarts), *entry,
         "--data-parallel", *args], cwd=REPO, capture_output=True,
        text=True, timeout=600, env=env)
    seconds = time.perf_counter() - t0
    text = out.stdout + out.stderr
    if out.returncode != 0:
        raise AssertionError(f"torchrun {entry} exited {out.returncode}:"
                             f"\n{text[-4000:]}")
    return text, seconds


def cli_world_recovery(tmp: str, args, by_hand: str, guarded: Path) -> dict:
    """`cli/train --data-parallel --max-retries 1` under `torch.distributed
    .run --max-restarts 1`, a world of one over NCCL, RECOVERY_EPOCHS
    epochs, through RECOVERY_CLI (a fault at the start of FAULT_EPOCH of
    the first attempt), against the world `by_hand` (run to epoch
    FAULT_EPOCH - 1) resumed by hand with `--resume` to RECOVERY_EPOCHS:
    log.txt and the checkpoint's state, key, replay and history bit for
    bit; each attempt's launches and seconds, the agent's restart time
    (from the first attempt's exit to the second's first line).  Every
    run under the generator guard (`guarded`, GUARDED_CLI): the resumed
    runs start past epoch 1, so their guards hold points (a) and (b)."""
    _, by_hand_s = torchrun_cli(
        [str(guarded)], args(by_hand, RECOVERY_EPOCHS) + ["--resume"],
        env=guarded_env(by_hand))
    rec = f"{tmp}/cli_recovered"
    os.makedirs(rec)
    script = Path(rec, "recovery_cli.py")
    script.write_text(RECOVERY_CLI)
    env = dict(guarded_env(rec), NELE_FAULT_EPOCH=str(FAULT_EPOCH))
    text, world_s = torchrun_cli(
        [str(script)], args(rec, RECOVERY_EPOCHS) + ["--max-retries", "1"],
        restarts=1, env=env)
    attempts = sorted((json.loads(m) for m in ATTEMPT_LINE.findall(text)),
                      key=lambda a: a["attempt"])
    resumed = RESUMED_LINE.findall(text)
    # the fault waits for `latest` to name FAULT_EPOCH - 1, so the world
    # resumes at FAULT_EPOCH; the log says where it did
    if ("injected fault" not in text or [a["attempt"] for a in attempts]
            != [0, 1] or resumed != [("2", str(FAULT_EPOCH))]):
        raise AssertionError(f"world recovery: attempts {attempts}, "
                             f"resumed {resumed}:\n{text[-4000:]}")
    for a in attempts:
        if not (a["launches"]["imcra_scan"] > 0
                and a["launches"]["linrec"] > 0):
            raise AssertionError(f"world recovery: attempt {a['attempt']} "
                                 f"launched {a['launches']}")
    guards = guard_summary(guard_records(
        read_guard(by_hand) + read_guard(rec, 0) + read_guard(rec, 1),
        gate="world recovery"))
    (sa, ka, ea, ra, xa), (sb, kb, eb, rb, xb) = (cli_checkpoint(rec),
                                                  cli_checkpoint(by_hand))
    with open(f"{rec}/log.txt") as f, open(f"{by_hand}/log.txt") as g:
        log_equal = f.read() == g.read()
    return {"log": log_equal, "state": states_equal(sa, sb),
            "generator_guard": guards,
            "key": torch.equal(ka.get_state(), kb.get_state()),
            "epoch": ea == eb == RECOVERY_EPOCHS,
            "replay": ra.replace(rec, "") == rb.replace(by_hand, ""),
            "history": xa["history"] == xb["history"],
            "resumed_at": int(resumed[0][1]),
            "attempts": [{"attempt": a["attempt"],
                          "seconds": a["end"] - a["start"],
                          "launches": a["launches"]} for a in attempts],
            "restart_s": attempts[1]["start"] - attempts[0]["end"],
            "world_s": world_s, "by_hand_s": by_hand_s}


def cli_side_by_side(tmp: str, args) -> dict:
    """Two plain cli/train runs at once under DETERMINISM_PROBE, gated:
    their initial states (init.pt), checkpoints' state, key, replay and
    history bit-equal, and neither generator changed through epoch 1."""
    runs = [f"{tmp}/cli_pair{i}" for i in (0, 1)]
    t0 = time.perf_counter()
    procs = []
    try:
        for r in runs:
            os.makedirs(r, exist_ok=True)
            with open(f"{r}/console.txt", "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-W", "default", "-c",
                     DETERMINISM_PROBE, *args(r)], cwd=REPO, stdout=out,
                    stderr=subprocess.STDOUT, env=guarded_env(r)))
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    outs = []
    for r in runs:
        with open(f"{r}/console.txt") as f:
            outs.append(f.read())
    for code, o in zip(codes, outs):
        if code != 0:
            raise AssertionError(f"cli/train side by side exited {code}:"
                                 f"\n{o[-4000:]}")
    named = sorted({ln.split("UserWarning:", 1)[1].strip()[:200]
                    for o in outs for ln in o.splitlines()
                    if "UserWarning:" in ln and "determinis" in ln})
    (sa, ka, _, ra, xa), (sb, kb, _, rb, xb) = map(cli_checkpoint, runs)
    guards = guard_summary(guard_records(
        [r for run in runs for r in read_guard(run)],
        gate="cli/train side by side"))
    init, where = init_diffs(*runs)
    res = {"init": not init, "state": states_equal(sa, sb),
           "key": torch.equal(ka.get_state(), kb.get_state()),
           "replay": ra.replace(runs[0], "") == rb.replace(runs[1], ""),
           "history": xa["history"] == xb["history"]}
    print(f"cli/train side by side: {res}, init {init[:6]} {where}",
          flush=True)
    if not all(res.values()):
        raise AssertionError(f"cli/train side by side: the pair differs: "
                             f"{res}; initial tensors {init[:6]} {where}")
    return {**res, "generator_guard": guards,
            "nondeterministic_ops": named, "seconds": seconds}


def nccl_refusal(dev) -> dict:
    """NCCL with DP_WORLD ranks on the one card: whether it refused, in its
    own words (the last line of the error)."""
    t0 = time.perf_counter()
    try:
        launch.run(nccl_probe_rank, DP_WORLD, "nccl",
                   devices=[dev] * DP_WORLD, timeout=120)
        out = {"refused": False}
    except (RuntimeError, TimeoutError) as e:
        lines = [ln for ln in str(e).splitlines() if ln.strip()]
        out = {"refused": True, "message": lines[-1][:400]}
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------ fault hunt
# The fault of ROADMAP section 3: a CLI run's bits once changed while
# another process shared the card (one half of its gen.fc1.weight came out
# of torch's erfinv_, split over two threads, up to 1e-5 off; the draw is
# now float64 with no transcendental function in a threaded kernel:
# `models/draw.py`).  `python3 chip_smoke.py --fault-hunt N` runs the
# small corpus's CLI (cli_world_of_one's arguments) alone twice,
# beside a ballast process that holds all but a little of the card's
# memory, beside one that keeps the card busy, and N times in the failing
# form: a torchrun world of one over NCCL, the plain CLI and the NCCL probe
# at once.  Every run is held against the first lone run.
# the CLI as a script (torchrun runs a file or a module): it keeps the
# Trainer's initial state (init.pt) and fc1's re-draw, and at exit writes
# record.json (the process's threads, ATen CPU capability, thread pools,
# CPU affinity, cuDNN flags, peak reserved bytes, the re-draw, the
# environment variables that steer ATen, torch, CUDA and NCCL) into
# NELE_HUNT_DIR
HUNT_CLI = """
import atexit, json, os, runpy, torch
from chip_smoke import install_generator_guard, keep_initial_state
run = os.environ["NELE_HUNT_DIR"]
install_generator_guard(os.path.join(run, "generator_guard.json"))
redrawn = keep_initial_state(run, redraw=True)
def record():
    with open(os.path.join(run, "record.json"), "w") as f:
        json.dump({"threads": torch.get_num_threads(),
                   "capability": torch.backends.cpu.get_cpu_capability(),
                   "parallel_info": torch.__config__.parallel_info(),
                   "affinity": sorted(os.sched_getaffinity(0)),
                   "torch": torch.__version__, "redraw_fc1": redrawn,
                   "cudnn": [torch.backends.cudnn.deterministic,
                             torch.backends.cudnn.benchmark,
                             torch.backends.cudnn.allow_tf32],
                   "peak_reserved": torch.cuda.max_memory_reserved(),
                   "env": {k: v for k, v in os.environ.items() if k.startswith(
                       ("OMP", "MKL", "CUDA", "NCCL", "TORCH", "CUBLAS",
                        "CUDNN", "PYTORCH", "ATEN"))}}, f)
atexit.register(record)
runpy.run_module("nelegan_tpu_torch.cli.train", run_name="__main__")
"""


def keep_initial_state(run: str, redraw: bool = False) -> dict:
    """From now on every Trainer saves its initial state (G, D and D_Qua
    state dicts on the host) to `run`/init.pt right after its __init__;
    with `redraw`, the returned dict receives `redraw_fc1` of it."""
    init, redrawn = Trainer.__init__, {}

    def kept_init(self, *args, **kw):
        init(self, *args, **kw)
        torch.save({k: {n: t.detach().cpu() for n, t in getattr(
            self.state, k).state_dict().items()} for k in ("gen", "d", "dq")},
            os.path.join(run, "init.pt"))
        if redraw:
            redrawn.update(redraw_fc1(self.state.gen, self.cfg))
    Trainer.__init__ = kept_init
    return redrawn


def init_diffs(a: str, b: str) -> tuple:
    """Two runs' init.pt: (the tensors that differ, as `tensor_diffs`;
    where the elements of the first two differ)."""
    ia, ib = ({f"{m}.{k}": v for m in x for k, v in x[m].items()}
              for x in (torch.load(f"{r}/init.pt", weights_only=True)
                        for r in (a, b)))
    init = tensor_diffs(ia, ib)
    # a half, a run, or all; one sign, a range of values, some rows
    return init, {k: {**changed_elements(ia[k].reshape(-1),
                                         ib[k].reshape(-1)),
                      **element_pattern(ia[k], ib[k])}
                  for k, *_ in init[:2]}


def bytes_digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of a host tensor's bytes."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


def redraw_fc1(gen: Generator, cfg: Config) -> dict:
    """`gen.fc1.weight` drawn again for `cfg`'s seed, in two forms.
    "float32", the draw before it moved to float64, step by step from a
    fresh torch.Generator that first draws the conv weights as
    `Generator.reset_parameters` then did: torch's `xavier_uniform_` on
    float32 convs, then the inverse-CDF truncated normal on a float32
    tensor (`uniform_(lo, hi)`, `erfinv_`, `mul_`, `add_`, `clamp_`, as
    torch's `trunc_normal_` did up to its rejection form), each step's
    digest.  "float64", the draw since: `gan.init_train_state` on the CPU.
    Each form's digest and whether it equals `gen`'s fc1 weight; and
    torch's own `trunc_normal_` on float32 after the float32 convs, with
    whether its source is the inverse-CDF form."""
    want = gen.fc1.weight.detach().to("cpu", torch.float32)
    shape, fan_in = gen.fc1.weight.shape, gen.fc1.in_features
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    a, b = -2.0 * std, 2.0 * std
    out = {"trunc_normal_source_uses_erfinv":
           "erfinv_" in inspect.getsource(
               torch.nn.init._no_grad_trunc_normal_)}

    def cdf(x):
        return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0

    def convs():
        rng = torch.Generator().manual_seed(cfg.train.seed)
        for block, gain in zip(gen.convolutions, gen._gains):
            w = torch.empty(block[0].conv.weight.shape, dtype=torch.float32)
            torch.nn.init.xavier_uniform_(w, gain=gain, generator=rng)
        return rng

    rng = convs()
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, std=std, a=a, b=b, generator=rng)
    out["torch_trunc_normal_"] = {"digest": bytes_digest(t),
                                  "equals_state": torch.equal(t, want)}
    rng, steps = convs(), []
    t = torch.empty(shape, dtype=torch.float32)
    for name, op in (
            ("uniform_", lambda: t.uniform_(2 * cdf(a / std) - 1,
                                            2 * cdf(b / std) - 1,
                                            generator=rng)),
            ("erfinv_", t.erfinv_),
            ("mul_", lambda: t.mul_(std * math.sqrt(2.0))),
            ("add_", lambda: t.add_(0.0)),
            ("clamp_", lambda: t.clamp_(min=a, max=b))):
        op()
        steps.append((name, bytes_digest(t)))
    out["float32"] = {"steps": steps, "equals_state": torch.equal(t, want)}
    t = gan.init_train_state(cfg, cfg.train.seed, "cpu").gen.fc1.weight
    out["float64"] = {"digest": bytes_digest(t.detach()),
                      "equals_state": torch.equal(t, want)}
    return out


# argv: the bytes to leave free, and "hold" or "busy"; prints "held" once
# it holds its memory, then holds it (or multiplies matrices) until killed
HUNT_BALLAST = """
import sys, time, torch
keep = int(sys.argv[1])
free, _ = torch.cuda.mem_get_info()
x = torch.empty(max(free - keep, 0), dtype=torch.uint8, device="cuda")
a = torch.randn(8192, 8192, device="cuda") if sys.argv[2] == "busy" else None
torch.cuda.synchronize()
print("held", x.numel(), flush=True)
while True:
    if a is not None:
        b = a @ a
        torch.cuda.synchronize()
    else:
        time.sleep(1)
"""
SCORE_NAMES = ("siib", "haspi", "estoi", "pesq", "visqol")


def hunt_args(corpus: str, run: str) -> list:
    return ["--train-clean", f"{corpus}/Train/Clean",
            "--train-noise", f"{corpus}/Train/Noise",
            "--test-clean", f"{corpus}/Test/Clean",
            "--test-noise", f"{corpus}/Test/Noise",
            "--epochs", "1", "--batch-size", "4", "--num-sampling", "8",
            "--num-valid", str(TRAINER_SMALL_TEST),
            "--metrics", ",".join(TRAINER_SMALL_METRICS),
            "--device", "cuda", "--output", f"{run}/output",
            "--checkpoints", f"{run}/chkpt", "--log-file", f"{run}/log.txt"]


def hunt_start(corpus: str, run: str, dp: bool) -> subprocess.Popen:
    """HUNT_CLI on the small corpus into `run`: plain, or with `dp` under
    `torch.distributed.run --standalone --nproc-per-node 1` with
    --data-parallel (a world of one over NCCL)."""
    os.makedirs(run, exist_ok=True)
    script = Path(run, "hunt_cli.py")
    script.write_text(HUNT_CLI)
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", str(script), "--data-parallel"] if dp
           else [sys.executable, str(script)])
    path = os.pathsep.join(filter(None, (str(REPO),
                                         os.environ.get("PYTHONPATH"))))
    with open(f"{run}/console.txt", "w") as out:
        return subprocess.Popen(
            cmd + hunt_args(corpus, run), cwd=REPO, stdout=out,
            stderr=subprocess.STDOUT,
            env=dict(os.environ, NELE_HUNT_DIR=run, PYTHONPATH=path))


def hunt_wait(procs: dict) -> dict:
    """Each run's exit code and its record.json."""
    out = {}
    for run, p in procs.items():
        try:
            code = p.wait(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        with open(f"{run}/console.txt") as f:
            text = f.read()
        try:
            with open(f"{run}/record.json") as f:
                rec = json.load(f)
            guard = guard_summary(guard_records(read_guard(run)))
        except FileNotFoundError:
            rec = guard = None
        out[run] = {"code": code, "record": rec, "generator_guard": guard,
                    "tail": text[-600:] if code else ""}
    return out


def tensor_diffs(a: dict, b: dict) -> list:
    """(name, elements that differ, of how many, max |a - b|, max |a|) of
    each tensor of `a` that is not bit-equal to `b`'s."""
    out = []
    for k, x in a.items():
        y = b[k]
        if not torch.equal(x, y):
            d = (x.double() - y.double()).abs()
            out.append((k, int((x != y).sum()), x.numel(), float(d.max()),
                        float(x.double().abs().max())))
    return out


def element_pattern(old: torch.Tensor, new: torch.Tensor) -> dict:
    """Of two host tensors of one shape, where the differing elements lie:
    how many in each half of the flat tensor (one contiguous half: a split
    of an op in two), by the sign of the old value, the range of |old|
    over them and over the rest (a branch of a formula), and the rows
    (dim 0) and columns (dim 1) they touch."""
    x, y = old.double(), new.double()
    bad = (old.view(torch.uint8).reshape(*old.shape, -1)
           != new.view(torch.uint8).reshape(*new.shape, -1)).any(-1)
    flat, n = bad.reshape(-1), bad.numel()
    k = int(flat.sum())
    first, second = int(flat[:n // 2].sum()), int(flat[n // 2:].sum())
    ax = x.abs().reshape(-1)

    def span(mask):
        v = ax[mask]
        return [float(v.min()), float(v.max())] if v.numel() else []
    out = {"halves": [first, second],
           "contiguous_half": k == n // 2 and (first == k or second == k),
           "positive": int((x.reshape(-1)[flat] > 0).sum()),
           "negative": int((x.reshape(-1)[flat] < 0).sum()),
           "abs_range_changed": span(flat),
           "abs_range_unchanged": span(~flat),
           "max_abs_diff": float((x - y).abs().max())}
    if bad.dim() >= 2:
        out["rows"] = int(bad.reshape(bad.shape[0], -1).any(1).sum())
        out["cols"] = int(bad.reshape(bad.shape[0], bad.shape[1], -1)
                          .any(2).any(0).sum())
    return out


def hunt_diff(a: str, b: str) -> dict:
    """Run b against run a: the enhanced wavs byte for byte, each replay
    file's scores by metric, log.txt, history and the state (the names of
    the tensors that differ), the first difference of each named."""
    def wavs(run):
        root = f"{run}/output"
        return {os.path.relpath(p, root): p for p in sorted(glob.glob(
            f"{root}/**/*.wav", recursive=True))}
    wa, wb = wavs(a), wavs(b)
    differ = [k for k in wa if k not in wb
              or Path(wa[k]).read_bytes() != Path(wb[k]).read_bytes()]
    (sa, ka, _, ra, xa), (sb, kb, _, rb, xb) = map(cli_checkpoint, (a, b))
    fa, fb = _flat_tensors(sa), _flat_tensors(sb)
    init, where = init_diffs(a, b)
    # the first step of each form of fc1's re-draw whose digest differs
    redo_a, redo_b = (json.loads(Path(r, "record.json").read_text())
                      ["redraw_fc1"] for r in (a, b))
    redraw = {"float32": next((s[0] for s, t in zip(
        redo_a["float32"]["steps"], redo_b["float32"]["steps"]) if s != t),
        None)}
    for form in ("float64", "torch_trunc_normal_"):
        redraw[form] = redo_a[form] != redo_b[form]
    scores = []
    for ea, eb in zip(json.loads(ra), json.loads(rb)):
        for m, x, y in zip(SCORE_NAMES, ea["scores"], eb["scores"]):
            if x != y:
                scores.append((ea["name"], m, x, y))
    with open(f"{a}/log.txt") as f, open(f"{b}/log.txt") as g:
        log = f.read() == g.read()
    states = tensor_diffs(fa, fb)
    return {"equal": not (differ or scores or states or init) and log
            and xa["history"] == xb["history"]
            and torch.equal(ka.get_state(), kb.get_state()),
            "init_differs": init[:6], "init_elements": where,
            "redraw_first_step_differs": redraw,
            "wavs": len(wa),
            "wavs_differ": len(differ), "first_wavs": differ[:4],
            "scores_differ": len(scores), "first_scores": scores[:4],
            "log": log, "history": xa["history"] == xb["history"],
            "tensors_differ": len(states), "first_tensors": states[:6]}


def fault_hunt(rounds: int, seconds: float = None) -> dict:
    """Part of no phase: the experiments above; prints and returns each
    run against the first lone run.  Every run under the generator guard
    (HUNT_CLI): a run whose generator changed in epoch 1 is counted under
    "generator_changed" and its guard names the point, the tensor and the
    changed elements.  With `seconds`, no round starts after that many
    seconds from the start.  The output directories of a run that differs
    are copied under build/fault_hunt."""
    t_hunt = time.perf_counter()
    kernels.build()             # before the CLIs start: no build race
    BUILD.mkdir(parents=True, exist_ok=True)
    keep_dir = BUILD / "fault_hunt"
    res = {"runs": {}}
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        corpus = f"{tmp}/corpus"
        write_trainer_corpus(corpus, TRAINER_SMALL_TRAIN, TRAINER_SMALL_TEST,
                             seed=14)
        ref = f"{tmp}/alone0"

        def record(form, waits):
            for run, w in waits.items():
                name = os.path.basename(run)
                d = (hunt_diff(ref, run) if w["code"] == 0 and run != ref
                     else None)
                res["runs"][name] = {"form": form, **w, "vs_alone0": d}
                print(f"fault hunt: {name} ({form}): {res['runs'][name]}",
                      flush=True)
                if (d is not None and not d["equal"]) or (
                        w["generator_guard"] or {}).get("violations"):
                    # the wavs, logs and records; not the checkpoints
                    for r in (run, ref):
                        shutil.copytree(
                            r, keep_dir / os.path.basename(r),
                            dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns("chkpt", "*.pt"))

        for i in (0, 1):
            run = f"{tmp}/alone{i}"
            record("alone", hunt_wait({run: hunt_start(corpus, run, False)}))
        peak = res["runs"]["alone0"]["record"]["peak_reserved"]
        # the CLI's peak plus its context, and a little or much room
        for tag, keep, mode in (("tightest", peak + (1 << 29), "hold"),
                                ("tight", peak + (1 << 30), "hold"),
                                ("roomy", peak + (4 << 30), "hold"),
                                ("busy", 60 << 30, "busy")):
            ballast = subprocess.Popen(
                [sys.executable, "-c", HUNT_BALLAST, str(keep), mode],
                cwd=REPO, stdout=subprocess.PIPE, text=True)
            try:
                held = ballast.stdout.readline().split()
                free = torch.cuda.mem_get_info()[0]
                run = f"{tmp}/ballast_{tag}"
                waits = hunt_wait({run: hunt_start(corpus, run, False)})
                waits[run].update(ballast_bytes=int(held[1]) if held else 0,
                                  free_at_start=free)
                record(f"ballast {mode}", waits)
            finally:
                ballast.kill()
                ballast.wait()
        for i in range(rounds):
            if seconds and time.perf_counter() - t_hunt > seconds:
                break
            t_round = time.perf_counter()
            dp, plain = f"{tmp}/side{i}_dp", f"{tmp}/side{i}_plain"
            procs = {dp: hunt_start(corpus, dp, True),
                     plain: hunt_start(corpus, plain, False)}
            probe = nccl_refusal(torch.device("cuda"))
            waits = hunt_wait(procs)
            waits[dp]["probe_refused"] = probe["refused"]
            record("side by side", waits)
            d = (hunt_diff(dp, plain) if all(w["code"] == 0 for w in
                                             waits.values()) else None)
            res["runs"][f"side{i}_pair"] = {
                "form": "dp against plain", "diff": d,
                "seconds": time.perf_counter() - t_round}
            print(f"fault hunt: side{i} dp against plain: {d}", flush=True)
    forms = collections.defaultdict(lambda: [0, 0, 0, 0, 0])
    for r in res["runs"].values():
        d = r.get("vs_alone0", r.get("diff"))
        c = forms[r["form"]]
        c[0] += 1
        c[1] += d is not None and not d["equal"]
        c[2] += d is None and r.get("code", 0) != 0
        c[3] += bool((r.get("generator_guard") or {}).get("violations"))
        c[4] += d is not None and bool(d["init_differs"])
    res["counts"] = {k: dict(zip(("runs", "differ", "failed",
                                  "generator_changed", "init_differs"), v))
                     for k, v in forms.items()}
    res["seconds"] = time.perf_counter() - t_hunt
    return res


def dp_control(dev, corpus: str, run: str, single: dict) -> tuple:
    """The dp check's round-off control: a single-process Trainer on the
    card as the trainer phase's single run (deterministic cuDNN), from
    its initial state one float32 ulp up, its D on the single run's
    scores, DP_EPOCHS epochs; (the trainer, its seconds)."""
    t0 = time.perf_counter()
    cudnn = torch.backends.cudnn
    deterministic, cudnn.deterministic = cudnn.deterministic, True
    try:
        ctrl = SmokeTrainer(trainer_paths(corpus, run), trained_config(),
                            metric_set=SCORE_METRICS, device=dev,
                            targets=single["scored"])
        one_ulp_up(ctrl)
        ctrl.run(DP_EPOCHS)
    finally:
        cudnn.deterministic = deterministic
    return ctrl, time.perf_counter() - t0


def rescore_cpu_f64(trainer: Trainer, scored: dict, root: str) -> dict:
    """The CPU's float64 scores of the files behind `scored`'s keys (a
    run's `SmokeTrainer.scored` keys: each path with the run's directory
    `root` cut to "/", calibrated), through `trainer`'s indexes of the
    same corpus: calibrated files are training files, the others test
    files (`Trainer.validate`)."""
    out = {}
    for norm, index in ((True, trainer.train_index),
                        (False, trainer.test_index)):
        keys = [k for k in scored if k[1] == norm]
        if not keys:
            continue
        paths = [root + k[0][1:] if k[0].startswith("/output/") else k[0]
                 for k in keys]
        names = sorted(set().union(*(scored[k] for k in keys)))
        out.update(zip(keys, cpu_f64_scores(index, paths, norm, names,
                                            trainer.cfg.train.fs)))
    return out


def parallel_phase(dev, tmp: str, single: dict) -> dict:
    """Data parallelism over torch.distributed (`parallel/`), float32,
    TF32 off, deterministic cuDNN; every check raises.
    (a) Two ranks on the one card through `parallel.launch` over gloo
    (CUDA tensors staged through the host; NCCL, tried first, refuses two
    ranks on one device), the trainer phase's full-width Trainer for
    DP_EPOCHS epochs, its D on the single run's scores, against that
    phase's straight single-process run of the same epochs (`single`):
    the ranks' states bit-equal after every epoch (their digests), the
    names, replay paths and epoch-1 enhanced PCM16 within 1 LSB, the
    scores within SCORE_BARS of the CPU's float64 scores of the same files
    and within cross_run_bars of the single run's (the control: a single
    run one ulp away, `dp_control`), G's epoch loss within F32_LOSS_BAR, the D
    heads' epoch losses and the state within F32_UPDATE_BAR, epoch 2's
    pool misses at most the single run's, one all-reduce per optimizer
    step, IMCRA and linrec once per featurized shard and PESQ chunk on
    each rank, each rank's PESQ rows fewer than the single run's in every
    epoch (it scores its share of each chunk) and its linrec launches no
    more; a third epoch profiled for the busy shares, as the single run's.
    (b), first: the mesh's collectives over NCCL in a world of one
    (`nccl_world_of_one`), and `cli/train --data-parallel` in a torchrun
    world of one over NCCL against the CLI without it
    (`cli_world_of_one`)."""
    t_phase = time.perf_counter()
    kernels.build()             # built before the ranks start: no race
    nccl = nccl_refusal(dev)
    print(f"NCCL, {DP_WORLD} ranks on one card: {nccl}")
    nccl_one = nccl_world_of_one(dev)
    print(f"the mesh's collectives over NCCL, a world of one: {nccl_one}")
    cli = cli_world_of_one(tmp, f"{tmp}/trainer_small", dev.type)
    print(f"cli/train --data-parallel, a torchrun world of one (NCCL), "
          f"against the CLI without it: {cli}")
    if not all(cli[k] and cli["recovery"][k]
               for k in ("log", "state", "key", "epoch", "replay",
                         "history")):
        raise AssertionError(f"cli world of one or its recovery: {cli}")

    corpus = f"{tmp}/trainer_corpus"
    t0 = time.perf_counter()
    ranks = launch.run(
        dp_trainer_rank, DP_WORLD, "gloo",
        args=(trained_config(), corpus, f"{tmp}/dp", single["scored"]),
        devices=[dev] * DP_WORLD, timeout=600)
    world_s = time.perf_counter() - t0
    dp_guard = guard_summary(guard_records(
        [r["generator_guard"] for r in ranks], gate="dp ranks"))
    print(f"dp ranks, the generator through epoch 1 (replicate between "
          f"points a and b): {dp_guard}")
    tp = tp_check([r["tp"] for r in ranks])
    r0 = ranks[0]
    for r in ranks:             # IMCRA and linrec, every rank and epoch
        check_epoch_launches(types.SimpleNamespace(
            epochs=r["epochs"], metric_set=SCORE_METRICS),
            f"dp rank {r['rank']}")
    # each rank scores its share of the files: fewer PESQ rows than the
    # single run in every epoch, no more linrec launches
    share = {e["epoch"]: {"single": (e["calls"].get("pesq_rows", 0),
                                     e["launches"]["linrec"])}
             for e in single["epochs"]}
    for r in ranks:
        for rec in r["epochs"][:DP_EPOCHS]:
            share[rec["epoch"]][f"rank{r['rank']}"] = (
                rec["calls"].get("pesq_rows", 0), rec["launches"]["linrec"])
    print(f"PESQ rows and linrec launches by epoch, single run and ranks: "
          f"{share}")
    for by in share.values():
        rows, launches = by["single"]
        if any(k != "single" and not (0 < v[0] < rows and v[1] <= launches)
               for k, v in by.items()):
            raise AssertionError(f"dp: a rank did not score its share: "
                                 f"{share}")
    # the ranks' states bit-equal after every epoch
    digests = [[rec["digest"] for rec in r["epochs"]] for r in ranks]
    if any(d != digests[0] for d in digests) or len(digests[0]) != (
            DP_EPOCHS + 1):
        raise AssertionError(f"dp: the ranks' states differ: {digests}")
    if any(r["replay"] != r0["replay"] or r["history"] != r0["history"]
           for r in ranks):
        raise AssertionError("dp: the ranks' replay or history differ")
    # one all-reduce per optimizer step, every rank and epoch
    per_step = [[step_collective_ms(rec) for rec in r["epochs"]]
                for r in ranks]
    for rank in per_step:
        for c in rank:
            if (c["g_all_reduces"] != c["g_steps"]
                    or c["d_all_reduces"] != 2 * c["d_steps"]):
                raise AssertionError(f"dp: all-reduces per step: {c}")
    # against the single run after epoch 2: rank 0's checkpoint
    dp_state, _, epoch, replay_json, _ = checkpoint.load_checkpoint_full(
        f"{tmp}/dp/chkpt/chkpt_{DP_EPOCHS}.ptstate",
        copy.deepcopy(single["state"]))
    roots = [f"{tmp}/dp/", single["root"]]
    dp_replay = [ReplayEntry(**e) for e in json.loads(replay_json)]
    names = [r[:2] for r in replay_rows(dp_replay, roots)] == [
        r[:2] for r in replay_rows(single["replay"], roots)]
    if not names or epoch != DP_EPOCHS:
        raise AssertionError("dp: names or replay paths differ from the "
                             "single run")
    # the dp run's own scores of every file both runs scored (its D and
    # history took the single run's, as the card-vs-CPU check does):
    # against the CPU's float64 scores of the same files (SCORE_BARS), and
    # against the single run's scores of its own files (cross_run_bars of
    # a single run on the card one ulp away, the control)
    both = {k: v for k, v in r0["scored"].items() if k in single["scored"]}
    ctrl, ctrl_s = dp_control(dev, corpus, f"{tmp}/dp_ulp", single)
    scores = score_gap(r0["scored"], single["scored"], SCORE_METRICS)
    control = score_gap(ctrl.scored, single["scored"], SCORE_METRICS)
    cross_bars = cross_run_bars(control)
    t0 = time.perf_counter()
    same_file = score_gap(both, rescore_cpu_f64(ctrl, both, f"{tmp}/dp/"),
                          SCORE_METRICS)
    rescore_s = time.perf_counter() - t0
    lsb, files, differ = 0, 0, 0
    for f in sorted(glob.glob(f"{tmp}/dp/output/**/*@1.wav",
                              recursive=True)):
        rel = os.path.relpath(f, f"{tmp}/dp")
        a = read_wav(f)[0]
        b = read_wav(os.path.join(single["root"], rel))[0]
        if a.shape != b.shape:
            raise AssertionError(f"dp: {rel} has another length")
        d = np.abs(np.round((a - b) * 32768))
        lsb, differ = max(lsb, int(d.max())), differ + int((d > 0).sum())
        files += 1
    ep = {rec["epoch"]: rec for rec in r0["epochs"]}
    sp = {rec["epoch"]: rec for rec in single["epochs"]}

    def rel(a, b):
        return abs(a - b) / abs(b) if b else abs(a)
    vs_single = {
        "files_epoch1": files, "pcm16_lsb": lsb, "samples_off": differ,
        "scores": scores, "scores_vs_cpu_f64_same_files": same_file,
        "files_rescored": len(both), "one_ulp_control": control,
        "cross_run_bars": cross_bars,
        "seconds": {"control": ctrl_s, "rescore": rescore_s},
        "g_loss_rel": rel(ep[2]["g_loss"], sp[2]["g_loss"]),
        "d_epoch_loss_rel": max(rel(ep[e]["d_loss"][k], sp[e]["d_loss"][k])
                                for e in (1, 2) for k in (0, 1)),
        "state": state_errors(dp_state, single["state"], single["origin"])}
    misses = {}
    for pool in ("band_pool_misses", "clean_pool_misses"):
        d1 = ep[2]["telemetry"][pool] - ep[1]["telemetry"][pool]
        s1 = sp[2]["telemetry"][pool] - sp[1]["telemetry"][pool]
        misses[pool] = {"dp": d1, "single": s1}
    vs_single["epoch2_misses"] = misses
    print(f"dp, {DP_WORLD} gloo ranks on one card, against the single run "
          f"(epochs 1-{DP_EPOCHS}): {vs_single}; bars {SCORE_BARS} "
          f"(scores_vs_cpu_f64_same_files), cross_run_bars (scores), "
          f"F32_LOSS_BAR {F32_LOSS_BAR} (G), F32_UPDATE_BAR "
          f"{F32_UPDATE_BAR} (D losses, state)")
    if not (files > 0 and lsb <= 1
            and all(same_file[m] < SCORE_BARS[m] for m in same_file)
            and all(scores[m] <= cross_bars[m] for m in cross_bars)
            and vs_single["g_loss_rel"] <= F32_LOSS_BAR
            and vs_single["d_epoch_loss_rel"] <= F32_UPDATE_BAR
            and vs_single["state"]["update_rel"] <= F32_UPDATE_BAR
            and all(v["dp"] <= v["single"] for v in misses.values())):
        raise AssertionError(f"dp against the single run: {vs_single}")

    # per rank and single: seconds by phase, utterances/s, all-reduce ms
    timing = {"single": [{"epoch": r["epoch"], "epoch_seconds":
                          r["epoch_seconds"], "phases_s": r["phases_s"],
                          "utterances_per_s": r["utterances_per_s"]}
                         for r in single["epochs"]]}
    for r, steps in zip(ranks, per_step):
        timing[f"rank{r['rank']}"] = [
            {"epoch": rec["epoch"], "epoch_seconds": rec["epoch_seconds"],
             "phases_s": rec["phases_s"],
             "utterances_per_s": rec["utterances_per_s"],
             "launches": rec["launches"], "collectives": c}
            for rec, c in zip(r["epochs"], steps)]
        timing[f"rank{r['rank']}_busy_epoch{DP_EPOCHS + 1}"] = r["busy"]
    print(f"dp timing per rank and for the single run: "
          f"{json.dumps(timing)}")

    res = {"nccl_two_ranks_one_card": nccl, "nccl_world_of_one": nccl_one,
           "scoring_share": share, "world_seconds": world_s,
           "vs_single": vs_single, "timing": timing, "cli_world_of_one": cli,
           "tp": tp, "dp_generator_guard": dp_guard,
           "launches_per_rank": [{k: sum(rec["launches"][k]
                                         for rec in r["epochs"]
                                         if rec["epoch"] <= DP_EPOCHS)
                                  for k in kernels.launches}
                                 for r in ranks],
           "phase_s": time.perf_counter() - t_phase}
    print(f"parallel phase: {res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------------ eval phase
EVAL_UTTS, EVAL_BATCH, EVAL_CPU_UTTS = 64, 8, 8
EVAL_METRICS = ("siib", "haspi", "estoi", "pesq", "visqol")
# card against the CPU run of the same CLI, each mean (eval_reverb) or
# value (collect_norm) relative to the CPU's
EVAL_BARS = {"siib": 1e-3, "haspi": 1e-4, "estoi": 1e-4, "pesq": 1e-4,
             "visqol": 1e-4}
RIR_T60S = (0.3, 0.9)       # seconds: 4800 and 14400 taps at 16 kHz
RIR_FIELDS = {"White": 0.3, "Babble": 0.3, "Pink": 0.9, "Hum": 0.9}
FIR_BAR = 1e-6              # fir_filter in float64 against lfilter
ASL_ROWS = 16               # BASELINE.json config 2's batch
ASL_GOLDEN_BAR, ASL_F64_BAR = 1e-6, 1e-9
MMSE_BAR = 1e-5             # complex64 on the card against the CPU float64

# the CPU references of the eval phase, in a process of their own: argv
# as JSON (eval_reverb's, collect_norm's); prints one line
EVAL_CPU_REFERENCE = """
import json, sys, torch
torch.set_num_threads(2)
from nelegan_tpu_torch.cli import collect_norm, eval_reverb
reverb_argv, norm_argv = json.loads(sys.argv[1])
means = eval_reverb.main(reverb_argv)
acc = collect_norm.main(norm_argv)
print("CPU_REFERENCE " + json.dumps({
    "eval_reverb": means,
    "collect_norm": {m + "|" + c: v for (m, c), v in acc.items()}}))
"""


def synthetic_rir(t60: float, seed: int) -> np.ndarray:
    """A room impulse response of T60 `t60` seconds at 16 kHz: a
    direct-path peak of 0.9 at a seeded delay, then seeded Gaussian noise
    decaying by 60 dB over t60 (amplitude 0.05 at its start)."""
    rng = np.random.RandomState(seed)
    n = int(round(t60 * 16000))
    delay = int(rng.randint(16, 160))
    h = np.zeros(n)
    h[delay] = 0.9
    t = np.arange(n - delay - 1) / 16000.0
    h[delay + 1:] = 0.05 * rng.randn(t.size) * 10.0 ** (-3.0 * t / t60)
    return h


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b| (|a - b| where b is 0)."""
    return abs(a - b) / abs(b) if b else abs(a - b)


@contextlib.contextmanager
def timed_calls(targets):
    """Each (module, name) of `targets` wrapped for the block: its calls'
    (name, start, end) on the host clock, the device synchronised before
    the end is read."""
    spans, undo = [], []
    for module, name in targets:
        fn = getattr(module, name)

        def timed(*args, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            spans.append((_name, t0, time.perf_counter()))
            return out
        setattr(module, name, timed)
        undo.append((module, name, fn))
    try:
        yield spans
    finally:
        for module, name, fn in reversed(undo):
            setattr(module, name, fn)


def fir_checks(dev, signals: dict, rirs: dict) -> dict:
    """`fir_filter` on the card, each RIR over each signal, against
    `lfilter(rir, 1, x)` in float64 on the host: the largest error of each
    output relative to its largest |y|, in float64 (FIR_BAR) and, reported,
    in float32, the CLIs' dtype (its FFT of n + m points: Bluestein's
    round-off where n + m has a large prime factor); the float32 call's
    time."""
    from scipy.signal import lfilter
    out = {}
    for rname, h in rirs.items():
        for sname, x in signals.items():
            want = lfilter(h.astype(np.float64), [1.0],
                           x.astype(np.float64))
            errs = {}
            for dt in (torch.float64, torch.float32):
                got = fir_filter(torch.as_tensor(h, dtype=dt, device=dev),
                                 torch.as_tensor(x, dtype=dt, device=dev))
                errs[str(dt)[6:]] = float(np.abs(got.cpu().numpy() - want)
                                          .max() / np.abs(want).max())
            h32 = torch.as_tensor(h, dtype=torch.float32, device=dev)
            x32 = torch.as_tensor(x, dtype=torch.float32, device=dev)
            out[f"{rname} x {sname}"] = dict(
                errs, taps=h.size, samples=x.size,
                f32_ms=cuda_ms(lambda: fir_filter(h32, x32), calls=10))
    print(f"fir_filter on the card against lfilter (float64 on the host), "
          f"error over each output's largest |y|: {out}; bar FIR_BAR "
          f"{FIR_BAR} (float64)")
    if not all(r["float64"] <= FIR_BAR for r in out.values()):
        raise AssertionError(f"fir_filter against lfilter: {out}")
    return out


def reverb_argv(corpus: str, ckpt: str, rir_paths: list, utts: int,
                device: str) -> list:
    """cli/eval_reverb's argv: `utts` test utterances, batch EVAL_BATCH,
    EVAL_METRICS, NO_rev and each RIR."""
    return (["--test-clean", f"{corpus}/Test/Clean", "--test-noise",
             f"{corpus}/Test/Noise", "--checkpoint", ckpt, "--num-utts",
             str(utts), "--batch-size", str(EVAL_BATCH), "--metrics",
             ",".join(EVAL_METRICS), "--rir", "NO_rev"]
            + [a for p in rir_paths for a in ("--rir", p)]
            + ["--device", device])


def eval_reverb_card(argv: list) -> dict:
    """`cli/eval_reverb` with `argv` on the card through its own main;
    its launches (counted from just before to just after).  Per condition:
    seconds, utterances/s, and the time in enhancement (featurize_batch +
    enhance_batch) and in score_batch."""
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    with timed_calls(((pipeline, "featurize_batch"),
                      (pipeline, "enhance_batch"),
                      (eval_reverb, "score_batch"))) as spans:
        means = eval_reverb.main(argv)
    seconds = time.perf_counter() - t0
    launches = launch_delta(before)
    means = {os.path.basename(k): v for k, v in means.items()}
    # one score_batch call ends each condition
    conditions, start = {}, t0
    ends = [s for s in spans if s[0] == "score_batch"]
    for cond, (_, s0, s1) in zip(means, ends):
        enh = sum(b - a for n, a, b in spans
                  if n != "score_batch" and start <= a and b <= s0)
        conditions[cond] = {
            "seconds": s1 - start,
            "utterances_per_s": EVAL_UTTS / (s1 - start),
            "enhance_s": enh, "score_batch_s": s1 - s0,
            "enhance_share": enh / (s1 - start),
            "score_share": (s1 - s0) / (s1 - start)}
        start = s1
    batches = sum(1 for s in spans if s[0] == "featurize_batch")
    return {"means": means, "seconds": seconds, "conditions": conditions,
            "launches": launches, "featurized_batches": batches}


def collect_norm_card(argv: list, root: str) -> dict:
    """`cli/collect_norm` with `argv` over EVAL_UTTS utterances on the
    card through its own main, calibrated and then raw (--raw): each
    distribution, seconds."""
    out = {}
    for kind, extra in (("calibrated", []), ("raw", ["--raw"])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = collect_norm.main(argv + extra + [
            "--num", str(EVAL_UTTS), "--out", f"{root}/norm_{kind}",
            "--device", "cuda"])
        out[kind] = {f"{m}|{c}": v for (m, c), v in acc.items()}
        out[f"{kind}_s"] = time.perf_counter() - t0
    return out


def export_checks(dev, root: str, ckpt: str) -> dict:
    """`cli/export_torch` on the card and on the CPU, generator-only and
    full: every state dict bit-equal to the CPU export and to the
    checkpoint's tensors; the card's exported enhance-model in a fresh
    Generator on the card gives the PCM16 of the checkpoint's generator
    bit for bit on one serving batch (the eight requests of the 36864
    bucket, featurized once with the IMCRA kernel)."""
    blob = torch.load(checkpoint._resolve(ckpt), map_location="cpu",
                      weights_only=True)["state"]
    out = {}
    for kind, extra in (("gen_only", ["--generator-only"]), ("full", [])):
        got = {}
        for d in ("cuda", "cpu"):
            path = f"{root}/export_{kind}_{d}.pt"
            export_torch.main(["--checkpoint", ckpt, "--out", path,
                               "--device", d] + extra)
            got[d] = convert.reference_state_dicts(path)
        slots = ["gen"] + ([] if extra else ["d", "dq"])

        def same(a, b):
            return a.keys() == b.keys() and all(
                a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                for k in a)
        out[kind] = {
            "slots": sorted(got["cuda"]),
            "card_equals_cpu": sorted(got["cuda"]) == sorted(got["cpu"])
            and all(same(got["cuda"][k], got["cpu"][k]) for k in got["cpu"]),
            "equals_checkpoint": sorted(got["cuda"]) == sorted(slots)
            and all(same(got["cuda"][s], blob[s]) for s in slots)}
    reqs = [r for r in build_requests() if r[0].size > BUCKET - 4096]
    cp, lens = pipeline.reflect_pad_batch([r[0] for r in reqs], BUCKET)
    npd, _ = pipeline.reflect_pad_batch([r[1] for r in reqs], BUCKET)
    loaded = Generator.from_config(Config().model)
    loaded.load_state_dict(convert.load_reference_checkpoint(
        f"{root}/export_gen_only_cuda.pt"), strict=True)
    source, _, _ = checkpoint.load_generator(ckpt, None, dev)
    with torch.inference_mode():
        feats = pipeline.featurize_batch(cp, npd, lens, device=dev)
        pcm = [pipeline.pcm16_quantize_i16(pipeline.enhance_batch(
            g, feats, device=dev)[0]).cpu() for g in (loaded.to(dev).eval(),
                                                      source)]
    out["serving_batch"] = {"rows": len(reqs),
                            "pcm16_equal": torch.equal(*pcm)}
    print(f"export_torch on the card against the CPU and the checkpoint, "
          f"and the exported generator on a serving batch: {out}")
    if not (all(out[k]["card_equals_cpu"] and out[k]["equals_checkpoint"]
                for k in ("gen_only", "full"))
            and out["serving_batch"]["pcm16_equal"] and len(reqs) == 8):
        raise AssertionError(f"export_torch: {out}")
    return out


def asl_rows() -> np.ndarray:
    """[ASL_ROWS, 33536] float64: the golden utterance (row 0, as
    tests/goldens/asl_p56.npz holds it), then rows cut from it at seeded
    offsets (tiled round) and scaled by seeded gains in [0.05, 3]."""
    x = np.load(GOLDEN)["clean"]
    rng = np.random.RandomState(56)
    rows = [x] + [np.roll(x, -int(rng.randint(1, x.size)))
                  * float(rng.uniform(0.05, 3.0))
                  for _ in range(ASL_ROWS - 1)]
    return np.stack(rows)


def asl_checks(dev) -> dict:
    """P.56 (`pipeline.active_speech_level_batch`, `dsp/asl_p56.py`) on
    the card in float64 at BASELINE.json config 2's shape: the golden row
    against tests/goldens/asl_p56.npz (ASL_GOLDEN_BAR, all three values of
    `asl_p56_rows`), every row against the CPU's float64 (ASL_F64_BAR);
    utterances/s (host clock, rows already on the card), the device's busy
    share (torch.profiler) and the host bisection's share."""
    g = np.load(REPO / "tests" / "goldens" / "asl_p56.npz")
    rows = asl_rows()
    x = torch.from_numpy(rows).to(dev)
    got = pipeline.active_speech_level_batch(x, device=dev).cpu().numpy()
    want = pipeline.active_speech_level_batch(rows, device="cpu").numpy()
    three = asl_p56.asl_p56_rows(x[:1])
    golden = {k: rel_gap(float(v[0]), float(g[k][0]))
              for k, v in zip(("asl_msq", "actfact", "c0"), three)}
    golden["asl_msq_from_batch"] = rel_gap(float(got[0]) ** 2,
                                           float(g["asl_msq"][0]))
    cpu = float(np.max(np.abs(got - want) / np.abs(want)))
    ms = host_ms(lambda: pipeline.active_speech_level_batch(x, device=dev))
    bisect = asl_p56._bisect
    host = [0.0]

    def timed_bisect(*args):
        t0 = time.perf_counter()
        try:
            return bisect(*args)
        finally:
            host[0] += time.perf_counter() - t0
    asl_p56._bisect = timed_bisect
    try:
        ms_host = host_ms(lambda: pipeline.active_speech_level_batch(
            x, device=dev), reps=5)
        bisect_ms = 1e3 * host[0] / 5
    finally:
        asl_p56._bisect = bisect
    prof = profile_step(lambda: pipeline.active_speech_level_batch(
        x, device=dev), ms, reps=3, label="asl_p56_profile")
    out = {"shape": list(rows.shape), "golden_rel": golden,
           "cpu_f64_rel": cpu, "ms": ms,
           "utterances_per_s": ASL_ROWS / (ms / 1e3),
           "busy_share": prof["busy_share"],
           "device_ms": prof["device_ms_per_batch"],
           "device_ops": prof["device_ops_per_batch"],
           "bisection_ms": bisect_ms,
           "bisection_share": bisect_ms / ms_host,
           "top": prof["top"][:5]}
    print(f"P.56 on the card, [{ASL_ROWS}, {rows.shape[1]}] float64: "
          f"{out}; bars ASL_GOLDEN_BAR {ASL_GOLDEN_BAR}, ASL_F64_BAR "
          f"{ASL_F64_BAR}")
    if not (all(v <= ASL_GOLDEN_BAR for v in golden.values())
            and cpu <= ASL_F64_BAR and np.isfinite(got).all()):
        raise AssertionError(f"P.56: {out}")
    return out


def mmse_checks(dev) -> dict:
    """`mmse_lsa_enhance` whole on the golden utterance's noisy STFT
    (computed in float64 on the host), complex64 on the card against the
    CPU's float64: each element's error relative to its magnitude
    (MMSE_BAR); its time, its IMCRA launches, and the device operations
    a frame of its host loop."""
    g = np.load(GOLDEN)
    spec = stft(torch.from_numpy(g["clean"] + g["noise"]))      # [257, T]
    want = mmse.mmse_lsa_enhance(spec)
    x = spec.to(torch.complex64).to(dev)
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    got = mmse.mmse_lsa_enhance(x)
    torch.cuda.synchronize()
    launches = launch_delta(before)
    d = (got.cpu().to(want.dtype) - want).abs()
    mag = want.abs()
    rel = float((d[mag > 0] / mag[mag > 0]).max())
    frames = spec.shape[-1]
    ms = host_ms(lambda: mmse.mmse_lsa_enhance(x))
    prof = profile_step(lambda: mmse.mmse_lsa_enhance(x), ms, reps=3,
                        label="mmse_profile")
    out = {"shape": list(spec.shape), "rel_max": rel,
           "abs_over_largest": float(d.max() / mag.max()),
           "launches": launches, "ms": ms, "ms_per_frame": ms / frames,
           "device_ops_per_frame": prof["device_ops_per_batch"] / frames,
           "busy_share": prof["busy_share"], "top": prof["top"][:5]}
    print(f"mmse_lsa_enhance on the card (complex64) against the CPU "
          f"(float64): {out}; bar MMSE_BAR {MMSE_BAR}")
    if not (rel <= MMSE_BAR and launches["imcra_scan"] == 1
            and torch.isfinite(torch.view_as_real(got)).all()):
        raise AssertionError(f"mmse_lsa_enhance: {out}")
    return out


def eval_phase(dev, tmp: str) -> dict:
    """The entry points of evaluation and calibration on the card, each
    through its own main or function, float32 unless said, TF32 off,
    deterministic cuDNN; every check raises.  Inputs made here from
    seeds: tools/make_synth_corpus.py run as it is (seed 1234, EVAL_UTTS
    training and test utterances), synthetic RIRs of RIR_T60S (a direct
    path, a decaying tail), the seeded full-width checkpoint.
    (1) `fir_filter` against lfilter; (2) `cli/eval_reverb` (NO_rev and
    both RIRs, all five metrics; IMCRA once a batch and condition, linrec
    once a PESQ call), its first EVAL_CPU_UTTS utterances again on the
    card against the same CLI on the CPU (EVAL_BARS on each mean); (3)
    `cli/collect_norm` with --rir-dir (the clean name's field names the
    RIR: RIR_FIELDS), calibrated and raw: the calibrated values equal
    make_mappers_np of the raw ones, the mean of each distribution's first
    EVAL_CPU_UTTS raw values within EVAL_BARS of the CPU run's (each
    value's gap reported); (4) `cli/export_torch`
    (`export_checks`); (5) P.56 (`asl_checks`); (6) MMSE-LSA
    (`mmse_checks`).  The CPU references run in one process of their own
    (EVAL_CPU_REFERENCE), started once the timed eval_reverb run is over.
    Launch counts are zeroed at the phase's start and read at its end
    (the phase's own, "launches"); eval_reverb's main run has its own."""
    t_phase = time.perf_counter()
    root = f"{tmp}/eval"
    corpus = f"{root}/corpus"
    made = subprocess.run(
        [sys.executable, str(REPO / "tools" / "make_synth_corpus.py"),
         corpus, "--seed", "1234", "--n-train", str(EVAL_UTTS),
         "--n-test", str(EVAL_UTTS)], capture_output=True, text=True,
        timeout=600)
    if made.returncode != 0:
        raise AssertionError(f"make_synth_corpus: {made.stderr[-2000:]}")
    corpus_s = time.perf_counter() - t_phase
    rirs, rir_paths = {}, []
    for i, t60 in enumerate(RIR_T60S):
        path = f"{root}/rir_t60_{t60}.wav"
        write_wav_pcm16(path, synthetic_rir(t60, seed=60 + i))
        rirs[f"t60_{t60}"] = read_wav(path)[0]
        rir_paths.append(path)
    os.makedirs(f"{root}/rir_dir")
    for field, t60 in RIR_FIELDS.items():
        shutil.copy(f"{root}/rir_t60_{t60}.wav",
                    f"{root}/rir_dir/{field}.wav")
    ckpt = save_seeded_checkpoint(f"{root}/ckpt", Config(), dev)
    cudnn = torch.backends.cudnn
    deterministic, cudnn.deterministic = cudnn.deterministic, True
    norm_argv = ["--clean", f"{corpus}/Train/Clean", "--noise",
                 f"{corpus}/Train/Noise", "--enhanced",
                 f"{corpus}/Train/MultiEnh", "--rir-dir", f"{root}/rir_dir"]
    ref = None
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        first = sorted(get_filepaths(f"{corpus}/Test/Clean"))[0]
        fir = fir_checks(dev, {"golden": speech_signals()[0],
                               "test0": read_wav(first)[0]}, rirs)
        reverb = eval_reverb_card(reverb_argv(corpus, ckpt, rir_paths,
                                              EVAL_UTTS, "cuda"))
        # the CPU references, beside the card's remaining work
        norm_few = ["--num", str(EVAL_CPU_UTTS), "--out",
                    f"{root}/norm_cpu", "--raw", "--device", "cpu"]
        ref = subprocess.Popen(
            [sys.executable, "-c", EVAL_CPU_REFERENCE, json.dumps(
                [reverb_argv(corpus, ckpt, rir_paths, EVAL_CPU_UTTS, "cpu"),
                 norm_argv + norm_few])],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        few = eval_reverb.main(reverb_argv(corpus, ckpt, rir_paths,
                                           EVAL_CPU_UTTS, "cuda"))
        norm = collect_norm_card(norm_argv, root)
        exported = export_checks(dev, root, ckpt)
        asl = asl_checks(dev)
        mmse_res = mmse_checks(dev)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        text, _ = ref.communicate(timeout=900)
    finally:
        cudnn.deterministic = deterministic
        if ref is not None and ref.poll() is None:
            ref.kill()
            ref.wait()
    if ref.returncode != 0 or "CPU_REFERENCE " not in text:
        raise AssertionError(f"the CPU references exited {ref.returncode}:"
                             f"\n{text[-4000:]}")
    cpu = json.loads(text.rsplit("CPU_REFERENCE ", 1)[1])

    # (2) eval_reverb: launches of the main run, the card against the CPU
    la = reverb["launches"]
    want_launches = {name: 0 for name in la}
    want_launches["imcra_scan"] = reverb["featurized_batches"]
    want_launches["linrec"] = EVAL_UTTS * (len(rir_paths) + 1)
    if la != want_launches or reverb["featurized_batches"] == 0:
        raise AssertionError(f"eval_reverb launched {la}, expected "
                             f"{want_launches}")
    few, cpu_means = ({os.path.basename(k): v for k, v in x.items()}
                      for x in (few, cpu["eval_reverb"]))
    vs_cpu = {c: {m: rel_gap(few[c][m], v) for m, v in means.items()}
              for c, means in cpu_means.items()}
    reverb.update(first_utts_card=few, first_utts_cpu=cpu_means,
                  vs_cpu=vs_cpu)
    shown = {k: reverb[k] for k in ("means", "seconds", "conditions",
                                    "launches")}
    print(f"eval_reverb on the card, {EVAL_UTTS} utterances: "
          f"{json.dumps(shown)}; the first {EVAL_CPU_UTTS} against the "
          f"CPU, relative: {vs_cpu}; bars {EVAL_BARS}")
    if not (list(few) == list(cpu_means) and all(
            v[m] <= EVAL_BARS[m] for v in vs_cpu.values() for m in v)):
        raise AssertionError(f"eval_reverb card against CPU: {vs_cpu}")
    if not all(np.isfinite(v) for c in reverb["means"].values()
               for v in c.values()):
        raise AssertionError(f"eval_reverb: {reverb['means']}")

    # (3) collect_norm: calibrated = mappers(raw) on the card, raw vs CPU
    mappers = make_mappers_np()
    cal, raw = norm["calibrated"], norm["raw"]
    mapped = all(cal[k] == [float(mappers[k.split("|")[0]](r))
                            for r in raw[k]] for k in raw)
    # the bars of eval_reverb's means on each distribution's first values;
    # each value's own gap is reported: SIIB of a tiled utterance reads an
    # ill-conditioned KLT (metrics/siib.py), so one value can move 1e-3
    # between two float64 eigensolvers
    norm_cpu = {k: rel_gap(float(np.mean(raw[k][:len(v)])),
                           float(np.mean(v)))
                for k, v in cpu["collect_norm"].items()}
    norm_values = {k: max(rel_gap(a, b) for a, b in zip(raw[k], v))
                   for k, v in cpu["collect_norm"].items()}
    shapes = {k: len(v) for k, v in raw.items()}
    norm_res = {"distributions": sorted(raw), "values": shapes,
                "calibrated_is_mapped_raw": mapped,
                "first_vs_cpu": norm_cpu,
                "first_values_vs_cpu": norm_values,
                "seconds": {k: norm[f"{k}_s"]
                            for k in ("calibrated", "raw")},
                "scores_per_s": sum(shapes.values()) / norm["raw_s"],
                "means": {k: float(np.mean(v)) for k, v in raw.items()}}
    print(f"collect_norm on the card, {EVAL_UTTS} utterances: {norm_res}; "
          f"bars {EVAL_BARS}")
    conds = ("before", "after", "rev_before", "rev_after")
    if not (mapped and sorted(raw) == sorted(
            f"{m}|{c}" for m in ("estoi", "haspi", "siib") for c in conds)
            and set(shapes.values()) == {EVAL_UTTS}
            and sorted(norm_cpu) == sorted(raw)
            and all(norm_cpu[k] <= EVAL_BARS[k.split("|")[0]]
                    for k in norm_cpu)
            and all(np.isfinite(v).all() for v in raw.values())):
        raise AssertionError(f"collect_norm: {norm_res}")
    if not (launches["imcra_scan"] > 0 and launches["linrec"] > 0):
        raise AssertionError(f"eval phase launches {launches}")
    res = {"corpus_s": corpus_s, "fir_filter": fir, "eval_reverb": reverb,
           "collect_norm": norm_res, "export": exported, "asl_p56": asl,
           "mmse_lsa": mmse_res, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    print(f"eval phase: {res['phase_s']:.1f} s")
    return res


def report_phase(dev, tmp: str) -> dict:
    """`cli/train_report` for REPORT_EPOCHS epochs of one seed of `b8_f32`
    on the trainer phase's small corpus (its 8 training utterances all
    sampled, its 4 validated, the pre-enhanced copy scored), float32, TF32
    off, deterministic cuDNN; every check raises.  Launch counts zeroed
    just before the report and read just after: IMCRA and linrec must run.
    multiseed.json and MULTISEED.md are written; the untrained baseline
    is within SCORE_BARS of a fresh Trainer's `validate(epoch=0)` on the
    same config; a second call skips the recorded seed and launches
    nothing."""
    t_phase = time.perf_counter()
    cudnn = torch.backends.cudnn
    deterministic = cudnn.deterministic
    n_guards = len(GUARDS)
    corpus, work = f"{tmp}/trainer_small", f"{tmp}/report"
    argv = ["--seeds", str(REPORT_SEED), "--epochs", str(REPORT_EPOCHS),
            "--variants", "b8_f32", "--corpus", corpus,
            "--n-train", str(TRAINER_SMALL_TRAIN),
            "--n-valid", str(TRAINER_SMALL_TEST), "--work", work,
            "--out", f"{work}/out", "--device", dev.type]
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        results = train_report.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.launches)
        if not (launches["imcra_scan"] > 0 and launches["linrec"] > 0):
            raise AssertionError(f"report: launches {launches}")
        written = {f: os.path.getsize(f"{work}/out/{f}")
                   for f in ("multiseed.json", "MULTISEED.md")}
        (run,) = results["variants"]["b8_f32"]
        cfg = Config(train=dataclasses.replace(
            Config().train, gan_epochs=REPORT_EPOCHS,
            num_sampling=TRAINER_SMALL_TRAIN, num_valid=TRAINER_SMALL_TEST,
            batch_size=8, seed=REPORT_SEED))
        fresh = Trainer(trainer_paths(corpus, f"{work}/fresh"), cfg,
                        metric_set=SCORE_METRICS, device=dev)
        want = fresh.validate(epoch=0)
        baseline = {m: abs(run["baseline"][m] - want[m]) / max(abs(want[m]),
                                                                1.0)
                    for m in SCORE_METRICS}
        if not all(baseline[m] <= SCORE_BARS[m] for m in SCORE_METRICS):
            raise AssertionError(f"report: baseline against a fresh "
                                 f"trainer's validate(0): {baseline}")
        kernels.reset_launches()
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            again = train_report.main(argv)
        skipped = (f"[skip] b8_f32 seed {REPORT_SEED} (already recorded)"
                   in said.getvalue())
        if not (skipped and again == json.loads(json.dumps(results))
                and not any(kernels.launches.values())):
            raise AssertionError(f"report: a second call trained again: "
                                 f"{said.getvalue()[-2000:]}")
    finally:
        cudnn.deterministic = deterministic
    guarded = guard_summary(guard_records(GUARDS[n_guards:],
                                          gate="report phase"))
    res = {"seconds": seconds, "launches": launches, "written_bytes": written,
           "generator_guard": guarded,
           "baseline_rel_to_fresh": baseline, "skipped_recorded_seed": True,
           "s_per_epoch": run["s_per_epoch"], "timing": run["timing"],
           "best": run["best"], "baseline": run["baseline"],
           "device": run["device"],
           "phase_s": time.perf_counter() - t_phase}
    print(f"report phase: {res['phase_s']:.1f} s")
    return res


def sanitize_launches(dev) -> dict:
    """One launch of each kernel of the trainer's path at its shapes, the
    inputs from seeds: IMCRA on eight noise spectra of the 36864-sample
    bucket ([8, 145, 257], fresh and with its state kept) and on four of
    the 24576 bucket; linrec and linrec_bwd at PESQ's gain memory, [8,
    PESQ_FRAMES], one pole a row and y0.  -> the launches."""
    kernels.build()
    kernels.reset_launches()
    y2 = noise_power(dev, BUCKET, 3)
    imcra.imcra_psd(y2)
    imcra.imcra_scan(y2, keep_state=True)
    imcra.imcra_psd(noise_power(dev, 24576, 4)[:4].contiguous())
    gen = torch.Generator().manual_seed(5)
    b = torch.rand(8, PESQ_FRAMES, generator=gen).to(dev).requires_grad_()
    y = iir.linrec(torch.full((8,), 0.2, device=dev), b,
                   torch.ones(8, device=dev))
    y.backward(torch.randn(8, PESQ_FRAMES, generator=gen).to(dev))
    torch.cuda.synchronize()
    return dict(kernels.launches)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    disable_tf32()

    if sys.argv[1:2] == ["--fault-hunt"]:
        print(json.dumps({"fault_hunt": fault_hunt(
            int(sys.argv[2]), *map(float, sys.argv[3:4]))}))
        print(card)
        return
    if sys.argv[1:2] == ["--sanitize-launches"]:
        print(json.dumps({"sanitize_launches": sanitize_launches(dev)}))
        print(card)
        return

    secs = kernels.build()
    print(f"built {sorted(kernels.KERNELS)} in {secs:.2f} s")

    kernels.reset_launches()
    records = [imcra_phase(dev), cascade_phase(dev), *linrec_phase(dev)]
    fences = guard_checks(dev)
    print(f"kernels on fenced outputs: {fences}")
    if not all(r["equal_to_wrapper"] and not (r["inputs_changed"]
               or r["guard_bytes_changed"] or r["unwritten"])
               for r in fences.values()):
        raise AssertionError(f"a kernel wrote outside its outputs or left "
                             f"them unwritten: {fences}")
    checked = dict(kernels.launches)
    gradient = gradient_phase(dev)
    serving = serving_phase(dev)
    training = training_phase(dev)
    streamed = streaming_phase(dev)
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        inferred = infer_phase(dev, tmp)
        scored = scoring_phase(dev, tmp, inferred)
        install_generator_guard()   # every Trainer from here on
        trained = trainer_phase(dev, tmp)
        single = trained.pop("_single")
        mixed = mixed_precision_phase(dev, f"{tmp}/trainer_corpus", tmp,
                                      trained["epochs"])
        directed = direct_phase(dev)
        evaluated = eval_phase(dev, tmp)
        paralleled = parallel_phase(dev, tmp, single)
        reported = report_phase(dev, tmp)
    for rec in records:
        rec["launches"] = serving["launches"][rec["name"]]
        rec["training_launches"] = training["launches"][rec["name"]]
        rec["infer_launches"] = inferred["launches"][rec["name"]]
        rec["scoring_launches"] = scored["launches"][rec["name"]]
        rec["kernel_phase_launches"] = checked[rec["name"]]
        rec["gradient_launches"] = gradient["launches"][rec["name"]]
        rec["trainer_launches"] = trained["launches"][rec["name"]]
        rec["mixed_precision_launches"] = mixed["launches"][rec["name"]]
        rec["direct_launches"] = directed["launches"][rec["name"]]
        rec["parallel_launches_per_rank"] = [
            r[rec["name"]] for r in paralleled["launches_per_rank"]]
        rec["tp_launches_per_rank"] = [
            r[rec["name"]] for r in paralleled["tp"]["launches_per_rank"]]
        rec["recovery_launches"] = [
            a["launches"][rec["name"]]
            for a in paralleled["cli_world_of_one"]["recovery"]["attempts"]]
        rec["report_launches"] = reported["launches"][rec["name"]]
        rec["eval_launches"] = evaluated["launches"][rec["name"]]
    # linrec's path is scoring (PESQ's gain memory through cli/infer
    # --metrics), linrec_bwd's the direct step (PESQ's gradient)
    records[2]["launches"] = scored["launches"]["linrec"]
    records[3]["launches"] = directed["launches"]["linrec_bwd"]
    records[0]["training_featurized_batches"] = training["featurized_batches"]
    records[0]["streaming_steps"] = streamed["steps"]
    for rec in records:
        rec["streaming_launches"] = streamed["launches_all"][rec["name"]]
    records[0]["infer_batches_plus_mmse_calls"] = inferred["batches"] + 1
    records[0]["trainer_featurized_batches"] = trained["featurized_batches"]
    records[2]["trainer_pesq_chunks"] = trained["pesq_chunks"]
    print(json.dumps({"serving": {k: v for k, v in serving.items()
                                  if k not in ("launches", "profile")}}))
    print(json.dumps({"training": training}))
    print(json.dumps({"streaming": streamed}))
    print(json.dumps({"infer": inferred}))
    print(json.dumps({"scoring": scored}))
    print(json.dumps({"gradient": gradient}))
    print(json.dumps({"trainer": trained}))
    print(json.dumps({"mixed_precision": mixed}))
    print(json.dumps({"direct": directed}))
    print(json.dumps({"eval": evaluated}))
    print(json.dumps({"parallel": paralleled}))
    print(json.dumps({"report": reported}))
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
