"""The multi-metric GAN training loop.

Counterpart of `nelegan_tpu/train/loop.py` (after the reference driver,
train_nele.py:110-429), phase for phase.  Per epoch:

  1. sample `num_sampling` training utterances;
  2. [epoch >= 2] generator updates, both discriminators frozen but
     power-iterating (train_nele.py:122-156);
  3. validation: enhance `num_valid` test utterances, write PCM16 wavs
     (the first 20 kept per epoch for listening, the rest under `temp`),
     score them with the true metrics, append log.txt and the
     learning-curve PNGs (train_nele.py:159-270);
  4. enhance the sampled utterances for discriminator training and write
     them to disk (the PCM16 round trip: D sees what a listener-side
     decoder would, train_nele.py:279-316);
  5. score them, and the pre-enhanced parallel corpus if there is one, with
     the calibrated metrics (train_nele.py:318-340);
  6. three discriminator passes: current, past replay/30 + current,
     current again (train_nele.py:342-426);
  7. checkpoint the complete state (weights, Adam, spectral-norm u/v, RNG
     streams, replay, history), resumable exactly.

Utterances run in bucketed batches of fixed width (ragged batches padded
by repetition, the padding carrying no loss).  On a CUDA device every
featurized batch is one IMCRA kernel launch and every PESQ chunk of the
scoring one `linrec` launch.  Clean/noise band rows, raw PCM16 rows and
enhanced band rows live on the device in a `CleanSidePool`, the
clean-side metric halves and the just-written PCM16 enhanced rows in a
second one; D passes run groups of `_D_SCAN_GROUPS` through
`gan.d_steps_scan` on rows gathered once a chunk.

`data_parallel=True` in a process group of more than one rank (torchrun,
`parallel.launch`) trains over a `parallel.Mesh`, as the reference package
does over its device mesh: every rank runs this loop from the same seeds,
enhances, featurizes, scores and steps only its rows of each batch, and
holds replicated pools and state (the steps' all-reduces, the pools'
all-gathers; the state is checked bit-equal across the ranks every
epoch).  Only rank 0 writes files (enhanced wavs, log.txt, the PNGs,
checkpoints), and every rank passes a barrier before any reads them.

What the reference package does only for XLA or its remote-device tunnel
is not here: the persistent compilation cache, its CPU mesh's barriers
(XLA's in-process rendezvous) and the RSS guard.  Nor are its two slower
forms, kept there as A/B knobs: the per-pass reads and featurization
without the device pools (``NELE_DEV_POOL=0``) and one pool lookup a D
group (``NELE_D_SCAN=0``), both slower on the card than the pooled,
chunked D passes (PERF.md §6).
"""
from __future__ import annotations

import dataclasses
import os
import random
import shutil
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nelegan_tpu_torch import metrics, pipeline
from nelegan_tpu_torch.config import Config, config_to_dict
from nelegan_tpu_torch.data.pipeline import (BucketedLoader, CorpusIndex,
                                             _bucket_len, get_filepaths)
from nelegan_tpu_torch.data.wavio import read_wav, write_wav_pcm16
from nelegan_tpu_torch.device import resolve_device
from nelegan_tpu_torch.metrics import ALL_METRICS
from nelegan_tpu_torch.metrics.clean_pool import CleanSidePool
from nelegan_tpu_torch.parallel.mesh import (Mesh, all_gather_rows,
                                             assert_replicated, make_mesh,
                                             replicate, shard_batch)
from nelegan_tpu_torch.train import gan
from nelegan_tpu_torch.train.checkpoint import (AsyncSaver,
                                                load_checkpoint_full)
from nelegan_tpu_torch.train.replay import ReplayBuffer, ReplayEntry
from nelegan_tpu_torch.utils.lru import LRUCache
from nelegan_tpu_torch.utils.profiling import StepTimer


@dataclasses.dataclass
class TrainPaths:
    train_clean: str
    train_noise: str
    test_clean: str
    test_noise: str
    train_enhanced: Optional[str] = None   # pre-enhanced (SSDRC) corpus
    output: str = "./output"
    checkpoints: str = "./chkpt"
    log_file: str = "./log.txt"


def data_parallel_mesh(dev: torch.device) -> Optional[Mesh]:
    """The mesh `Trainer(data_parallel=True)` trains over: one over the
    default process group when it has more than one rank; None (one
    device) with one rank, or with no group and at most one visible GPU.
    With no group and more GPUs it raises: the ranks are processes, which
    torchrun starts."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        return make_mesh(devices=[dev] * world) if world > 1 else None
    n = torch.cuda.device_count()
    if n > 1:
        raise RuntimeError(
            f"Trainer(data_parallel=True) sees {n} GPUs and no process "
            f"group: start one process a GPU with torchrun --nproc-per-node "
            f"{n} (python -m torch.distributed.run) running "
            f"nelegan_tpu_torch.cli.train --data-parallel")
    return None


def generator_from_jax_key(key) -> torch.Generator:
    """The `torch.Generator` a run resumed from a reference-package
    checkpoint carries on: seeded with the JAX key's two uint32 words as
    one 64-bit seed, ``(key[0] << 32) | key[1]``.  Neither package draws a
    number from this generator in the loop; it is saved with every
    checkpoint."""
    k = np.asarray(key, np.uint32).reshape(-1)
    return torch.Generator().manual_seed((int(k[0]) << 32) | int(k[1]))


class Trainer:
    def __init__(self, paths: TrainPaths, cfg: Config = Config(),
                 metric_set: Sequence[str] = ALL_METRICS,
                 valid_metric_set: Optional[Sequence[str]] = None,
                 data_parallel: bool = False, device=None):
        self.dev = resolve_device(device)
        self.mesh = data_parallel_mesh(self.dev) if data_parallel else None
        if self.mesh is not None and cfg.train.batch_size % self.mesh.world:
            raise ValueError(f"batch_size {cfg.train.batch_size} must be a "
                             f"multiple of the {self.mesh.world} ranks for "
                             f"data-parallel training")
        self.paths = paths
        self.metric_set = tuple(metric_set)
        self.valid_metric_set = tuple(valid_metric_set or metric_set)
        # head gating: with no quality metric scored, the quality
        # discriminator would train toward made-up 0.5 targets and distort
        # the generator loss; it is switched off instead
        self.qua_active = any(m in self.metric_set for m in
                              ("pesq", "visqol"))
        self.intel_active = any(m in self.metric_set for m in
                                ("siib", "haspi", "estoi"))
        # per-column gating within an active head: an unscored metric's D
        # column would otherwise chase 0.5 while G pushes it toward 1
        self._intel_cols = tuple(
            1 if m in self.metric_set else 0
            for m in ("siib", "haspi", "estoi"))
        self._qua_cols = tuple(
            1 if m in self.metric_set else 0 for m in ("pesq", "visqol"))
        if not self.qua_active:
            cfg = dataclasses.replace(
                cfg, train=dataclasses.replace(cfg.train, weight_qua=0.0))
        self.cfg = cfg
        # three random.Random streams, drawn in the reference package's
        # order: this one (the test shuffle below, the epoch samples and
        # the D-pass shuffles), the loader's and the replay buffer's
        self.rng = random.Random(cfg.train.seed)
        self.key = torch.Generator().manual_seed(cfg.train.seed)

        train_paths = sorted(get_filepaths(paths.train_clean))
        test_paths = sorted(get_filepaths(paths.test_clean))
        if not train_paths:
            raise FileNotFoundError(
                f"no .wav files under --train-clean {paths.train_clean}")
        if not test_paths:
            raise FileNotFoundError(
                f"no .wav files under --test-clean {paths.test_clean}")
        self.train_index = CorpusIndex(train_paths, paths.train_noise,
                                       extra_dir=paths.train_enhanced)
        # the reference shuffles the test list once (seed 666) before taking
        # the first num_valid utterances (train_nele.py:68,167)
        self.rng.shuffle(test_paths)
        self.test_index = CorpusIndex(test_paths, paths.test_noise)
        self.loader = BucketedLoader(self.train_index,
                                     batch_size=cfg.train.batch_size,
                                     seed=cfg.train.seed)
        self.state = gan.init_train_state(cfg, seed=cfg.train.seed,
                                          device=self.dev)
        if self.mesh is not None:
            self.state = replicate(self.mesh, self.state)
        self.replay = ReplayBuffer(cfg.train.seed)
        self.start_epoch = 1
        self.history: Dict[str, List[float]] = {m: [] for m in
                                                self.valid_metric_set}
        # per-epoch host counters (replay growth, pool hits, misses and
        # bytes), appended by run_epoch
        self.telemetry: List[Dict[str, int]] = []
        self.timer = StepTimer()
        # NELE_D_TIMING=1 accumulates D-pass section times here
        self.last_d_timing: Dict[str, float] = {}
        # band features per (utterance, bucket length), as host rows
        # across epochs (the reference re-featurized in every DataLoader
        # __getitem__, dataloader.py:30-42, IMCRA included)
        self._band_cache = LRUCache(max_entries=4096)
        # scores of the immutable pre-enhanced (SSDRC) corpus, once a file
        self._drc_score_cache: Dict[str, Dict[str, float]] = {}
        # host copies of wav samples by path: scoring re-reads the same
        # clean/noise files every epoch and the enhanced files it just wrote
        self._host_sig = LRUCache(max_entries=4096)
        # clean-side metric halves (SIIB KLT, HASPI clean ear, ESTOI), raw
        # clean/noise rows and the written PCM16 enhanced rows, per
        # utterance on the device: hits survive the per-epoch reshuffle
        self._clean_side_cache = CleanSidePool(max_rows_per_shape=768)
        # the checkpoint's disk write overlaps the next epoch; waited on
        # before resume and at the end of run()
        self._ckpt_saver = AsyncSaver()
        # device-resident training rows: raw PCM16 clean/noise ("raw-cn"),
        # clean/noise bands ("cn") keyed (name, bucket) and enhanced bands
        # ("eb") keyed (enhanced_path, bucket).  G batches and D passes
        # gather rows on the device instead of re-reading and
        # re-featurizing; D passes 2 and 3 repeat pass 1's data exactly.
        self._dev_bands = CleanSidePool(max_rows_per_shape=1024,
                                        max_bytes=768 << 20)
        # min(len(clean), len(noise)) per clean path, filled when raw rows
        # are pooled: pool hits read no wav header for their lengths
        self._pair_len: Dict[str, int] = {}

    def clear_caches(self) -> None:
        """Empty every cross-epoch cache, leaving the trainer as cold as a
        fresh one that resumed its state: both device pools, the band,
        signal and pre-enhanced score caches and the length map."""
        self._clean_side_cache.clear()
        self._dev_bands.clear()
        self._band_cache.clear()
        self._host_sig.clear()
        self._drc_score_cache.clear()
        self._pair_len.clear()

    @property
    def _writer(self) -> bool:
        """Whether this process writes the run's files: rank 0 of a mesh,
        or the one process."""
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self) -> None:
        """Every rank waits for the others (after rank 0's writes, before
        any reads them); nothing without a mesh."""
        if self.mesh is not None:
            self.mesh.barrier()

    def _local_rows(self, n: int) -> list:
        """Indices into a group of `n` paths, padded to the batch size by
        repeating the last, this rank's share of them (all of them without
        a mesh)."""
        bs = self.cfg.train.batch_size
        return self._my_share(list(range(n)) + [n - 1] * (bs - n))

    def _shard_rows(self, tree):
        """This rank's rows of a batch of arrays or tensors (the batch
        itself without a mesh)."""
        return tree if self.mesh is None else shard_batch(self.mesh, tree)

    def _maybe_shard(self, arrays: tuple, n_real: int) -> tuple:
        """Host arrays of a group of `n_real` rows padded to the batch size
        by repeating the trailing row, with the row_valid mask appended
        (1 for real rows, 0 for padding: no loss), this rank's rows of
        each (all of them without a mesh)."""
        bs = self.cfg.train.batch_size
        rv = (np.arange(bs) < n_real).astype(np.float32)
        return self._shard_rows(self._pad_batch_rows(arrays, bs) + (rv,)
                                if arrays else (rv,))

    def _my_share(self, items: list) -> list:
        """This rank's share of a list a batch long."""
        return (items if self.mesh is None
                else items[self.mesh.rows(len(items))])

    def _sync(self) -> None:
        """Wait for the device's queued work (the reference package's
        scalar-fetch barrier); nothing on the CPU."""
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # ------------------------------------------------------------------
    def resume(self, path: Optional[str] = None,
               truncate_log: bool = False):
        # settle any background save first, also one started by another
        # trainer on the same directory: reading `latest` while it flips
        # would resume one epoch early
        self._ckpt_saver.wait()
        self._barrier()             # rank 0's last save is on disk
        path = path or self.paths.checkpoints
        AsyncSaver.barrier(path)
        # the sidecar of the SAME file (not re-derived from `latest`)
        self.state, key, epoch, replay_json, extra = \
            load_checkpoint_full(path, self.state)
        self.key = (key if isinstance(key, torch.Generator)
                    else generator_from_jax_key(key))
        self.replay.load_state_dict(replay_json)
        self.start_epoch = epoch + 1
        # host-side state, so a resumed run continues the exact sampling
        # and replay streams and the learning curves

        def _setstate(rng, st):
            rng.setstate((st[0], tuple(st[1]), st[2]))

        if "rng_state" in extra:
            _setstate(self.rng, extra["rng_state"])
        if "replay_rng" in extra:
            _setstate(self.replay.rng, extra["replay_rng"])
        if "loader_rng" in extra:
            _setstate(self.loader.rng, extra["loader_rng"])
        if "history" in extra:
            self.history = {k: list(v)
                            for k, v in extra["history"].items()}
        if "telemetry" in extra:
            self.telemetry = list(extra["telemetry"])
        if "timing" in extra:
            # cumulative phase wall-clock survives a relaunch
            for k, (tot, cnt) in extra["timing"].items():
                self.timer._total[k] = float(tot)
                self.timer._count[k] = int(cnt)
        # recovery re-runs the epoch after the last checkpoint: drop the log
        # lines that epoch already wrote, so log.txt keeps one line an
        # epoch.  A manual resume from an older checkpoint keeps the later
        # lines unless asked (run_with_recovery asks).
        if (truncate_log and self._writer
                and os.path.exists(self.paths.log_file)):
            with open(self.paths.log_file) as f:
                kept = [ln for ln in f
                        if self._log_epoch(ln) < self.start_epoch]
            with open(self.paths.log_file, "w") as f:
                f.writelines(kept)

    @staticmethod
    def _log_epoch(line: str) -> int:
        try:
            return int(line.rsplit("EPOCH:", 1)[1].strip())
        except (IndexError, ValueError):
            return -1

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _enhance_group(self, index: CorpusIndex, group_paths, loader):
        """(names, int16 PCM rows [B, n], out_lens, (wavs, out_lens)) of
        one same-bucket group, as device tensors (no copy to the host).
        A ragged group is padded to the batch size by repetition and its
        padded rows dropped from `names`.  Under a mesh the rank enhances
        its rows; the PCM rows and lengths are the whole batch's
        (all-gathered), `wavs` and its lengths the rank's."""
        pooled = self._pooled_raw_signals(index, group_paths, loader)
        if pooled is not None:
            names = [index.name(p) for p in group_paths]
            clean, noise, lengths = pooled
        else:
            batch = loader.load_group(group_paths)
            names = batch.names
            clean, noise, lengths = self._shard_rows(self._pad_batch_rows(
                (batch.clean, batch.noise, batch.lengths),
                self.cfg.train.batch_size))
        feats = pipeline.featurize_batch(clean, noise, lengths,
                                         self.cfg.train.p_power,
                                         self.cfg.imcra, device=self.dev)
        wavs, _, out_lens = pipeline.enhance_batch(
            self.state.gen, feats, self.cfg.train.p_power,
            self.cfg.train.target_rms, device=self.dev)
        # the int16 samples the files will hold (the quantizer replicates
        # the writer's clip and rounding)
        q = pipeline.pcm16_quantize_i16(wavs)
        q_all, lens_all = ((q, out_lens) if self.mesh is None else
                           all_gather_rows(self.mesh, (q, out_lens)))
        return names, q_all, lens_all, (wavs, out_lens)

    def _enhance_batches(self, index: CorpusIndex, paths: Sequence[str]):
        """Yield `_enhance_group` over the bucketed batches of `paths`, in
        the loader's unshuffled order.  Raw clean/noise rows come from the
        device pool when the corpus is PCM16."""
        loader = BucketedLoader(index, batch_size=self.cfg.train.batch_size,
                                shuffle=False)
        for group_paths in loader._batches(paths):
            yield self._enhance_group(index, group_paths, loader)

    def _write_enhanced(self, index: CorpusIndex, paths: Sequence[str],
                        out_dir: str, epoch: int,
                        keep_first: int = 10 ** 9,
                        alt_dir: Optional[str] = None,
                        pool_ebands: bool = False) -> List[str]:
        if self._writer:
            os.makedirs(out_dir, exist_ok=True)
            if alt_dir:
                os.makedirs(alt_dir, exist_ok=True)
        # pass 1: queue every batch on the device (no host copy)
        batches = []
        count = 0
        for names, q_dev, lens_dev, dev in self._enhance_batches(index,
                                                                 paths):
            batch_paths = []
            for name in names:
                base = f"{name[:-4]}@{epoch}{name[-4:]}"
                target = out_dir if count < keep_first else alt_dir
                batch_paths.append(os.path.join(target, base))
                count += 1
            batches.append((batch_paths, q_dev, lens_dev))
            if pool_ebands:
                # the written files' band rows, from the device wavs
                # (PCM16-quantized there, equal to the file's samples): D
                # pass 1 starts warm
                wavs_dev, lens_dev2 = dev
                bs, blen = q_dev.shape
                keys = [(p, blen) for p in batch_paths]
                keys += [keys[-1]] * (bs - len(keys))
                self._dev_bands.ensure(
                    ("eb", blen), keys,
                    lambda: gan.eband_from_enhanced(
                        wavs_dev, lens_dev2, self.cfg, device=self.dev),
                    self.mesh)
        if not batches:
            return []
        # pass 2: two device-to-host copies for the whole corpus (samples,
        # lengths), not two a batch
        flat = torch.cat([q.reshape(-1) for _, q, _ in batches]).cpu().numpy()
        lens = torch.cat([l for _, _, l in batches]).cpu().numpy()
        written = []
        off = loff = 0
        pool = self._clean_side_cache
        for batch_paths, q_dev, _ in batches:
            bs, blen = q_dev.shape
            wavs = flat[off:off + bs * blen].reshape(bs, blen)
            out_lens = lens[loff:loff + bs]
            off += bs * blen
            loff += bs
            for i, p in enumerate(batch_paths):
                if self._writer:
                    write_wav_pcm16(p, wavs[i, :out_lens[i]],
                                    self.cfg.train.fs)
                # score_for_d reads this file right back (the reference's
                # file round trip); int16/32768 is what read_wav returns
                self._host_sig[p] = (
                    wavs[i, :out_lens[i]].astype(np.float32) / 32768.0)
                written.append(p)
            # park the device's PCM16 rows in the scoring pool under the
            # signature score_corpus looks up ("raw-enh", its 16384-sample
            # bucket): the loader's 4096-quantised bucket nests inside it,
            # so one zero-pad a batch aligns the widths (an utterance less
            # than 256 samples past a multiple of 16384 comes back below
            # it, is scored in the bucket under, and misses, as in the
            # reference package); every rank has the whole batch's rows,
            # so each inserts them without a collective
            sq = -(-blen // 16384) * 16384
            keys = [(p,) for p in batch_paths]
            keys += [keys[-1]] * (bs - len(keys))
            pool.ensure(("raw-enh", sq), keys,
                        lambda: metrics.pad_rows_to(q_dev, sq))
        self._barrier()             # the files are on disk for every rank
        return written

    def _cached_read(self, path: str) -> np.ndarray:
        """read_wav through the host signal cache (files are immutable for
        the duration of a run, the reference's own contract)."""
        sig = self._host_sig.get(path)
        if sig is None:
            sig = read_wav(path)[0]
            self._host_sig[path] = sig
        return sig

    def _score_files(self, index: CorpusIndex, enhanced_paths: Sequence[str],
                     norm: bool, metrics: Sequence[str]
                     ) -> List[Dict[str, float]]:
        from nelegan_tpu_torch.metrics import score_corpus
        cleans, noises, enhs, keys = [], [], [], []
        for p in enhanced_paths:
            base = os.path.basename(p)
            name = base.split("@")[0] + ".wav" if "@" in base else base
            cpath = index.clean_path_for(name)
            keys.append(cpath)
            cleans.append(self._cached_read(cpath))
            noises.append(self._cached_read(
                os.path.join(index.noise_dir, name)))
            enhs.append(self._cached_read(p))
        return score_corpus(cleans, noises, enhs, self.cfg.train.fs,
                            norm=norm, metrics=metrics, mesh=self.mesh,
                            clean_cache=self._clean_side_cache,
                            clean_keys=keys,
                            enhanced_keys=list(enhanced_paths),
                            device=self.dev)

    # ------------------------------------------------------------------
    def _cached_bands(self, batch, rows: Sequence[int]) -> tuple:
        """(clean_band [R,T,64], noise_band, frames) of the batch's rows
        `rows` as host arrays, cached per (name, bucket length); one
        featurization (one IMCRA launch on the card) and one copy to the
        host per batch with misses, padded to the rank's share of the
        batch size."""
        blen = batch.clean.shape[1]
        missing = [i for i in sorted(set(rows))
                   if (batch.names[i], blen) not in self._band_cache]
        if missing:
            # the miss subset padded to the batch width: one shape a bucket
            width = self.cfg.train.batch_size // (
                1 if self.mesh is None else self.mesh.world)
            args = self._pad_batch_rows(
                (batch.clean[missing], batch.noise[missing],
                 batch.lengths[missing]), width)
            cb, nb, fr = gan.featurize_bands(*args, self.cfg,
                                             device=self.dev)
            cb, nb, fr = (t.cpu().numpy() for t in (cb, nb, fr))
            for j, i in enumerate(missing):
                self._band_cache[(batch.names[i], blen)] = (
                    cb[j], nb[j], fr[j])
        entries = [self._band_cache[(batch.names[i], blen)] for i in rows]
        return (np.stack([e[0] for e in entries]),
                np.stack([e[1] for e in entries]),
                np.stack([e[2] for e in entries]))

    @staticmethod
    def _pad_batch_rows(arrays, batch_size: int):
        """Pad ragged leading axes up to `batch_size` by repeating the last
        row, so every step of a bucket has one shape.  Padded rows carry
        zero loss weight (the row_valid masks of g_step_bands and d_step),
        so repetition does not reweight gradients."""
        b = arrays[0].shape[0]
        if b >= batch_size:
            return arrays
        return tuple(
            np.concatenate([np.asarray(a),
                            np.repeat(np.asarray(a)[-1:],
                                      batch_size - b, axis=0)], axis=0)
            for a in arrays)

    def _pooled_raw_signals(self, index: CorpusIndex,
                            group_paths: Sequence[str], loader):
        """Reflect-padded raw (clean, noise) rows of one same-bucket group,
        padded to the batch size, from the device pool as int16 PCM
        (`featurize_batch` decodes them on the device to the reader's
        values).  Only a group that round-trips PCM16 exactly is pooled; a
        float-valued group returns None and the caller reads it.  A miss
        reads, pads and uploads the group once; a hit touches neither the
        disk nor the host-to-device path.  Under a mesh: the rank's rows
        and lengths."""
        bs = self.cfg.train.batch_size
        blen = _bucket_len(max(index.length(p) for p in group_paths),
                           loader.bucket_quant)
        padded = list(group_paths) + \
            [group_paths[-1]] * (bs - len(group_paths))
        keys = [(p, blen) for p in padded]

        class _NotPCM16(Exception):
            pass

        def compute():
            batch = loader.load_group(group_paths)
            clean, noise, lengths = self._pad_batch_rows(
                (batch.clean, batch.noise, batch.lengths), bs)
            cs = np.asarray(clean, np.float32) * np.float32(32768.0)
            ns = np.asarray(noise, np.float32) * np.float32(32768.0)
            if not (((cs >= -32768) & (cs <= 32767)
                     & (cs == np.round(cs))).all()
                    and ((ns >= -32768) & (ns <= 32767)
                         & (ns == np.round(ns))).all()):
                raise _NotPCM16  # float-valued corpus: caller reads
            for p, ln in zip(padded, lengths):
                self._pair_len[p] = int(ln)
            cs, ns = self._shard_rows((cs, ns))
            return (torch.from_numpy(cs.astype(np.int16)).to(self.dev),
                    torch.from_numpy(ns.astype(np.int16)).to(self.dev))

        try:
            clean_i16, noise_i16 = self._dev_bands.ensure(
                ("raw-cn", blen), keys, compute, self.mesh)
        except _NotPCM16:
            return None
        if not all((p in self._pair_len) for p in padded):
            # pool rows without host lengths (a pool shared with another
            # trainer): read instead
            return None
        lengths = np.asarray([self._pair_len[p] for p in padded], np.int32)
        return clean_i16, noise_i16, self._shard_rows(lengths)

    def _cn_keys_compute(self, group_paths: Sequence[str]):
        """(sig, keys, compute) for a same-bucket clean/noise band group,
        padded to the batch size (compute: the rank's rows)."""
        bs = self.cfg.train.batch_size
        blen = _bucket_len(max(self.train_index.length(p)
                               for p in group_paths))
        padded = list(group_paths) + \
            [group_paths[-1]] * (bs - len(group_paths))
        keys = [(self.train_index.name(p), blen) for p in padded]

        def compute():
            batch = self.loader.load_group(group_paths)
            cb, nb, fr = self._cached_bands(
                batch, self._local_rows(len(group_paths)))
            return tuple(torch.from_numpy(a).to(self.dev)
                         for a in (cb, nb, fr))

        return ("cn", blen), keys, compute

    def _eb_keys_compute(self, group: Sequence[ReplayEntry], blen: int):
        """(sig, keys, compute) for one D group's enhanced-band rows
        (compute: the rank's rows)."""
        bs = self.cfg.train.batch_size
        padded = list(group) + [group[-1]] * (bs - len(group))
        keys = [(e.enhanced_path, blen) for e in padded]

        def compute():
            # trimmed to the clean bucket: a pre-enhanced (SSDRC) file can
            # be a few samples longer than its clean counterpart
            enhs = [self._cached_read(e.enhanced_path)[:blen]
                    for e in group]
            ep, _ = pipeline.reflect_pad_batch(enhs, blen)
            ep = self._shard_rows(self._pad_batch_rows((ep,), bs)[0])
            s = np.asarray(ep, np.float32) * np.float32(32768.0)
            if ((s >= -32768) & (s <= 32767) & (s == np.round(s))).all():
                # PCM16 rows (the written files): decoded on the device
                # as score_corpus decodes them
                dev = metrics.pcm16_to_float(
                    torch.from_numpy(s.astype(np.int16)).to(self.dev))
            else:
                dev = torch.from_numpy(ep).to(self.dev)
            return gan.speech_band(dev, self.cfg, device=self.dev)

        return ("eb", blen), keys, compute

    def _pooled_cn_bands(self, group_paths: Sequence[str]):
        """(clean_band, noise_band, frames) of a same-bucket path group,
        padded to the batch size, gathered from the device pool; misses
        load and featurize the group once (through the host band cache)."""
        sig, keys, compute = self._cn_keys_compute(group_paths)
        return self._dev_bands.ensure(sig, keys, compute, self.mesh)

    def _pooled_ebands(self, group: Sequence[ReplayEntry], blen: int):
        """Enhanced band rows of one D group, from the device pool: an
        enhanced file is immutable once written, so its bands serve the
        epoch's remaining passes and replay in later epochs."""
        sig, keys, compute = self._eb_keys_compute(group, blen)
        return self._dev_bands.ensure(sig, keys, compute, self.mesh)

    def train_generator_epoch(self, sampled: Sequence[str]) -> float:
        losses = []  # device scalars, copied to the host once
        # BucketedLoader.__call__'s RNG stream exactly (shuffle the paths,
        # then _batches shuffles the groups): pooled and unpooled runs
        # sample alike, and resume stays deterministic
        paths = list(sampled)
        if self.loader.shuffle:
            self.loader.rng.shuffle(paths)
        for group in self.loader._batches(paths):
            n_real = len(group)
            args = self._pooled_cn_bands(group)
            # padded rows repeat real ones for the shape, with no loss
            (mask,) = self._maybe_shard((), n_real)
            self.state, loss = gan.g_step_bands(
                self.state, *args, self.cfg,
                intel_cols=self._intel_cols, quality_cols=self._qua_cols,
                row_valid=mask, mesh=self.mesh)
            losses.append(loss)
        return (float(np.mean(torch.stack(losses).cpu().numpy()))
                if losses else 0.0)

    def validate(self, epoch: int) -> Dict[str, float]:
        n_valid = min(self.cfg.train.num_valid, len(self.test_index))
        valid_paths = self.test_index.clean_paths[:n_valid]
        ep_dir = os.path.join(self.paths.output, f"epoch{epoch}",
                              f"Test_epoch{epoch}")
        tmp_dir = os.path.join(self.paths.output, "temp")
        written = self._write_enhanced(self.test_index, valid_paths, ep_dir,
                                       epoch, keep_first=20, alt_dir=tmp_dir)
        scores = self._score_files(self.test_index, written, norm=False,
                                   metrics=self.valid_metric_set)
        means = {m: float(np.mean([s[m] for s in scores]))
                 for m in self.valid_metric_set}
        for m, v in means.items():
            self.history[m].append(v)
        if self._writer:
            self._log(epoch, means)
        return means

    def _log(self, epoch: int, means: Dict[str, float]):
        get = lambda m: means.get(m, 0.0)  # noqa: E731
        with open(self.paths.log_file, "a") as f:
            f.write("SIIB is %.3f, HASPI is %.3f, ESTOI is %.3f, "
                    "PESQ is %.3f, VISQOL is %.3f, EPOCH:%d \n"
                    % (get("siib"), get("haspi"), get("estoi"),
                       get("pesq"), get("visqol"), epoch))
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            for m, hist in self.history.items():
                if not hist:
                    continue
                fig = plt.figure(figsize=(6, 4))
                plt.plot(range(1, len(hist) + 1), hist)
                plt.xlabel("GAN_epoch")
                plt.ylabel(m.upper())
                plt.grid(True)
                # beside log.txt in the run's output dir, never the CWD
                plt.savefig(os.path.join(self.paths.output,
                                         f"Test_{m.upper()}.png"), dpi=100)
                plt.close(fig)
        except Exception:
            pass

    # same-bucket groups per `gan.d_steps_scan` call: a fixed count, so
    # every chunk of a bucket has one shape
    _D_SCAN_GROUPS = 8

    def train_discriminator_pass(self, entries: Sequence[ReplayEntry]):
        """One pass over a list of scored enhanced utterances, as the
        reference D dataset (dataloader.py:54-84): the enhanced wav read
        back from its PCM16 file and featurized, the clean/noise bands from
        the cross-epoch cache (the reference featurizes them at full
        length, so they are the same).  Entries are sorted by bucket and
        grouped by up to the batch size; chunks of _D_SCAN_GROUPS
        same-bucket groups run as one `gan.d_steps_scan` call on rows
        batch-gathered from the device pool, one gather a pool a chunk
        (`ensure_rows` resolves the rows without gathering and pins them
        until the chunk is dispatched).  Updates stay sequential in entry
        order.  Under a mesh each rank gathers and steps its rows of every
        group."""
        entries = list(entries)
        self.rng.shuffle(entries)
        bs = self.cfg.train.batch_size
        GC = self._D_SCAN_GROUPS
        # NELE_D_TIMING=1: per-section wall clock, each section closed by a
        # device synchronisation.  The barriers serialise dispatch, so the
        # sum over-reports an unbarriered pass: attribution only, off by
        # default.  Results accumulate in self.last_d_timing.
        timing = ({"steps": 0, "host_s": 0.0, "bands_s": 0.0,
                   "step_s": 0.0, "loss_fetch_s": 0.0}
                  if os.environ.get("NELE_D_TIMING") else None)

        def _bar():
            if timing is not None:
                self._sync()

        def blen(e):
            return _bucket_len(self.train_index.length(
                self.train_index.clean_path_for(e.name)))
        entries.sort(key=blen)

        # same-bucket groups of <= bs entries, in processing order
        groups = []
        i = 0
        while i < len(entries):
            group = [entries[i]]
            b = blen(entries[i])
            i += 1
            while (i < len(entries) and len(group) < bs
                   and blen(entries[i]) == b):
                group.append(entries[i])
                i += 1
            groups.append((b, group))

        losses_dev = []
        valid_counts = []
        gi = 0
        while gi < len(groups):
            _t0 = time.perf_counter() if timing is not None else 0.0
            b = groups[gi][0]
            chunk = []
            while (gi < len(groups) and groups[gi][0] == b
                   and len(chunk) < GC):
                chunk.append(groups[gi][1])
                gi += 1
            n_valid = len(chunk)
            tgs, tqs, rvs = [], [], []
            for group in chunk:
                tg = np.array([e.scores[:3] for e in group], np.float32)
                tq = np.array([e.scores[3:5] for e in group], np.float32)
                tg, tq, rv = self._maybe_shard((tg, tq), len(group))
                tgs.append(tg)
                tqs.append(tq)
                rvs.append(rv)
            for _ in range(GC - n_valid):     # shape-padding groups
                tgs.append(np.zeros_like(tgs[0]))
                tqs.append(np.zeros_like(tqs[0]))
                rvs.append(np.zeros_like(rvs[0]))
            if timing is not None:
                timing["host_s"] += time.perf_counter() - _t0
                _t0 = time.perf_counter()
            pinned_cn: set = set()
            pinned_eb: set = set()
            sig_cn = sig_eb = None
            cn_rows, eb_rows = [], []
            for group in chunk:
                cpaths = [self.train_index.clean_path_for(e.name)
                          for e in group]
                sig_cn, keys, compute = self._cn_keys_compute(cpaths)
                _, rows = self._dev_bands.ensure_rows(
                    sig_cn, keys, compute, pinned_cn, self.mesh)
                pinned_cn |= set(rows)
                cn_rows.append(self._my_share(rows))
                sig_eb, keys, compute = self._eb_keys_compute(group, b)
                _, rows = self._dev_bands.ensure_rows(
                    sig_eb, keys, compute, pinned_eb, self.mesh)
                pinned_eb |= set(rows)
                eb_rows.append(self._my_share(rows))
            for _ in range(GC - n_valid):     # shape-padding groups
                cn_rows.append([0] * len(cn_rows[0]))
                eb_rows.append([0] * len(eb_rows[0]))
            # one batched gather per pool for the whole chunk
            cb, nb, fr = self._dev_bands.gather_rows(
                sig_cn, [r for rows in cn_rows for r in rows])
            eb = self._dev_bands.gather_rows(
                sig_eb, [r for rows in eb_rows for r in rows])
            if timing is not None:
                timing["steps"] += n_valid
                _bar()
                timing["bands_s"] += time.perf_counter() - _t0
                _t0 = time.perf_counter()
            # group_valid stays a host array: padding groups are skipped
            # on the host, with no device sync
            self.state, lvals = gan.d_steps_scan(
                self.state, eb, cb, nb, fr, np.stack(tgs), np.stack(tqs),
                np.stack(rvs), np.arange(GC) < n_valid, self.cfg,
                update_intel=self.intel_active,
                update_quality=self.qua_active,
                intel_cols=self._intel_cols,
                quality_cols=self._qua_cols, mesh=self.mesh)
            if timing is not None:
                _bar()
                timing["step_s"] += time.perf_counter() - _t0
            losses_dev.append(lvals)
            valid_counts.append(n_valid)
        if not losses_dev:
            return []
        _t0 = time.perf_counter() if timing is not None else 0.0
        flat = torch.stack(losses_dev).cpu().numpy()       # one copy
        if timing is not None:
            timing["loss_fetch_s"] += time.perf_counter() - _t0
            for k, v in timing.items():
                self.last_d_timing[k] = round(
                    self.last_d_timing.get(k, 0) + v, 3)
        return [(float(flat[c, g, 0]), float(flat[c, g, 1]))
                for c, nv in enumerate(valid_counts) for g in range(nv)]

    # ------------------------------------------------------------------
    def run_epoch(self, epoch: int) -> Dict[str, float]:
        t0 = time.time()
        if self._writer:
            os.makedirs(self.paths.output, exist_ok=True)
        disc_dir = os.path.join(self.paths.output,
                                "For_discriminator_training")

        sampled = list(self.train_index.clean_paths)
        self.rng.shuffle(sampled)
        sampled = sampled[: self.cfg.train.num_sampling]

        g_loss = 0.0
        if epoch >= 2:
            with self.timer.phase("g_train"):
                g_loss = self.train_generator_epoch(sampled)

        with self.timer.phase("validate"):
            means = self.validate(epoch)

        # discriminator data generation + scoring
        with self.timer.phase("enhance_for_d"):
            written = self._write_enhanced(self.train_index, sampled,
                                           disc_dir, epoch,
                                           pool_ebands=True)
        with self.timer.phase("score_for_d"):
            gen_scores = self._score_files(self.train_index, written,
                                           norm=True,
                                           metrics=self.metric_set)
        order = list(ALL_METRICS)
        current = [ReplayEntry(p, os.path.basename(p).split("@")[0] + ".wav",
                               [s.get(m, 0.5) for m in order])
                   for p, s in zip(written, gen_scores)]

        if self.train_index.extra_dir:
            with self.timer.phase("score_drc"):
                extra_paths = [self.train_index.extra_path(p)
                               for p in sampled]
                # the pre-enhanced corpus is immutable and the metrics are
                # deterministic, so each file is scored once a run (the
                # reference rescores it every epoch, train_nele.py:318-340)
                missing = [p for p in extra_paths
                           if p not in self._drc_score_cache]
                if missing:
                    for p, s in zip(missing, self._score_files(
                            self.train_index, missing, norm=True,
                            metrics=self.metric_set)):
                        self._drc_score_cache[p] = s
                extra_scores = [self._drc_score_cache[p]
                                for p in extra_paths]
            current += [ReplayEntry(p, os.path.basename(p),
                                    [s.get(m, 0.5) for m in order])
                        for p, s in zip(extra_paths, extra_scores)]

        # three D passes: current / past + current / current
        with self.timer.phase("d_train"):
            self.train_discriminator_pass(current)
            past = self.replay.sample_fraction(
                self.cfg.train.replay_fraction)
            self.train_discriminator_pass(past + current)
            self.replay.extend(current)
            self.train_discriminator_pass(current)

        if self.mesh is not None:
            assert_replicated(self.mesh, self.state,
                              f"the train state after epoch {epoch}")
        # the complete end-of-epoch state (the reference saves only G/D
        # weights mid-epoch, train_nele.py:272-277; after the D passes,
        # resume is exact, replay included)
        with self.timer.phase("checkpoint"):
            if self._writer:
                self._ckpt_saver.save_async(
                    self.paths.checkpoints, epoch, self.state, self.key,
                    self.replay.state_dict(),
                    extra={"rng_state": list(self.rng.getstate()),
                           "replay_rng": list(self.replay.rng.getstate()),
                           "loader_rng": list(self.loader.rng.getstate()),
                           "history": self.history,
                           "telemetry": self.telemetry,
                           "timing": {k: [self.timer._total[k],
                                          self.timer._count[k]]
                                      for k in self.timer._total},
                           # the model's shape travels with the weights
                           "config": config_to_dict(self.cfg)},
                    keep_every=self.cfg.train.ckpt_keep_every,
                    keep_last=self.cfg.train.ckpt_keep_last)

        # long-run health: replay growth and the pools' hits, misses and
        # resident bytes, cumulative
        self.telemetry.append({
            "epoch": epoch,
            "replay_len": len(self.replay),
            "clean_pool_hits": self._clean_side_cache.hits,
            "clean_pool_misses": self._clean_side_cache.misses,
            "clean_pool_bytes": self._clean_side_cache.resident_bytes,
            "band_pool_hits": self._dev_bands.hits,
            "band_pool_misses": self._dev_bands.misses,
            "band_pool_bytes": self._dev_bands.resident_bytes,
        })

        tmp = os.path.join(self.paths.output, "temp")
        if self._writer and os.path.isdir(tmp):
            shutil.rmtree(tmp)
        means["g_loss"] = g_loss
        means["epoch_seconds"] = time.time() - t0
        return means

    def run(self, epochs: Optional[int] = None, verbose_timing: bool = False):
        end = (self.cfg.train.gan_epochs if epochs is None else epochs) + 1
        try:
            for epoch in range(self.start_epoch, end):
                before = dict(self.timer._total)
                means = self.run_epoch(epoch)
                if not self._writer:
                    continue
                print(f"Epoch {epoch} finished: "
                      + ", ".join(f"{k}={v:.4f}" for k, v in means.items()))
                if verbose_timing:
                    deltas = {k: self.timer._total[k] - before.get(k, 0.0)
                              for k in self.timer._total}
                    timed = sum(deltas.values())
                    print("  phases: " + " ".join(
                        f"{k}={v:.1f}s" for k, v in sorted(deltas.items()))
                        + f" | untimed={means['epoch_seconds'] - timed:.1f}s")
        finally:
            # the last epoch's background save is on disk before the
            # caller reads checkpoints (or the process exits)
            self._ckpt_saver.wait()
        self._barrier()           # for every rank
        if self._band_cache and self._writer:  # ran at least one epoch
            print(f"phase timing: {self.timer}")
