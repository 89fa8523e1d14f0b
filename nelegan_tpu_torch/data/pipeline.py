"""Corpus indexing and bucketed batch loading.

Counterpart of `nelegan_tpu/data/pipeline.py`, batch for batch: the same
seed shuffles the same paths and batches (`random.Random`).  It replaces the
reference's batch-of-1 torch DataLoader (reference: dataloader.py:86-100):
utterances are grouped into length buckets, reflect-padded per utterance
(`pipeline.reflect_pad_batch`) and emitted as dense
[B, n_bucket + n_fft] float32 arrays for `pipeline.featurize_batch`.
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from nelegan_tpu_torch.data.wavio import read_wav_batch, wav_length
from nelegan_tpu_torch.pipeline import reflect_pad_batch


def get_filepaths(directory: str) -> List[str]:
    """All .wav paths under a tree (reference audio_util.py:402-419), by
    extension: the reference's substring match also took `x.wav.bak`."""
    out = []
    for root, _, files in os.walk(directory):
        for fn in files:
            if fn.endswith(".wav"):
                out.append(os.path.join(root, fn))
    return out


@dataclasses.dataclass
class UtteranceBatch:
    """One dense batch for the batched pipeline."""
    clean: np.ndarray     # [B, n + N_FFT] reflect-padded, zero tail
    noise: np.ndarray     # [B, n + N_FFT]
    lengths: np.ndarray   # [B] true sample counts
    names: List[str]      # wav basenames
    extra: Optional[np.ndarray] = None   # a third signal, e.g. pre-enhanced


class CorpusIndex:
    """File-name-keyed corpus: clean/<name>.wav paired with
    noise_dir/<name>.wav (the reference's convention,
    audio_util.py:120-147)."""

    def __init__(self, clean_paths: Sequence[str], noise_dir: str,
                 extra_dir: Optional[str] = None, fs: int = 16000):
        self.clean_paths = list(clean_paths)
        self.noise_dir = noise_dir
        self.extra_dir = extra_dir
        self.fs = fs
        self._lengths: Dict[str, int] = {}
        self._by_name: Dict[str, str] = {}
        for p in self.clean_paths:
            base = os.path.basename(p)
            if base in self._by_name:
                raise ValueError(
                    f"duplicate clean basename {base!r}: the corpus keys "
                    "files by name (reference convention), so basenames "
                    "must be unique across subdirectories")
            self._by_name[base] = p

    def clean_path_for(self, name: str) -> str:
        return self._by_name[name]

    def __len__(self):
        return len(self.clean_paths)

    def name(self, path: str) -> str:
        return os.path.basename(path)

    def noise_path(self, clean_path: str) -> str:
        return os.path.join(self.noise_dir, self.name(clean_path))

    def extra_path(self, clean_path: str) -> str:
        if self.extra_dir is None:
            raise ValueError("corpus has no extra_dir")
        return os.path.join(self.extra_dir, self.name(clean_path))

    def length(self, clean_path: str) -> int:
        if clean_path not in self._lengths:
            self._lengths[clean_path] = wav_length(clean_path)
        return self._lengths[clean_path]


def _bucket_len(n: int, quant: int = 4096) -> int:
    return -(-n // quant) * quant


class BucketedLoader:
    """Yields UtteranceBatches grouped by quantised length buckets."""

    def __init__(self, index: CorpusIndex, batch_size: int = 8,
                 shuffle: bool = True, seed: int = 666,
                 bucket_quant: int = 4096, with_extra: bool = False,
                 n_threads: int = 8):
        self.index = index
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        self.bucket_quant = bucket_quant
        self.with_extra = with_extra
        self.n_threads = n_threads

    def _batches(self, paths: Sequence[str]) -> List[List[str]]:
        buckets: Dict[int, List[str]] = {}
        for p in paths:
            b = _bucket_len(self.index.length(p), self.bucket_quant)
            buckets.setdefault(b, []).append(p)
        batches = []
        for _, plist in sorted(buckets.items()):
            for i in range(0, len(plist), self.batch_size):
                batches.append(plist[i:i + self.batch_size])
        if self.shuffle:
            self.rng.shuffle(batches)
        return batches

    def __call__(self, paths: Optional[Sequence[str]] = None
                 ) -> Iterator[UtteranceBatch]:
        paths = list(paths if paths is not None else self.index.clean_paths)
        if self.shuffle:
            self.rng.shuffle(paths)
        for group in self._batches(paths):
            yield self.load_group(group)

    def load_group(self, group: Sequence[str]) -> UtteranceBatch:
        blen = _bucket_len(max(self.index.length(p) for p in group),
                           self.bucket_quant)
        cw, cl, cr = read_wav_batch(group, blen, self.n_threads)
        nw, nl, nr = read_wav_batch([self.index.noise_path(p) for p in group],
                                    blen, self.n_threads)
        if not ((cr == self.index.fs).all() and (nr == self.index.fs).all()):
            raise ValueError(f"expected {self.index.fs} Hz wavs")
        lens = np.minimum(cl, nl)
        clean_p, lengths = reflect_pad_batch(
            [cw[i, :lens[i]] for i in range(len(group))], blen)
        noise_p, _ = reflect_pad_batch(
            [nw[i, :lens[i]] for i in range(len(group))], blen)
        extra = None
        if self.with_extra:
            ew, el, _ = read_wav_batch(
                [self.index.extra_path(p) for p in group], blen,
                self.n_threads)
            extra, _ = reflect_pad_batch(
                [ew[i, :min(el[i], lens[i])] for i in range(len(group))],
                blen)
        return UtteranceBatch(clean_p, noise_p, lengths,
                              [self.index.name(p) for p in group], extra)
