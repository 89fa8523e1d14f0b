"""Replay buffer for discriminator training.

The reference keeps a growing list of score-strings pointing at enhanced
wavs on disk and mixes 1/30 of the history into each epoch's D training
(reference: train_nele.py:100,372-403).  Same semantics here, structured:
entries are (enhanced_wav_path, clean_name, scores[5]) and the buffer can be
serialised into checkpoints (the reference never persisted it).

An own copy of `nelegan_tpu/train/replay.py` (no JAX there either): the
port imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import List, Sequence


@dataclasses.dataclass
class ReplayEntry:
    enhanced_path: str
    name: str           # clean/noise wav basename
    scores: List[float]  # (siib, haspi, estoi, pesq, visqol), calibrated


class ReplayBuffer:
    def __init__(self, seed: int = 666):
        self.entries: List[ReplayEntry] = []
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.entries)

    def extend(self, entries: Sequence[ReplayEntry]):
        self.entries.extend(entries)

    def sample_fraction(self, divisor: int = 30) -> List[ReplayEntry]:
        """The reference's `Previous[: len // 30]` after a shuffle
        (train_nele.py:373-375)."""
        pool = list(self.entries)
        self.rng.shuffle(pool)
        return pool[: len(pool) // divisor]

    def state_dict(self) -> str:
        return json.dumps([dataclasses.asdict(e) for e in self.entries])

    def load_state_dict(self, blob: str):
        self.entries = [ReplayEntry(**d) for d in json.loads(blob)]
