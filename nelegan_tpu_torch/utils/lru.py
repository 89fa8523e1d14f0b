"""Bounded LRU mapping for device-resident cache entries.

Counterpart of `nelegan_tpu/utils/lru.py`.  `score_corpus`'s chunk-keyed
clean cache holds per-chunk device tensors (SIIB KLT bases, HASPI clean-side
envelopes); keys of a shuffled training sample rarely repeat, so an
unbounded dict would hold device memory every epoch.  This cache evicts the
least recently used entry (dropping the last reference frees its tensors)
while the fixed-composition validation chunks stay and keep hitting.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable


class LRUCache:
    """Minimal dict-like LRU, usable as a `score_corpus` clean_cache."""

    def __init__(self, max_entries: int = 256):
        assert max_entries > 0
        self.max_entries = max_entries
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()

    def get(self, key: Hashable, default: Any = None) -> Any:
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return default

    def __getitem__(self, key: Hashable) -> Any:
        if key not in self._d:
            raise KeyError(key)
        return self.get(key)

    def __setitem__(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()
