"""Per-utterance device pool for the clean-side halves of the metrics.

Counterpart of `nelegan_tpu/metrics/clean_pool.py`.  `score_corpus` caches
the clean-side computations of SIIB (KLT basis), HASPI v2 (clean ear model
and envelope) and ESTOI (normalised segments).  A chunk-keyed mapping hits
only when a whole chunk repeats with the same composition: true for a fixed
validation corpus, never for the training loop's per-epoch shuffled sample,
whose utterances all repeat but in other groupings.

This pool keeps entries per utterance, in one device tensor per leaf and
shape signature, and rebuilds any chunk with one batched gather.  A miss
computes the whole chunk and writes its new rows in with one `index_copy_`
per leaf.  Capacity grows geometrically from the first chunk's size up to
`max_rows_per_shape` rows per signature and `max_bytes` over all of them;
at either bound the least recently used rows are evicted and their slots
reused.  `resident_bytes` reports the current total.

The reference package's arrays are immutable, so a dispatched program keeps
the pool it was given.  Here tensors are mutable, and the pool keeps that
guarantee itself: it grows by allocating a new tensor and copying into it
(a caller still holding the old one keeps its rows), it writes only rows
that no pending caller has pinned, and gathered chunks are copies
(`index_select`), not views.  Device work runs in stream order, so a write
queued after a gather does not change what the gather reads.  Each leaf is
kept in the memory order of the values first inserted (SIIB's KLT basis
comes from `eigh` column-major), and gathered in it, so that a hit hands
the metric the layout a miss does and both score alike bit for bit.

Values are tensors or tuples, lists and dicts of them, each leaf with the
chunk's rows on its leading axis.  Over a data-parallel `Mesh` the pool is
replicated on every rank (as the reference package's pool is over its
mesh): misses all-gather the ranks' rows, hits gather each rank's own.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Hashable, List, Sequence

import torch

from nelegan_tpu_torch.parallel.mesh import Mesh, all_gather_rows
from nelegan_tpu_torch.utils.lru import LRUCache
from nelegan_tpu_torch.utils.tree import (inverse_perm, memory_order,
                                         tree_leaves, tree_map)


def _zeros_like_layout(v: torch.Tensor, rows: int) -> torch.Tensor:
    """Zeros of v's shape with `rows` rows, dense in v's memory order."""
    perm = memory_order(v)
    shape = (rows,) + tuple(v.shape[1:])
    return v.new_zeros([shape[d] for d in perm]).permute(
        inverse_perm(perm))


def _take_rows(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """p's rows `idx` (a copy), in p's memory order."""
    perm = memory_order(p)
    return p.permute(perm).index_select(perm.index(0), idx).permute(
        inverse_perm(perm))


class CleanSidePool:
    """ensure(sig, keys, compute) -> stacked values for one scoring chunk.

    sig:  hashable shape signature (metric name and bucket dims); each sig
          gets its own pool tensors (leading capacity axis).
    keys: one hashable key per chunk row (utterance id and valid length).
    compute: () -> stacked tree [len(keys), ...] for a full recompute.
    """

    def __init__(self, max_rows_per_shape: int = 768,
                 max_bytes: int = 2 << 30):
        assert max_rows_per_shape > 0
        self.max_rows = max_rows_per_shape
        self.max_bytes = max_bytes
        self.resident_bytes = 0
        # chunks served wholly from the pool (one gather), and chunks that
        # ran compute()
        self.hits = 0
        self.misses = 0
        # small host-side values keyed per chunk or utterance (the SIIB
        # tiling decision), and the chunk-keyed form of the cache
        self.chunk_cache = LRUCache(max_entries=256)
        # sig -> {"pool": tree [cap, ...] | None, "cap": int, "row_bytes":
        #         int, "map": OrderedDict key -> row (LRU order), "next":
        #         int high-water mark}
        self._shapes: dict = {}

    def _state(self, sig: Hashable) -> dict:
        if sig not in self._shapes:
            self._shapes[sig] = {"pool": None, "cap": 0, "row_bytes": 0,
                                 "map": OrderedDict(), "next": 0}
        return self._shapes[sig]

    def _row_cap(self, st: dict, chunk_rows: int) -> int:
        """Rows this shape may occupy: the per-shape cap, shrunk when the
        byte budget is spent, but never below what is allocated or below
        one chunk (the pool must pin a whole chunk, with the rows a pending
        caller pinned: `ensure_rows` counts those in chunk_rows, so the cap
        is lifted rather than raising mid-epoch)."""
        rb = max(st["row_bytes"], 1)
        spare = max(self.max_bytes - self.resident_bytes, 0)
        budget_rows = st["cap"] + spare // rb
        return max(chunk_rows, st["cap"], min(self.max_rows, budget_rows))

    def _alloc_row(self, st: dict, pinned: set, row_cap: int) -> int:
        if st["next"] < row_cap:
            st["next"] += 1
            return st["next"] - 1
        for k in st["map"]:  # least to most recently used
            if st["map"][k] not in pinned:
                return st["map"].pop(k)
        raise RuntimeError(
            f"CleanSidePool: row cap {row_cap} all pinned by one chunk; "
            f"raise the bound above the chunk width")

    def _grow_to(self, st: dict, needed: int, proto, row_cap: int) -> None:
        """Geometric capacity growth, bounded by the row cap: new tensors,
        the old rows copied in (never a resize in place)."""
        cap = st["cap"]
        if needed <= cap:
            return
        new_cap = max(cap, 1)
        while new_cap < needed:
            new_cap *= 2
        new_cap = min(max(new_cap, needed), row_cap)

        def alloc(v, p=None):
            z = _zeros_like_layout(v if p is None else p, new_cap)
            if p is not None:
                z[:cap].copy_(p)
            return z

        if st["pool"] is None:
            st["pool"] = tree_map(alloc, proto)
        else:
            st["pool"] = tree_map(alloc, proto, st["pool"])
        st["cap"] = new_cap
        self.resident_bytes += (new_cap - cap) * st["row_bytes"]

    def _insert(self, st: dict, keys: Sequence[Hashable], vals, rows: list,
                pinned: set, extra_pins: int) -> None:
        """Rows for the keys not in the pool yet (first occurrence wins:
        padded rows repeat a key with equal values), then one index_copy_
        per leaf into those rows, none of them pinned."""
        if st["row_bytes"] == 0:
            st["row_bytes"] = sum(v.element_size() * v.numel()
                                  // max(v.shape[0], 1)
                                  for v in tree_leaves(vals))
        row_cap = self._row_cap(st, len(set(keys)) + extra_pins)
        pinned |= {r for r in rows if r is not None}
        first_j: dict = {}
        for j, k in enumerate(keys):
            first_j.setdefault(k, j)
        need = [k for k in first_j if k not in st["map"]]
        dest: List[int] = []
        for k in need:
            r = self._alloc_row(st, pinned, row_cap)
            st["map"][k] = r
            pinned.add(r)
            dest.append(r)
        for k in keys:
            st["map"].move_to_end(k)
        if dest:
            self._grow_to(st, max(dest) + 1, vals, row_cap)
            leaf = tree_leaves(vals)[0]
            didx = torch.as_tensor(dest, device=leaf.device)
            tidx = torch.as_tensor([first_j[k] for k in need],
                                   device=leaf.device)
            tree_map(lambda p, v: p.index_copy_(0, didx, v.index_select(
                0, tidx)), st["pool"], vals)

    def ensure(self, sig: Hashable, keys: Sequence[Hashable],
               compute: Callable[[], Any], mesh: Mesh | None = None) -> Any:
        """The chunk's values: one gather (a copy) when every key is in the
        pool, else compute() with its new rows inserted.

        With a `mesh` the pool is replicated on every rank and `keys` name
        the whole chunk, the same on every rank; the rank gets its rows of
        the chunk (`mesh.rows`).  On a miss compute() returns the rank's
        rows; they are all-gathered (one collective), and every rank
        inserts the whole chunk.  A hit gathers the rank's rows with no
        collective.  Every rank takes the same branch, so `hits` and
        `misses` read the same on every rank."""
        st = self._state(sig)
        rows = [st["map"].get(k) for k in keys]
        if st["pool"] is not None and all(r is not None for r in rows):
            for k in keys:                       # refresh the LRU order
                st["map"].move_to_end(k)
            self.hits += 1
            return self.gather_rows(
                sig, rows if mesh is None else rows[mesh.rows(len(rows))])
        self.misses += 1
        vals = compute()                         # stacked [B, ...] tree
        full = vals if mesh is None else all_gather_rows(mesh, vals)
        self._insert(st, keys, full, rows, set(), 0)
        return vals

    def ensure_rows(self, sig: Hashable, keys: Sequence[Hashable],
                    compute: Callable[[], Any],
                    pinned_rows: set | None = None,
                    mesh: Mesh | None = None):
        """Pool row indices for `keys` without gathering, computing and
        inserting missing rows first, for a caller that gathers the rows
        later itself.  `pinned_rows` are rows already resolved for the same
        pending work: this call's evictions spare them, and the row cap is
        lifted to fit them.  Returns (pool tree, row list); the returned
        pool holds every key's row.  With a `mesh`, as in `ensure`: compute()
        returns the rank's rows, and the row list covers every key (the
        caller takes its rank's share)."""
        st = self._state(sig)
        pinned = set(pinned_rows or ())
        rows = [st["map"].get(k) for k in keys]
        if st["pool"] is not None and all(r is not None for r in rows):
            for k in keys:
                st["map"].move_to_end(k)
            self.hits += 1
            return st["pool"], rows
        self.misses += 1
        vals = compute()
        if mesh is not None:
            vals = all_gather_rows(mesh, vals)
        self._insert(st, keys, vals, rows, pinned, len(pinned))
        return st["pool"], [st["map"][k] for k in keys]

    def gather_rows(self, sig: Hashable, rows: Sequence[int]):
        """The stacked tree of rows resolved by `ensure_rows`: one
        index_select (a copy) per leaf."""
        st = self._state(sig)
        leaf = tree_leaves(st["pool"])[0]
        idx = torch.as_tensor(list(rows), device=leaf.device)
        return tree_map(lambda p: _take_rows(p, idx), st["pool"])

    def __len__(self) -> int:
        return sum(len(st["map"]) for st in self._shapes.values())

    def clear(self) -> None:
        self._shapes.clear()
        self.chunk_cache.clear()
        self.resident_bytes = 0
