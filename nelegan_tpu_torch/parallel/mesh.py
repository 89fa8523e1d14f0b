"""Data parallelism over `torch.distributed`.

Counterpart of `nelegan_tpu/parallel/mesh.py`.  The reference package runs
one controller over a `jax.sharding.Mesh`: parameters replicated, batches
sharded on axis 0, collectives inserted by XLA.  PyTorch runs one process a
rank.  Every rank runs the same host logic from the same seeds (the same
files sampled in the same order), computes only its rows of each batch, and
calls the collectives itself:

  * `shard_batch` gives the rank its rows of axis 0, `all_gather_rows` the
    whole batch back (one all-gather for a whole tree of tensors);
  * `all_reduce_sum` sums a list of tensors over the ranks in one flat
    buffer: an optimizer step's gradients, with the loss's numerator and
    denominator, are one collective (`train/gan.py`);
  * `replicate` broadcasts rank 0's tensors (a `TrainState` with its Adam
    moments and spectral-norm u/v, a module, a tree), and
    `assert_replicated` checks that the ranks still hold the same bits.

The mesh has the reference's two axes, "data" and "model", and the model
axis has size 1: tensor parallelism of the discriminator trunk
(`model_parallel > 1`, `shard_params`) is not ported (see
`metrics.ROADMAP_ITEM`).  The reference package kept that axis for compile
coverage; its own measurement found a data x model mesh 1.22 times slower
than pure data parallelism at these widths (`tools/measure_tp.py`).

Under gloo with CUDA tensors every collective stages its buffer through the
host: gloo runs on the CPU.  A `Mesh` counts its collectives by tag, and
with `timed` also their seconds (host clock, the device synchronised before
and after each).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from nelegan_tpu_torch.device import resolve_device
from nelegan_tpu_torch.utils.tree import (inverse_perm, memory_order,
                                         tree_leaves, tree_map)

AXES = ("data", "model")


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a data-parallel world."""
    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None                 # None: the default process group
    axis_names: tuple = AXES          # the model axis has size 1
    timed: bool = False
    # tag -> [calls, seconds]; seconds only while `timed`
    stats: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(lambda: [0, 0.0]))

    def rows(self, n: int) -> slice:
        """This rank's rows of an axis of `n` rows."""
        if n % self.world:
            raise ValueError(f"{n} rows do not divide over {self.world} "
                             f"ranks: pad the batch to a multiple of the "
                             f"world size")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    @contextlib.contextmanager
    def collective(self, tag: str):
        """Count (and with `timed`, time) one collective under `tag`."""
        rec = self.stats[tag]
        rec[0] += 1
        if not self.timed:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        rec[1] += time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def count(self, prefix: str) -> int:
        """Collectives made so far whose tag starts with `prefix`."""
        return sum(n for tag, (n, _) in self.stats.items()
                   if tag.startswith(prefix))

    def barrier(self) -> None:
        with self.collective("barrier"):
            dist.barrier(group=self.group)

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"


def local_cuda_device(rank: int = 0) -> str:
    """This process's card: CUDA device LOCAL_RANK (torchrun's variable;
    without it, `rank`).  Raises when LOCAL_RANK names no visible GPU, so
    that ranks never share a card the user meant for one of them."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    n = torch.cuda.device_count()
    if n and local >= n:
        raise RuntimeError(f"LOCAL_RANK {local}, but {n} GPUs are visible: "
                           f"start at most {n} ranks a node, one a GPU")
    return f"cuda:{local}"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """The ("data", "model") mesh over the initialised default process
    group, one rank a device.  `devices` holds one device a rank (this rank
    takes `devices[rank]`); the default is CUDA device LOCAL_RANK
    (torchrun's variable; without it, the rank), which raises without a
    GPU.  `n_devices` must be the world size: a mesh spans the whole
    group."""
    if model_parallel != 1:
        from nelegan_tpu_torch.metrics import not_ported
        raise not_ported(f"a mesh with model_parallel={model_parallel} "
                         f"(tensor parallelism)")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised default process group: start "
            "one process a rank with torchrun (python -m "
            "torch.distributed.run) or nelegan_tpu_torch.parallel.launch")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{world} ranks; a mesh spans the whole group")
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = devices[rank]
    else:
        device = local_cuda_device(rank)
    dev = resolve_device(device)
    backend = dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    return Mesh(rank=rank, world=world, device=dev, backend=backend)


def shard_params(mesh: Mesh, params: Any) -> Any:
    """Tensor-parallel placement over the model axis: not ported."""
    from nelegan_tpu_torch.metrics import not_ported
    raise not_ported("shard_params (tensor parallelism over the mesh's "
                     "model axis)")


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """This rank's rows of axis 0 of every tensor and array leaf (a view),
    each leaf keeping its type and device; scalars pass as they are.  The
    row count must divide by the world size."""
    def take(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1:
            return x[mesh.rows(x.shape[0])]
        return x
    return tree_map(take, tree)


def _pack(tensors: Sequence[torch.Tensor], device) -> tuple:
    """(one flat uint8 buffer on `device` of every tensor's bytes, each in
    its memory order, each segment padded to 8 bytes so that it starts
    aligned for any dtype; per tensor (offset, bytes, memory order, dense
    shape in that order, dtype))."""
    segs, layout, off = [], [], 0
    for t in tensors:
        perm = memory_order(t)
        dense = t.detach().permute(perm).contiguous()
        b = dense.reshape(-1).view(torch.uint8).to(device)
        segs.append(b)
        pad = -b.numel() % 8
        if pad:
            segs.append(b.new_zeros(pad))
        layout.append((off, b.numel(), perm, tuple(dense.shape), t.dtype))
        off += b.numel() + pad
    return torch.cat(segs), layout


def all_gather_rows(mesh: Mesh, tree: Any) -> Any:
    """The inverse of `shard_batch`: every rank's rows of each tensor or
    array leaf, concatenated in rank order on axis 0, in one all-gather for
    the whole tree.  Every rank must pass the same structure, shapes and
    dtypes.  Each tensor leaf comes back in the memory order it had (a
    column-major leaf stays column-major), on its device; an array leaf
    comes back as an array."""
    leaves = [x for x in tree_leaves(tree)
              if isinstance(x, (torch.Tensor, np.ndarray))]
    if not leaves:
        return tree
    tensors = [torch.from_numpy(np.ascontiguousarray(x))
               if isinstance(x, np.ndarray) else x for x in leaves]
    if any(t.dim() == 0 for t in tensors):
        raise ValueError("all_gather_rows: a 0-d leaf has no rows")
    flat, layout = _pack(tensors, mesh.device)
    gathered = _all_gather_flat(mesh, flat, "all_gather")   # [world, n]
    out = {}
    for x, t, (off, n, perm, dshape, dtype) in zip(leaves, tensors, layout):
        # [world, *dense] -> the ranks' rows side by side on the row axis
        d0 = perm.index(0)
        seg = gathered[:, off:off + n].contiguous().view(dtype)
        full = seg.reshape((mesh.world,) + dshape).movedim(0, d0)
        shape = list(dshape)
        shape[d0] *= mesh.world
        full = full.reshape(shape).permute(inverse_perm(perm))
        out[id(x)] = (full.cpu().numpy() if isinstance(x, np.ndarray)
                      else full.to(t.device))
    return tree_map(lambda x: out.get(id(x), x), tree)


def _all_gather_flat(mesh: Mesh, flat: torch.Tensor, tag: str):
    """[world, n]: every rank's flat tensor `flat` (each of n elements)."""
    src = flat.cpu() if mesh._staged(flat) else flat
    out = src.new_empty((mesh.world,) + tuple(src.shape))
    with mesh.collective(tag):
        dist.all_gather(list(out.unbind(0)), src, group=mesh.group)
    return out.to(flat.device)


def all_reduce_sum(mesh: Mesh, tensors: Sequence[torch.Tensor],
                   tag: str = "all_reduce") -> list:
    """Each tensor summed over the ranks, in one all-reduce of one flat
    buffer (the tensors share a dtype and a device).  Returns views of the
    summed buffer, shaped as the inputs."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"all_reduce_sum: one dtype, not {dtypes}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    buf = flat.cpu() if mesh._staged(flat) else flat
    with mesh.collective(tag):
        dist.all_reduce(buf, group=mesh.group)
    flat = buf.to(flat.device)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def _state_of(tree):
    """(tensor and scalar tree, a function putting it back) of a
    `replicate` argument: a TrainState, module or optimizer by its
    state_dict, anything else as it is."""
    if hasattr(tree, "state_dict") and hasattr(tree, "load_state_dict"):
        def restore(sd):
            tree.load_state_dict(sd)
            return tree
        return tree.state_dict(), restore
    return tree, lambda t: t


def _signature(tree) -> list:
    """Per leaf of a tree: ("tensor", shape, dtype) for a tensor or array,
    ("value", v) for anything else.  Every rank must share the tensor
    entries before a broadcast; the values are taken from rank 0."""
    return [("tensor", tuple(x.shape), str(x.dtype))
            if isinstance(x, (torch.Tensor, np.ndarray)) else ("value", x)
            for x in tree_leaves(tree)]


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Rank 0's copy of `tree` on every rank.  Tensors are overwritten in
    place, all of them by one broadcast; arrays come back as new arrays;
    every other leaf (step counters, optimizer settings) is replaced by
    rank 0's.  A TrainState, module or optimizer is replicated through its
    state_dict, in place, its Adam moments, step counts and spectral-norm
    u and v with it.  A mismatch of the ranks' structures, shapes or
    dtypes raises."""
    state, restore = _state_of(tree)
    mine = _signature(state)
    theirs = [mine]
    with mesh.collective("broadcast"):
        dist.broadcast_object_list(theirs, src=0, group=mesh.group)
    theirs = theirs[0]
    if len(theirs) != len(mine) or any(
            a[0] != b[0] or (a[0] == "tensor" and a != b)
            for a, b in zip(mine, theirs)):
        raise RuntimeError("replicate: the ranks' states differ in "
                           "structure, shape or dtype")
    # arrays travel as CPU tensors over their own copies
    held = {id(x): (torch.from_numpy(np.array(x))
                    if isinstance(x, np.ndarray) else x)
            for x in tree_leaves(state)
            if isinstance(x, (torch.Tensor, np.ndarray))}
    if held:
        flat, layout = _pack(list(held.values()), mesh.device)
        buf = flat.cpu() if mesh._staged(flat) else flat
        with mesh.collective("broadcast"):
            dist.broadcast(buf, src=0, group=mesh.group)
        for t, (off, n, perm, dshape, dtype) in zip(held.values(), layout):
            src = buf[off:off + n].view(dtype).reshape(dshape)
            with torch.no_grad():
                t.copy_(src.permute(inverse_perm(perm)))
    it = iter(theirs)

    def put(x):
        kind, *rest = next(it)
        if kind == "value":
            return rest[0]
        t = held[id(x)]
        return t.numpy() if isinstance(x, np.ndarray) else x
    return restore(tree_map(put, state))


def replica_digest(tree: Any) -> torch.Tensor:
    """int64 [n]: one checksum a tensor leaf (its bytes weighted by odd
    position weights, summed modulo 2**64), one value an integer leaf, on
    the first tensor's device.  Equal trees give equal digests; a flipped
    bit changes its leaf's."""
    state, _ = _state_of(tree)
    out = []
    dev = None
    for x in tree_leaves(state):
        if isinstance(x, torch.Tensor):
            dev = dev or x.device
            b = x.detach().permute(memory_order(x)).contiguous().reshape(
                -1).view(torch.uint8)
            aligned = b.numel() % 4 == 0 and b.storage_offset() % 4 == 0
            w = (b.view(torch.int32) if aligned else b).to(torch.int64)
            pos = torch.arange(w.numel(), device=w.device, dtype=torch.int64)
            out.append(((2 * pos + 1) * w).sum())
        elif isinstance(x, (bool, int)):
            out.append(torch.tensor(int(x), dtype=torch.int64))
    dev = dev or torch.device("cpu")
    return torch.stack([o.to(dev) for o in out]) if out else \
        torch.zeros(0, dtype=torch.int64, device=dev)


def assert_replicated(mesh: Mesh, tree: Any, what: str = "state") -> None:
    """Raise unless every rank holds `tree` bit for bit (its
    `replica_digest`, all-gathered: one collective)."""
    d = replica_digest(tree).to(mesh.device)
    got = _all_gather_flat(mesh, d, "all_gather:digest")
    if not bool((got == got[:1]).all()):
        bad = sorted(set(torch.nonzero((got != got[:1]).any(0)).flatten()
                         .tolist()))
        raise RuntimeError(f"{what} differs between the ranks (leaves {bad} "
                           f"of {d.numel()}): the replicas diverged")
