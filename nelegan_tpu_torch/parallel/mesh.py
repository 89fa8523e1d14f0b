"""Data and tensor parallelism over `torch.distributed`.

Counterpart of `nelegan_tpu/parallel/mesh.py`.  The reference package runs
one controller over a `jax.sharding.Mesh` of two axes, "data" and
"model": batches shard on axis 0 over "data", and `shard_params` shards
the last (feature) axis of every parameter over "model" where it divides;
XLA inserts the collectives.  PyTorch runs one process a rank.  The ranks
form the same grid, `reshape(world // model_parallel, model_parallel)`:
a model group is `model_parallel` consecutive ranks, a data group the
ranks of one model coordinate.  Every rank runs the same host logic from
the same seeds (the same files sampled in the same order), computes only
its data coordinate's rows of each batch, and calls the collectives
itself:

  * `shard_batch` gives the rank its data coordinate's rows of axis 0,
    `all_gather_rows` the whole batch back (one all-gather over the data
    group for a whole tree of tensors); ranks of one model group hold the
    same rows;
  * `all_reduce_sum` sums a list of tensors over the data group in one
    flat buffer: an optimizer step's gradients, with the loss's numerator
    and denominator, are one collective (`train/gan.py`);
  * `replicate` broadcasts rank 0's tensors (a `TrainState` with its Adam
    moments and spectral-norm u/v, a module, a tree), each shard from its
    data group's first rank, and `assert_replicated` checks that the ranks
    still hold the same bits: shards within their data group, every other
    tensor across the world;
  * `shard_params` keeps the rank's shard of each parameter's output
    axis (and of its Adam moments) and marks the layer, whose forward then
    runs column-parallel over the model group (`parallel/tensor.py`);
    `gather_params` is its inverse.

The reference package kept the model axis for compile coverage; its own
measurement on its 8-device virtual CPU mesh found a data x model mesh
1.22 times slower than pure data parallelism at these widths (dp8 3.18 s
against dp4 x tp2 3.87 s a G+D step, `tools/measure_tp.py`): every weight
fits on one device, and the activations' all-gathers buy nothing.

Under gloo with CUDA tensors every collective stages its buffer through
the host: gloo runs on the CPU.  A `Mesh` counts its collectives by tag,
and with `timed` also their seconds (host clock, the device synchronised
before and after each).
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
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
    """One rank's view of a ("data", "model") grid of ranks: rank r sits at
    data coordinate r // model_parallel and model coordinate
    r % model_parallel."""
    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None                 # the world's; None: the default group
    model_parallel: int = 1           # the model axis's size
    data_group: Any = None            # this rank's; None: the default group
    model_group: Any = None           # this rank's; None with model axis 1
    axis_names: tuple = AXES
    timed: bool = False
    # tag -> [calls, seconds]; seconds only while `timed`
    stats: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(lambda: [0, 0.0]))

    @property
    def data_size(self) -> int:
        return self.world // self.model_parallel

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_parallel

    def __deepcopy__(self, memo):
        # a handle on process groups: a copied layer keeps its mesh
        return self

    def rows(self, n: int) -> slice:
        """This rank's rows of an axis of `n` rows: its data coordinate's
        (the ranks of one model group hold the same rows)."""
        if n % self.data_size:
            raise ValueError(f"{n} rows do not divide over {self.data_size} "
                             f"data coordinates: pad the batch to a "
                             f"multiple of the data axis")
        b = n // self.data_size
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def model_slice(self, n: int) -> slice:
        """This rank's part of a model-sharded axis of `n` elements."""
        b = n // self.model_parallel
        return slice(self.model_rank * b, (self.model_rank + 1) * b)

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

    def model_all_gather(self, x: torch.Tensor, dim: int,
                         tag: str = "tp:gather") -> torch.Tensor:
        """The model group's tensors `x` (one shape and dtype) concatenated
        on `dim` in model order: one all-gather of their bytes."""
        flat = x.contiguous().reshape(-1).view(torch.uint8)
        parts = _all_gather_flat(self, flat, tag, self.model_group,
                                 self.model_parallel)
        return torch.cat([p.view(x.dtype).view(x.shape)
                          for p in parts.unbind(0)], dim)

    def model_all_reduce(self, x: torch.Tensor,
                         tag: str = "tp:reduce") -> torch.Tensor:
        """`x` summed over the model group (a new tensor)."""
        buf = x.detach().cpu() if self._staged(x) else x.detach().clone()
        with self.collective(tag):
            dist.all_reduce(buf, group=self.model_group)
        return buf.to(x.device)


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
    group, one rank a device, laid out as the reference package lays its
    devices out: `reshape(world // model_parallel, model_parallel)`.  With
    `model_parallel > 1` every rank creates every model group (rows of the
    grid), then every data group (its columns), in that order.  `devices`
    holds one device a rank (this rank takes `devices[rank]`); the default
    is CUDA device LOCAL_RANK (torchrun's variable; without it, the rank),
    which raises without a GPU.  `n_devices` must be the world size: a
    mesh spans the whole group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised default process group: start "
            "one process a rank with torchrun (python -m "
            "torch.distributed.run) or nelegan_tpu_torch.parallel.launch")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{world} ranks; a mesh spans the whole group")
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the {world} ranks")
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
    groups = {}
    if model_parallel > 1:
        grid = np.arange(world).reshape(world // model_parallel,
                                        model_parallel)
        for axis, members in (("model", grid), ("data", grid.T)):
            for ranks in members.tolist():
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
    return Mesh(rank=rank, world=world, device=dev, backend=backend,
                model_parallel=model_parallel,
                data_group=groups.get("data"),
                model_group=groups.get("model"))


# ------------------------------------------------ parameters on the model axis
def _parts(tree) -> dict:
    """name -> (module, its optimiser or None) of a module or of a
    TrainState (its `parts()`, keyed as its state_dict)."""
    if isinstance(tree, torch.nn.Module):
        return {"": (tree, None)}
    if hasattr(tree, "parts"):
        return tree.parts()
    raise TypeError(f"a module or a TrainState, not {type(tree).__name__}")


def _module_axes(module: torch.nn.Module) -> dict:
    """state_dict key -> model axis of each tensor `shard_params` sharded
    in `module`.  A layer that can shard declares `MODEL_AXIS` (tensor name
    -> its output-feature dim) and holds its mesh in `tp` once sharded."""
    out = {}
    for name, sub in module.named_modules():
        if getattr(sub, "tp", None) is not None:
            for t, dim in sub.MODEL_AXIS.items():
                out[f"{name}.{t}" if name else t] = dim
    return out


def _optimizer_axes(opt, module) -> dict:
    """Adam state index -> model axis of its parameter, for the sharded
    parameters of `module` (a state_dict numbers the parameters in their
    groups' order)."""
    axes = _module_axes(module)
    names = {id(p): k for k, p in module.named_parameters()}
    params = [p for g in opt.param_groups for p in g["params"]]
    return {i: axes[names[id(p)]] for i, p in enumerate(params)
            if names.get(id(p)) in axes}


def _axis_tree(tree, state) -> Any:
    """A tree shaped as `state` (`_state_of(tree)`): each sharded tensor's
    model axis, None for every other leaf."""
    out = tree_map(lambda x: None, state)
    if not (isinstance(tree, torch.nn.Module) or hasattr(tree, "parts")):
        return out
    for name, (module, opt) in _parts(tree).items():
        sub = out[name] if name else out
        sub.update(_module_axes(module))
        if opt is not None:
            st = out[f"{name}_opt"]["state"]
            for i, dim in _optimizer_axes(opt, module).items():
                for k in ("exp_avg", "exp_avg_sq"):
                    if k in st.get(i, {}):
                        st[i][k] = dim
    return out


def shard_params(mesh: Mesh, tree: Any) -> Any:
    """Tensor-parallel placement over the model axis, in place: the
    reference package's `_param_spec` in this package's layout.  Every
    layer that declares `MODEL_AXIS` (a conv or linear layer's weight and
    bias, dim 0; a cumulative LayerNorm's gain and bias, dim 1: the flax
    leaves' last axis) keeps this rank's part of that axis when its size
    divides by the model axis and exceeds 1, with the same part of its
    Adam moments, and runs column-parallel from then on; every other
    tensor (spectral-norm u and v, Adam's step, a layer too narrow) stays
    whole, replicated.  `tree` is a module or a TrainState that every
    rank holds whole (from one seed, or after `replicate`).  A model axis
    of 1 leaves it as it is."""
    mp = mesh.model_parallel
    if mp == 1:
        return tree
    for module, opt in _parts(tree).values():
        moved = {}
        for sub in module.modules():
            axis = getattr(sub, "MODEL_AXIS", None)
            if axis is None:
                continue
            if sub.tp is not None:
                raise ValueError(f"{type(sub).__name__} is sharded already")
            first, dim = next(iter(axis.items()))
            size = sub.get_parameter(first).shape[dim]
            if size % mp or size == 1:
                continue
            cut = mesh.model_slice(size)
            for name, d in axis.items():
                p = sub.get_parameter(name)
                p.grad = None
                p.data = p.data.narrow(d, cut.start, size // mp).clone()
                moved[p] = d
            sub.tp = mesh
        for p, d in (moved.items() if opt is not None else ()):
            st = opt.state.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    n = st[k].shape[d] // mp
                    st[k] = st[k].narrow(d, mesh.model_rank * n, n).clone()
    return tree


def gather_params(mesh: Mesh, tree: Any) -> Any:
    """The inverse of `shard_params`: a copy of `tree` (a module or a
    TrainState) with every sharded tensor and Adam moment whole again, on
    every rank (one all-gather over the model group), its layers no longer
    column-parallel.  `tree` is left as it is."""
    out = copy.deepcopy(tree)
    holders = []              # (set the whole tensor, the shard, its axis)
    for module, opt in _parts(out).values():
        owned = {}
        for sub in module.modules():
            if getattr(sub, "tp", None) is None:
                continue
            for name, d in sub.MODEL_AXIS.items():
                p = sub.get_parameter(name)
                owned[p] = d
                holders.append((functools.partial(setattr, p, "data"),
                                p.data, d))
            sub.tp = None
        for p, d in (owned.items() if opt is not None else ()):
            st = opt.state.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    holders.append((functools.partial(st.__setitem__, k),
                                    st[k], d))
    if holders:
        whole = _gather_cat(mesh, [t for _, t, _ in holders],
                            [d for _, _, d in holders], "all_gather:params",
                            mesh.model_group, mesh.model_parallel)
        for (put, _, _), t in zip(holders, whole):
            put(t)
    return out


# ------------------------------------------------------- batches and sums
def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """This rank's rows of axis 0 of every tensor and array leaf (a view),
    each leaf keeping its type and device; scalars pass as they are.  The
    row count must divide by the data axis's size."""
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


def _gather_cat(mesh: Mesh, tensors: Sequence[torch.Tensor],
                dims: Sequence[int], tag: str, group, size: int) -> list:
    """Each tensor of every rank of `group` (`size` ranks; each rank the
    same shapes and dtypes) concatenated in rank order on its dim in
    `dims`, in one all-gather; each comes back in the memory order it had,
    on its device."""
    flat, layout = _pack(tensors, mesh.device)
    gathered = _all_gather_flat(mesh, flat, tag, group, size)   # [size, n]
    out = []
    for t, dim, (off, n, perm, dshape, dtype) in zip(tensors, dims, layout):
        # [size, *dense] -> the ranks' parts side by side on the dim
        d = perm.index(dim)
        seg = gathered[:, off:off + n].contiguous().view(dtype)
        full = seg.reshape((size,) + dshape).movedim(0, d)
        shape = list(dshape)
        shape[d] *= size
        out.append(full.reshape(shape).permute(inverse_perm(perm))
                   .to(t.device))
    return out


def all_gather_rows(mesh: Mesh, tree: Any) -> Any:
    """The inverse of `shard_batch`: every data coordinate's rows of each
    tensor or array leaf, concatenated in order on axis 0, in one
    all-gather over the data group for the whole tree.  Every rank must
    pass the same structure, shapes and dtypes.  Each tensor leaf comes
    back in the memory order it had (a column-major leaf stays
    column-major), on its device; an array leaf comes back as an array."""
    leaves = [x for x in tree_leaves(tree)
              if isinstance(x, (torch.Tensor, np.ndarray))]
    if not leaves:
        return tree
    tensors = [torch.from_numpy(np.ascontiguousarray(x))
               if isinstance(x, np.ndarray) else x for x in leaves]
    if any(t.dim() == 0 for t in tensors):
        raise ValueError("all_gather_rows: a 0-d leaf has no rows")
    whole = _gather_cat(mesh, tensors, [0] * len(tensors), "all_gather",
                        mesh.data_group, mesh.data_size)
    out = {id(x): (t.cpu().numpy() if isinstance(x, np.ndarray) else t)
           for x, t in zip(leaves, whole)}
    return tree_map(lambda x: out.get(id(x), x), tree)


def _all_gather_flat(mesh: Mesh, flat: torch.Tensor, tag: str, group,
                     size: int) -> torch.Tensor:
    """[size, n]: the flat tensor `flat` (n elements) of every rank of
    `group`, in rank order."""
    src = flat.cpu() if mesh._staged(flat) else flat
    out = src.new_empty((size,) + tuple(src.shape))
    with mesh.collective(tag):
        dist.all_gather(list(out.unbind(0)), src, group=group)
    return out.to(flat.device)


def all_reduce_sum(mesh: Mesh, tensors: Sequence[torch.Tensor],
                   tag: str = "all_reduce") -> list:
    """Each tensor summed over the data group, in one all-reduce of one
    flat buffer (the tensors share a dtype and a device).  Returns views
    of the summed buffer, shaped as the inputs."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"all_reduce_sum: one dtype, not {dtypes}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    buf = flat.cpu() if mesh._staged(flat) else flat
    with mesh.collective(tag):
        dist.all_reduce(buf, group=mesh.data_group)
    flat = buf.to(flat.device)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


# ------------------------------------------------------------- replicas
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
    """Rank 0's copy of `tree` on every rank, and of each shard of a
    sharded one (`shard_params`) its data group's first rank's.  Tensors
    are overwritten in place, by one broadcast over the world (and one
    over the data group for the shards); arrays come back as new arrays;
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
    leaves = tree_leaves(state)
    held = {id(x): (torch.from_numpy(np.array(x))
                    if isinstance(x, np.ndarray) else x)
            for x in leaves if isinstance(x, (torch.Tensor, np.ndarray))}
    sharded = {id(x) for x, a in zip(leaves, tree_leaves(
        _axis_tree(tree, state))) if a is not None}
    for ids, group, src in (
            ([i for i in held if i not in sharded], mesh.group, 0),
            ([i for i in held if i in sharded], mesh.data_group,
             mesh.model_rank)):
        if not ids:
            continue
        flat, layout = _pack([held[i] for i in ids], mesh.device)
        buf = flat.cpu() if mesh._staged(flat) else flat
        with mesh.collective("broadcast"):
            dist.broadcast(buf, src=src, group=group)
        for i, (off, n, perm, dshape, dtype) in zip(ids, layout):
            src_t = buf[off:off + n].view(dtype).reshape(dshape)
            with torch.no_grad():
                held[i].copy_(src_t.permute(inverse_perm(perm)))
    it = iter(theirs)

    def put(x):
        kind, *rest = next(it)
        if kind == "value":
            return rest[0]
        t = held[id(x)]
        return t.numpy() if isinstance(x, np.ndarray) else x
    return restore(tree_map(put, state))


def _digest(state, axes: Sequence) -> tuple:
    """(int64 [n] checksums, per checksum whether its leaf is sharded) of
    a state's tensor and integer leaves; `axes` holds each leaf's model
    axis or None."""
    out, flags = [], []
    dev = None
    for x, a in zip(tree_leaves(state), axes):
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
        else:
            continue
        flags.append(a is not None)
    dev = dev or torch.device("cpu")
    d = (torch.stack([o.to(dev) for o in out]) if out else
         torch.zeros(0, dtype=torch.int64, device=dev))
    return d, flags


def replica_digest(tree: Any) -> torch.Tensor:
    """int64 [n]: one checksum a tensor leaf (its bytes weighted by odd
    position weights, summed modulo 2**64), one value an integer leaf, on
    the first tensor's device.  Equal trees give equal digests; a flipped
    bit changes its leaf's."""
    state, _ = _state_of(tree)
    return _digest(state, [None] * len(tree_leaves(state)))[0]


def assert_replicated(mesh: Mesh, tree: Any, what: str = "state") -> None:
    """Raise unless the ranks hold `tree` bit for bit (its digests,
    all-gathered over the world: one collective): a shard equal down its
    data group, every other leaf on every rank."""
    state, _ = _state_of(tree)
    d, flags = _digest(state, tree_leaves(_axis_tree(tree, state)))
    if not flags:
        return
    got = _all_gather_flat(mesh, d.to(mesh.device), "all_gather:digest",
                           mesh.group, mesh.world)
    grid = got.reshape(mesh.data_size, mesh.model_parallel, -1)
    down = (grid != grid[:1]).any(0).any(0)
    across = (got != got[:1]).any(0)
    bad = torch.where(torch.tensor(flags, dtype=torch.bool,
                                   device=got.device), down, across)
    if bool(bad.any()):
        leaves = torch.nonzero(bad).flatten().tolist()
        raise RuntimeError(f"{what} differs between the ranks (leaves "
                           f"{leaves} of {d.numel()}): the replicas "
                           f"diverged")
