"""A world of ranks on this host, one spawned process a rank.

The port's counterpart of the reference package's virtual device mesh
(its tests run JAX over eight virtual CPU devices).  `run(fn, world,
backend)` starts `world` processes with the `spawn` method (`fork` is
unsafe once CUDA is initialised), each joins one process group through a
`FileStore` in a temporary directory (no TCP port, so parallel test
workers cannot collide), builds its `Mesh` and returns `fn(mesh, *args)`.
The backend is the caller's choice, never switched: "gloo" (CPU tensors,
or CUDA tensors staged through the host; several ranks may share one
card) or "nccl" (one card a rank).  `timeout` bounds the whole world and
each collective; when a rank raises or dies, the others are killed and
`run` raises within a fraction of a second.

`fn` must be importable by name (a module-level function) and return
picklable host values; tensors in what it returns come back as numpy
arrays.  The kernels' launch counts (`kernels.launches`) are per process,
so a rank that wants its counts returns them.

`world_of_one` is the degenerate world in the calling process: a mesh of
one rank, on which every collective is the identity.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch

from nelegan_tpu_torch.utils.tree import tree_map

# how long a rank that finished may take to exit before it is killed
_EXIT_GRACE_S = 30.0


def _to_host(tree):
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)


def _rank_main(rank: int, world: int, backend: str, store_path: str,
               fn: Callable, args: tuple, devices, timeout: float,
               threads: Optional[int], results) -> None:
    import torch.distributed as dist

    from nelegan_tpu_torch.device import resolve_device
    from nelegan_tpu_torch.parallel.mesh import make_mesh

    os.environ["LOCAL_RANK"] = os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world)
    try:
        if threads:
            torch.set_num_threads(threads)
        device = resolve_device(devices[rank] if devices is not None
                                else f"cuda:{rank}")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        out = _to_host(fn(make_mesh(devices=devices), *args))
    except BaseException:
        # reported before this rank's connections close, so that the
        # errors its peers then meet arrive after it
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)
    dist.destroy_process_group()
    results.put((rank, True, out))


def run(fn: Callable, world: int, backend: str, args: tuple = (),
        devices: Optional[Sequence[Any]] = None, timeout: float = 300.0,
        threads: Optional[int] = None) -> list:
    """`fn(mesh, *args)` on each of `world` ranks -> the ranks' results in
    rank order.  `devices` gives each rank's device (default: CUDA device
    `rank`); `threads` sets each rank's torch threads.  Raises
    RuntimeError naming the rank when one fails, TimeoutError past
    `timeout` seconds; either way no rank survives."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="nele_world_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, backend, f"{tmp}/store", fn,
                                   args, devices, timeout, threads, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                try:
                    rank, ok, payload = results.get(timeout=0.1)
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in got and p.exitcode is not None:
                            raise RuntimeError(
                                f"rank {r} of {world} exited with code "
                                f"{p.exitcode} and no result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"a world of {world} ranks took "
                                           f"more than {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(_failures(results, rank, payload,
                                                 world))
                got[rank] = payload
            for p in procs:
                p.join(_EXIT_GRACE_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
            results.close()
    return [got[r] for r in range(world)]


def _failures(results, rank: int, payload: str, world: int) -> str:
    """The first failure and any other that arrives within a second (a
    peer's broken collective, usually), in arrival order."""
    lines = [f"rank {rank} of {world} failed:\n{payload}"]
    deadline = time.monotonic() + 1.0
    while time.monotonic() < deadline:
        try:
            r, ok, p = results.get(timeout=0.1)
        except queue.Empty:
            continue
        if not ok:
            lines.append(f"then rank {r} of {world} failed:\n{p}")
    return "\n".join(lines)


@contextlib.contextmanager
def world_of_one(backend: str = "gloo", device=None,
                 timeout: float = 60.0):
    """A process group of this process alone (a FileStore in a temporary
    directory), -> its Mesh on `device` (default CUDA); the group is
    destroyed on exit."""
    import torch.distributed as dist

    from nelegan_tpu_torch.parallel.mesh import make_mesh

    with tempfile.TemporaryDirectory(prefix="nele_world_") as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=timeout))
        try:
            yield make_mesh(devices=None if device is None else [device])
        finally:
            dist.destroy_process_group()
