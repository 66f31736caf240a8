"""Process groups of the SPMD solvers: the port's device mesh.

sba_tpu shards a solve over a 1-D JAX mesh axis and reduces with
``psum`` / ``pmax`` over it. Here one rank is one process, and a mesh
axis is a ``torch.distributed`` process group:

- `make_mesh` registers a group under an axis name (the world group
  unless told otherwise) and returns a `Mesh`; an option's
  ``axis_name`` resolves through `get_group`, and a name that was never
  registered resolves to the world group, as ``torchrun`` sets it up.
- `all_reduce` is every collective of the solvers: SUM or MAX over the
  group, on a copy of the tensor (the tensor itself without an axis).
  Only ``all_reduce`` runs, which NCCL and gloo both carry on CUDA
  tensors. The caller picks the backend: NCCL where each rank has its
  own card, gloo on the CPU or for ranks that share one card (NCCL
  refuses two ranks on one GPU).
- `run_ranks` spawns ranks of a function, each in a fresh process with
  its process group set up, and returns what each returned. A rank that
  raises or dies, and a run past its timeout, fail the call; every rank
  is stopped then.

`STATS` counts the all-reduces and their bytes, for the callers'
reports.
"""

from __future__ import annotations

import contextlib
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

# All-reduces launched by this process, and their payload bytes.
STATS = {"calls": 0, "bytes": 0}

_GROUPS: dict = {}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0)


class Mesh(NamedTuple):
    """A 1-D mesh: an axis name and the process group behind it."""

    axis_name: str
    group: Optional[object]   # None: the world group

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


def register_group(axis_name: str, group=None) -> Mesh:
    """Resolve `axis_name` to `group` (None: the world group)."""
    _GROUPS[axis_name] = group
    return Mesh(axis_name, group)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "obs",
              group=None) -> Mesh:
    """The mesh of sba_tpu's ``make_mesh``: `group` (by default the
    world, whose size `n_devices` must then be, if given) under
    `axis_name`."""
    if group is None and n_devices not in (None, dist.get_world_size()):
        raise ValueError(f"n_devices {n_devices}: the world has "
                         f"{dist.get_world_size()} ranks; pass a group")
    return register_group(axis_name, group)


def as_mesh(mesh, axis_name: str) -> Mesh:
    """`mesh` (a `Mesh`, or None for the world group) registered under
    `axis_name`, the name the solver's options carry."""
    return register_group(axis_name, None if mesh is None else mesh.group)


def get_group(axis_name: str):
    return _GROUPS.get(axis_name)


def rank(axis_name: str) -> int:
    return dist.get_rank(get_group(axis_name))


def all_reduce(x: torch.Tensor, axis_name: Optional[str], op: str = "sum"):
    """SUM (psum) or MAX (pmax) of `x` over the axis's group; `x` is not
    modified. Every rank gets the same bits. Without an axis (None, an
    unsharded solve) `x` itself."""
    if axis_name is None:
        return x
    group = get_group(axis_name)
    y = x.clone()
    STATS["calls"] += 1
    STATS["bytes"] += y.numel() * y.element_size()
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return y


def gather_rows(local: torch.Tensor, offset: int, total: int,
                axis_name: str, dim: int = 0):
    """Put together a tensor sharded along `dim`: each rank writes its
    rows [offset, offset + len) of a zero-filled full tensor of `total`
    rows, and one all-reduce sums them (exact: every entry has one
    writer)."""
    shape = list(local.shape)
    shape[dim] = total
    full = local.new_zeros(shape)
    full.narrow(dim, offset, local.shape[dim]).copy_(local)
    return all_reduce(full, axis_name)


def shard_rows(x, rank_: int, world: int, dim: int = 0):
    """Rank `rank_`'s contiguous 1/world of `x` along `dim` (its length
    a multiple of world)."""
    n = x.shape[dim] // world
    return x.narrow(dim, rank_ * n, n)


@contextlib.contextmanager
def single_rank(backend: str = "gloo", store_dir: Optional[str] = None):
    """A world of this process alone (a FileStore in a fresh directory
    under `store_dir`) for the duration of the block, so that the SPMD
    entry points run in one process; inside an existing world, that
    world."""
    if dist.is_initialized():
        yield
        return
    tmp = tempfile.mkdtemp(prefix="rank_", dir=store_dir)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _GROUPS.clear()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Spawning ranks
# ---------------------------------------------------------------------------

def _rank_main(rank_, world, backend, device, store, target, args, out,
               timeout):
    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", rank_ % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank_, world_size=world,
                                timeout=timedelta(seconds=timeout))
        try:
            result = target(rank_, world, str(dev), *args)
        finally:
            dist.destroy_process_group()
        out.put(("ok", rank_, result))
    except BaseException:  # noqa: BLE001 - the parent raises it
        out.put(("error", rank_, traceback.format_exc()))


def run_ranks(target, world_size: int, backend: str = "gloo",
              device: str = "cpu", args=(), timeout: float = 120.0,
              store_dir: Optional[str] = None):
    """Run ``target(rank, world_size, device, *args)`` in `world_size`
    spawned processes, each in the default process group of `backend`
    (a FileStore in a fresh directory under `store_dir`, so that runs
    never share an address). `device` "cuda" gives rank r card r mod the
    card count, "cuda:0" puts every rank on card 0, "cpu" the CPU; each
    process runs one torch thread. `target` and its arguments
    must be importable and picklable without the caller's module state;
    its return value must pickle (move tensors to the CPU). Returns the
    ranks' results in rank order. Raises if a rank raises or dies, or
    when `timeout` seconds pass (which also bounds each collective);
    every rank is stopped before it returns or raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_", dir=store_dir)
    out = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main,
        args=(r, world_size, backend, device, os.path.join(tmp, "store"),
              target, tuple(args), out, timeout), daemon=True)
        for r in range(world_size)]
    results = [None] * world_size
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        pending = world_size
        while pending:
            try:
                kind, r, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"a rank died with exit code {dead[0]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{pending} of {world_size} ranks still running "
                        f"after {timeout} s")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results[r] = value
            pending -= 1
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return results
