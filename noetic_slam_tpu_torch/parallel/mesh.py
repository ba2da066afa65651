"""Rank meshes over ``torch.distributed`` (port of
``noetic_slam_tpu.parallel.mesh``).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``:
``shard_map`` hands each device its block of a sharded array and the
collectives (``psum``, ``pmin``) run inside the program. The port runs one
process per rank. Every rank holds the replicated state, takes its block
of a sharded array by its index along the axis (``Mesh.shard``), and
combines with ``all_reduce`` over the axis's process group
(``Mesh.all_reduce``, which counts the bytes it is handed).

Axis names as in the JAX package: ``"map"`` shards space (submap points,
TSDF blocks, pose-graph edges); ``"batch"`` runs independent sequences.

Backends: ``nccl`` where each rank has a card of its own. Ranks that share
one card use ``gloo`` (NCCL refuses two ranks on one device); gloo takes
CUDA tensors for ``all_reduce`` and ``broadcast`` and stages them through
the host. Host-side gathers (``parallel.tsdf.gather_sharded_state``) go
through a gloo group over CPU tensors.

``launch(fn, world_size, *args)`` spawns the ranks (``spawn`` start
method, a file-store rendezvous in a fresh temporary directory, so that
concurrent launches never share a port), runs ``fn(*args)`` on each and
returns their results; a rank that fails or does not finish in time ends
the launch with an error instead of a hang.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from noetic_slam_tpu_torch import resolve_device

Tensor = torch.Tensor

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


class Mesh:
    """This rank's place in a 1-D or 2-D grid of ranks: per axis its
    process group, size and index; its device; a counter of the bytes
    and calls handed to ``all_reduce``."""

    def __init__(self, sizes: dict, index: dict, groups: dict,
                 host_groups: dict, device: torch.device):
        self.shape = dict(sizes)       # axis -> size, as jax Mesh.shape
        self._index = index
        self._groups = groups
        self._host_groups = host_groups
        self.device = device
        self.reduce_bytes = 0
        self.reduce_calls = 0

    def size(self, axis: str = "map") -> int:
        return self.shape[axis]

    def index(self, axis: str = "map") -> int:
        """This rank's index along ``axis`` (``lax.axis_index``)."""
        return self._index[axis]

    def shard(self, x: Tensor, axis: str = "map") -> Tensor:
        """This rank's block of ``x``'s leading dimension (``P(axis)``); a
        view, contiguous when ``x`` is."""
        n = self.size(axis)
        if x.shape[0] % n:
            raise ValueError(f"leading dimension {x.shape[0]} does not "
                             f"divide the {axis!r} axis ({n} ranks)")
        c = x.shape[0] // n
        i = self.index(axis)
        return x[i * c:(i + 1) * c]

    def all_reduce(self, x: Tensor, op: str = "sum", axis: str = "map"
                   ) -> Tensor:
        """``x`` reduced over the ranks of ``axis`` (a new tensor; ``op``
        "sum" or "min"). Counts the bytes handed over."""
        out = x.contiguous().clone()
        self.reduce_bytes += out.numel() * out.element_size()
        self.reduce_calls += 1
        dist.all_reduce(out, op=_OPS[op], group=self._groups[axis])
        return out

    def all_gather_host(self, x: Tensor, axis: str = "map") -> list:
        """Every rank's ``x`` along ``axis`` as CPU tensors, in rank order
        (same shape on every rank), through the gloo host group."""
        x = x.detach().cpu().contiguous()
        out = [torch.empty_like(x) for _ in range(self.size(axis))]
        dist.all_gather(out, x, group=self._host_groups[axis])
        return out


def _device_for(devices, rank: int) -> torch.device:
    if devices is None:
        if not torch.cuda.is_available():
            return resolve_device(None)       # raises: no card
        return torch.device("cuda", rank % torch.cuda.device_count())
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices)
    return torch.device(devices[rank])


def _groups(rank_lists: list, me: int):
    """This rank's (group, host group) among ``rank_lists``. Every rank
    creates every group, in the same order, as ``new_group`` requires;
    the host group is the group itself under gloo."""
    gloo = dist.get_backend() == "gloo"
    world = dist.get_world_size()
    mine = (None, None)
    for ranks in rank_lists:
        whole = list(ranks) == list(range(world))
        g = dist.group.WORLD if whole else dist.new_group(list(ranks))
        h = g if gloo else dist.new_group(list(ranks), backend="gloo")
        if me in ranks:
            mine = (g, h)
    return mine


def make_mesh(n_devices: int | None = None, axis: str = "map",
              devices=None) -> Mesh | None:
    """1-D mesh over the first ``n_devices`` ranks of the world (all of
    them by default). Every rank of the world calls it; a rank beyond the
    first ``n_devices`` gets None. ``devices``: one device for every rank,
    or a sequence indexed by rank; by default the card
    ``rank % device_count`` (raises where there is none)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} ranks of a world of {world}")
    g, h = _groups([range(n)], rank)
    if rank >= n:
        return None
    return Mesh({axis: n}, {axis: rank}, {axis: g}, {axis: h},
                _device_for(devices, rank))


def make_mesh_2d(n_map: int, n_batch: int, devices=None) -> Mesh | None:
    """2-D mesh ("batch", "map") over the first ``n_map * n_batch`` ranks,
    batch outer (rank = b * n_map + m), as the JAX package lays it out for
    hosts. Every rank of the world calls it; ranks beyond get None."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_map * n_batch
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh_2d: {n} ranks of a world of {world}")
    rows = [range(b * n_map, (b + 1) * n_map) for b in range(n_batch)]
    cols = [range(m, n, n_map) for m in range(n_map)]
    gm, hm = _groups(rows, rank)
    gb, hb = _groups(cols, rank)
    if rank >= n:
        return None
    return Mesh({"batch": n_batch, "map": n_map},
                {"batch": rank // n_map, "map": rank % n_map},
                {"batch": gb, "map": gm}, {"batch": hb, "map": hm},
                _device_for(devices, rank))


# ---------------------------------------------------------------------------
# Launching ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn, world_size: int, backend: str, store: str,
               out_dir: str, timeout: float, args: tuple) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method="file://" + store, rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(fn, world_size: int, *args, backend: str = "gloo",
           timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks, each with
    ``torch.distributed`` initialised (``backend``; one CPU thread each)
    and ``dist.get_rank()`` telling it apart; returns the ranks' results
    in rank order. ``fn`` must be importable by name (a module-level
    function) and its results picklable. Raises when a rank raises, and
    kills every rank and raises ``TimeoutError`` when they are not done
    within ``timeout`` seconds (collectives time out after it as well)."""
    tmp = tempfile.mkdtemp(prefix="nst_ranks_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world_size, backend,
                              os.path.join(tmp, "store"), tmp, timeout,
                              args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"launch: {world_size} ranks not done "
                                   f"within {timeout:g} s")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
