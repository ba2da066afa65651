"""Spatially sharded TSDF fusion over ranks (port of
``noetic_slam_tpu.parallel.tsdf``).

TSDF blocks shard across an axis of a ``parallel.mesh.Mesh`` by block key
(``key % D``): every rank owns a disjoint part of space with its own
directory and payload of ``max_blocks / D`` slots. Every rank computes
the ray samples of the whole scan (replicated), keeps the samples whose
block it owns, and runs the one-device ``_integrate_samples`` (kernel B
on the card) on them: the replicate-then-filter is the all-to-all, and
the only collective is the sum of the block counters.

Each rank holds its shard's directory and payload; ``num_blocks`` and
``dropped`` are the whole map's counts, the same on every rank. As in the
JAX module, a rank allocates its new blocks' slots from the global count
and the ranks' changes to the counts are summed, so a shard runs out of
slots once the map holds ``max_blocks / D`` blocks in all (the
reference's behaviour, kept), after which ``num_blocks`` no longer counts
the blocks held.

``gather_sharded_state`` brings the shards to the host as one global
``TsdfState`` (slots re-based by the shard offset, keys in stable sorted
order), so surface extraction and meshing apply unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from noetic_slam_tpu_torch.config import TsdfConfig
from noetic_slam_tpu_torch.models.tsdf import (
    KEY_PAD,
    TsdfState,
    _integrate_samples,
    _ray_samples,
    init_tsdf,
    sample_keys,
)

Tensor = torch.Tensor


def _local_cfg(cfg: TsdfConfig, mesh, axis: str) -> TsdfConfig:
    ndev = mesh.size(axis)
    if cfg.max_blocks % ndev:
        raise ValueError(f"max_blocks {cfg.max_blocks} does not divide the "
                         f"{axis!r} axis ({ndev} ranks)")
    return dataclasses.replace(cfg, max_blocks=cfg.max_blocks // ndev)


def init_sharded_tsdf(cfg: TsdfConfig, mesh, axis: str = "map"
                      ) -> TsdfState:
    """This rank's empty shard on the mesh's device: ``cfg.max_blocks`` is
    the global capacity, of which the rank owns ``max_blocks / D``."""
    return init_tsdf(_local_cfg(cfg, mesh, axis), mesh.device)


def make_sharded_integrate(cfg: TsdfConfig, mesh, axis: str = "map"):
    """``integrate(state, points, valid, origin) -> state``: this rank's
    shard fused with the samples of the blocks it owns, and the global
    counts advanced by the sum of every rank's change (one ``all_reduce``
    of two values). ``points``, ``valid`` and ``origin`` are
    replicated."""
    ndev, my = mesh.size(axis), mesh.index(axis)

    def integrate(state: TsdfState, points: Tensor, valid: Tensor,
                  origin: Tensor) -> TsdfState:
        pos, sdf, w = _ray_samples(cfg, points, valid, origin)
        keys, _ = sample_keys(pos, cfg.voxel_size, w != 0.0)
        mine = (keys != KEY_PAD) & ((keys % ndev) == my)
        before = torch.stack([state.num_blocks, state.dropped])
        new = _integrate_samples(cfg, state, pos, sdf,
                                 torch.where(mine, w, 0.0))
        delta = mesh.all_reduce(
            torch.stack([new.num_blocks, new.dropped]) - before, "sum", axis)
        after = before + delta
        return new._replace(num_blocks=after[0], dropped=after[1])

    return integrate


def gather_sharded_state(cfg: TsdfConfig, state: TsdfState, mesh,
                         axis: str = "map") -> TsdfState:
    """Every rank's shard on the host as ONE equivalent global TsdfState
    of CPU tensors (each shard's slots re-based by its offset), so that
    ``extract_surface`` and meshing apply unchanged. Every rank of the
    axis calls it and gets the same state."""
    keys, slots, wsum, weight = (
        [t.numpy() for t in mesh.all_gather_host(x, axis)]
        for x in (state.dir_keys, state.dir_slots, state.wsum, state.weight))
    c_local = len(keys[0])
    for i in range(len(keys)):
        slots[i] = np.where(keys[i] != KEY_PAD, slots[i] + i * c_local, 0)
    keys, slots = np.concatenate(keys), np.concatenate(slots)
    order = np.argsort(keys, kind="stable")
    return TsdfState(
        dir_keys=torch.from_numpy(keys[order]),
        dir_slots=torch.from_numpy(slots[order].astype(np.int32)),
        num_blocks=state.num_blocks.detach().cpu().clone(),
        wsum=torch.from_numpy(np.concatenate(wsum)),
        weight=torch.from_numpy(np.concatenate(weight)),
        dropped=state.dropped.detach().cpu().clone())
