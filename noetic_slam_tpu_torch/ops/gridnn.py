"""Grid-bucketed nearest neighbours (port of ``noetic_slam_tpu.ops.gridnn``),
the step's ``nn_engine="grid"``.

The same index as the JAX module: target points keyed by grid cell (cell
size >= the correspondence radius) and sorted by key, so the sorted key
array is the index and a cell lookup is a ``searchsorted``. A query
gathers up to ``max_per_cell`` candidates from each of its 27 neighbouring
cells and keeps the nearest (``grid_nn1``) or the k nearest
(``grid_knn``). With ``cell >= radius`` every target within ``radius`` of
a query lies in those cells, so the thresholded 1-NN GICP consumes is
exact up to the per-cell truncation.

Keys pack three 10-bit cell coordinates relative to a build-time origin
(``cz << 20 | cy << 10 | cx``); out-of-range and invalid points get
``INT32_MAX`` and match nothing. The neighbour offsets are packed with
``+``, not ``|``: their fields are negative.

Plain torch, as the JAX module is plain XLA: no kernel computes it.
``torch.sort(stable=True)`` gives ``jnp.argsort``'s order, ``argmin``
takes the first minimum in both packages; ``topk`` may order ties
differently from ``lax.top_k`` (the distances are the same). The
candidate tensors are (queries, 27, ``max_per_cell``) wide, so queries go
through in chunks of ``query_chunk``; the result does not depend on it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from noetic_slam_tpu_torch.ops.pointcloud import INT32_MAX, _masked_min

Tensor = torch.Tensor

_KEY_INVALID = INT32_MAX
QUERY_CHUNK = 2048


class Grid(NamedTuple):
    xyz: Tensor     # (Nt, 3) target points, sorted by cell key
    keys: Tensor    # (Nt,) int32 sorted cell keys (invalid = INT32_MAX)
    order: Tensor   # (Nt,) int32 original index of each sorted point
    origin: Tensor  # (3,) cell-space origin (float, units of cells)
    cell: Tensor    # () cell size [m]


def _cell_coords(xyz: Tensor, origin: Tensor, cell: Tensor) -> Tensor:
    return (torch.floor(xyz / cell).to(torch.int32)
            - origin.to(torch.int32))


def _pack(c: Tensor) -> Tensor:
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    ok = ((cx >= 0) & (cx < 1024) & (cy >= 0) & (cy < 1024)
          & (cz >= 0) & (cz < 1024))
    key = (cz << 20) | (cy << 10) | cx
    return torch.where(ok, key, _KEY_INVALID)


def build_grid(xyz: Tensor, valid: Tensor, cell: float) -> Grid:
    """Sort target points by grid cell (once per target)."""
    cell = torch.full((), cell, dtype=torch.float32, device=xyz.device)
    pmin = _masked_min(xyz, valid)
    origin = torch.floor(pmin / cell) - 1.0     # one-cell margin
    c = torch.floor(xyz / cell).to(torch.int32) - origin.to(torch.int32)
    keys = torch.where(valid, _pack(c), _KEY_INVALID)
    keys_s, order = torch.sort(keys, stable=True)
    return Grid(xyz[order], keys_s, order.to(torch.int32), origin, cell)


def _neighbor_key_offsets() -> np.ndarray:
    # arithmetic (+), not bitwise OR: offsets have negative fields
    return np.array([(dz << 20) + (dy << 10) + dx
                     for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dx in (-1, 0, 1)], np.int32)


_NEIGHBOR_OFFSETS = _neighbor_key_offsets()


@functools.lru_cache(maxsize=8)
def _offsets(device: torch.device) -> Tensor:
    """The 27 key offsets on ``device``, copied there once per process."""
    return torch.from_numpy(_NEIGHBOR_OFFSETS).to(device)


def _candidates(query: Tensor, grid: Grid, max_per_cell: int):
    """(slots_c (Nq, 27 * M) int64 clamped sorted-target slots, d2
    (Nq, 27 * M) squared distances, +inf where the slot is not in the
    neighbour cell)."""
    nq, nt = query.shape[0], grid.xyz.shape[0]
    dev = query.device
    qkey = _pack(_cell_coords(query, grid.origin, grid.cell))
    cand_keys = qkey[:, None] + _offsets(dev)[None, :]       # (Nq, 27)
    cand_keys = torch.where(qkey[:, None] == _KEY_INVALID, _KEY_INVALID,
                            cand_keys)
    start = torch.searchsorted(grid.keys, cand_keys.reshape(-1)).reshape(
        nq, 27)
    slots = (start[:, :, None]
             + torch.arange(max_per_cell, device=dev)[None, None, :])
    slots_c = torch.clamp(slots, max=nt - 1)
    in_cell = (grid.keys[slots_c] == cand_keys[:, :, None]) & (slots < nt)
    diff = grid.xyz[slots_c] - query[:, None, None, :]      # (Nq, 27, M, 3)
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    d2 = torch.where(in_cell, d2, torch.inf)
    return slots_c.reshape(nq, -1), d2.reshape(nq, -1)


def grid_nn1(query: Tensor, grid: Grid, *, max_per_cell: int = 32,
             query_chunk: int = QUERY_CHUNK) -> tuple[Tensor, Tensor]:
    """Thresholded 1-NN: the nearest sorted-target candidate within the
    27-cell neighbourhood of each query. Returns (idx (Nq,) int32 into the
    ORIGINAL target order, sqd (Nq,)); misses get sqd = +inf."""
    idx, sqd = [], []
    for q0 in range(0, query.shape[0], query_chunk):
        slots_c, d2 = _candidates(query[q0:q0 + query_chunk], grid,
                                  max_per_cell)
        best, a = torch.min(d2, dim=-1)
        slot = torch.gather(slots_c, 1, a[:, None])[:, 0]
        idx.append(grid.order[slot])
        sqd.append(best)
    return torch.cat(idx), torch.cat(sqd)


def grid_knn(query: Tensor, grid: Grid, k: int, *, max_per_cell: int = 32,
             query_chunk: int = QUERY_CHUNK) -> tuple[Tensor, Tensor]:
    """k-NN among the 27-neighbourhood candidates, ascending. Exact for
    neighbours within one cell of the query; unseen candidates come back
    with sqd = +inf. Returns (idx (Nq, k) int32 original order,
    sqd (Nq, k))."""
    idx, sqd = [], []
    for q0 in range(0, query.shape[0], query_chunk):
        slots_c, d2 = _candidates(query[q0:q0 + query_chunk], grid,
                                  max_per_cell)
        top, a = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
        idx.append(grid.order[torch.gather(slots_c, 1, a)])
        sqd.append(top)
    return torch.cat(idx), torch.cat(sqd)
