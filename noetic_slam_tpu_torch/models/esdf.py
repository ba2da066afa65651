"""ESDF queries over the dense maps (port of ``noetic_slam_tpu.models.esdf``).

Same design as the JAX module: a dense axis-aligned region around a point
of interest is gathered from the map through its sorted block directory
(one sort-merge join for the whole region), then an exact separable
squared Euclidean distance transform runs on the dense grid, one min-plus
pass per axis: ``d2_out[i] = min_j d2[j] + v^2 (i - j)^2``. The field is
signed by two transforms (distance to the obstacles from free space, and
from inside the obstacles to free space), clamped to ``[-max_dist,
max_dist]``; unobserved voxels read ``+max_dist`` with ``observed`` False.

Porting notes:
- Plain torch: the JAX module has no Pallas kernel. Each axis pass makes
  one (..., n, n) intermediate (~85 MB at the CLI's (96, 96, 24) region);
  the passes run one after another, never all three at once.
- The region's base voxel is ``floor(origin / v)`` in float32 as JAX's
  compiled program computes it: XLA folds a division by a constant into
  a product with the constant's f32 reciprocal, so the port multiplies by
  ``f32(1) / f32(v)`` too (a true division, or float64, can put a
  boundary voxel on the other side). ``esdf_at``'s divisions likewise.
- The TSDF values are computed at the gathered voxels only, not over the
  whole payload; the formula is ``tsdf_distance``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from noetic_slam_tpu_torch.models.tsdf import (
    BLOCK_VOLUME,
    _block_key,
    _lookup_join,
)

Tensor = torch.Tensor


def _inv(v: float) -> float:
    """1 / v as XLA folds it: the f32 reciprocal of f32 ``v``."""
    return float(np.float32(1.0) / np.float32(v))


def _minplus_1d(d2: Tensor, axis: int, v: float, n: int) -> Tensor:
    """One separable squared-EDT pass along ``axis``:
    ``d2_out[i] = min_j d2[j] + v^2 (i - j)^2`` (exact)."""
    i = torch.arange(n, dtype=torch.float32, device=d2.device)
    pen = torch.square((i[:, None] - i[None, :]) * v)          # (n, n)
    d2m = torch.movedim(d2, axis, -1)                          # (..., n)
    out = torch.amin(d2m[..., None, :] + pen, dim=-1)          # (..., n)
    return torch.movedim(out, -1, axis)


def _edt_sq(seed_d2: Tensor, v: float) -> Tensor:
    """Exact 3-axis squared Euclidean distance transform of seeded d^2."""
    out = seed_d2
    for ax, n in enumerate(seed_d2.shape):
        out = _minplus_1d(out, ax, v, n)
    return out


def _region(state, v: float, origin, shape: tuple):
    """The region's payload addresses: (flat index (n,) into the (C*512,)
    payload, found (n,) bool, centres (nx, ny, nz, 3))."""
    dev = state.dir_keys.device
    nx, ny, nz = shape
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    base = torch.floor(origin * _inv(v)).to(torch.int32)            # (3,)
    ii, jj, kk = torch.meshgrid(
        torch.arange(nx, dtype=torch.int32, device=dev),
        torch.arange(ny, dtype=torch.int32, device=dev),
        torch.arange(nz, dtype=torch.int32, device=dev), indexing="ij")
    vox = base + torch.stack([ii, jj, kk], dim=-1)                  # (..., 3)
    centers = (vox.to(torch.float32) + 0.5) * v
    b = vox >> 3
    intra = vox - (b << 3)
    slots = _lookup_join(state.dir_keys, state.dir_slots,
                         _block_key(b).reshape(-1))
    ivox = (intra[..., 0] + (intra[..., 1] << 3)
            + (intra[..., 2] << 6)).reshape(-1)
    found = slots >= 0
    C = state.dir_keys.shape[0]
    flat = torch.where(found, torch.clamp(slots, 0, C - 1).long()
                       * BLOCK_VOLUME + ivox, 0)
    return flat, found, centers


def _signed_field(occupied: Tensor, observed: Tensor, seed_out: Tensor,
                  seed_in: Tensor, v: float, max_dist: float) -> Tensor:
    d_out = torch.sqrt(_edt_sq(seed_out, v))
    d_in = torch.sqrt(_edt_sq(seed_in, v))
    esdf = torch.clamp(torch.where(occupied, -d_in, d_out), -max_dist,
                       max_dist)
    return torch.where(observed, esdf, max_dist)


def esdf_region(cfg, state, origin, shape: tuple = (64, 64, 32),
                max_dist: float = 5.0):
    """Euclidean signed distance field over a dense region of the TSDF.

    ``origin``: (3,) world-space corner (snapped to the voxel grid);
    ``shape``: (nx, ny, nz) voxels. Returns (esdf (nx, ny, nz) f32 [m],
    observed (nx, ny, nz) bool, centres (nx, ny, nz, 3) f32): positive
    outside obstacles, negative inside; the surface is seeded from the
    TSDF's own zero crossing (band voxels seed with |tsdf|^2)."""
    v = cfg.voxel_size
    flat, found, centers = _region(state, v, origin, shape)
    W = state.weight.reshape(-1)[flat]
    WS = state.wsum.reshape(-1)[flat]
    d = torch.where(W > 0.0, WS / torch.clamp(W, min=1e-12), cfg.truncation)
    tsdf_d = torch.where(found, d, cfg.truncation).reshape(shape)
    observed = torch.where(found, W, 0.0).reshape(shape) > 0.0

    occupied = observed & (tsdf_d < 0.0)
    band = observed & (torch.abs(tsdf_d) < v)       # zero-crossing seeds
    inf = torch.full((), 4.0 * max_dist * max_dist, device=tsdf_d.device)
    sq = torch.square(tsdf_d)
    seed_out = torch.where(band, sq, torch.where(occupied, 0.0, inf))
    seed_in = torch.where(band, sq, torch.where(occupied, inf, 0.0))
    return (_signed_field(occupied, observed, seed_out, seed_in, v,
                          max_dist), observed, centers)


def esdf_region_occupancy(cfg, state, origin, shape: tuple = (64, 64, 32),
                          max_dist: float = 5.0):
    """ESDF over the occupancy map (``cfg`` an ``OccupancyConfig``):
    occupied = log-odds > ``occ_thresh``, observed = log-odds != 0 (an
    exactly zero voxel in an allocated block counts as unobserved). No
    sub-voxel band exists in an occupancy grid, so the surface is
    voxel-quantised. Same return contract as ``esdf_region``."""
    v = cfg.voxel_size
    flat, found, centers = _region(state, v, origin, shape)
    L = torch.where(found, state.logodds.reshape(-1)[flat], 0.0
                    ).reshape(shape)
    observed = L != 0.0
    occupied = observed & (L > cfg.occ_thresh)
    inf = torch.full((), 4.0 * max_dist * max_dist, device=L.device)
    seed_out = torch.where(occupied, 0.0, inf)
    seed_in = torch.where(occupied, inf, 0.0)
    return (_signed_field(occupied, observed, seed_out, seed_in, v,
                          max_dist), observed, centers)


def esdf_at(cfg, state, points: Tensor, shape: tuple = (64, 64, 32),
            max_dist: float = 5.0) -> Tensor:
    """Signed distance at query points (N, 3): the covering region (its
    corner is the query box's minimum less two voxels), then an
    observation-weighted trilinear blend (unobserved corners are dropped
    and the weights renormalised; a cell with none reads ``max_dist``). A
    query outside the region reads ``max_dist``, not a border value."""
    v = cfg.voxel_size
    lo = torch.amin(points, dim=0) - 2.0 * v
    esdf, observed, _ = esdf_region(cfg, state, lo, shape=shape,
                                    max_dist=max_dist)
    base = torch.floor(lo * _inv(v)) * v
    u = (points - base) * _inv(v) - 0.5           # centre-of-voxel coords
    hi_ok = torch.tensor([shape[0] - 1.001, shape[1] - 1.001,
                          shape[2] - 1.001], dtype=torch.float32,
                         device=points.device)
    in_region = torch.all((u >= -0.5) & (u <= hi_ok + 0.5), dim=-1)
    u = torch.minimum(torch.clamp(u, min=0.0), hi_ok)
    i0 = torch.floor(u).to(torch.int64)
    f = u - i0
    vals = torch.zeros_like(points[:, 0])
    wsum = torch.zeros_like(points[:, 0])
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wgt = ((f[:, 0] if dx else 1 - f[:, 0])
                       * (f[:, 1] if dy else 1 - f[:, 1])
                       * (f[:, 2] if dz else 1 - f[:, 2]))
                ix, iy, iz = i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz
                wgt = wgt * observed[ix, iy, iz]
                vals = vals + wgt * esdf[ix, iy, iz]
                wsum = wsum + wgt
    out = torch.where(wsum > 1e-6, vals / torch.clamp(wsum, min=1e-6),
                      max_dist)
    return torch.where(in_region, out, max_dist)
