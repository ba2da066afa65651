"""TSDF -> triangle mesh extraction, naive surface nets (port of
``noetic_slam_tpu.io.meshing``).

The map-export role of the absent tsdf_map backend's meshing output
(reference README.md:30-40 mentions CHAD TSDF / Voxblox-class backends,
which ship mesh integrators). Implemented as *surface nets* over the sparse
voxel set — one vertex per sign-changing dual cell (placed at the mean of
its edge crossings), one quad per sign-changing primal edge — which avoids
marching cubes' 256-case tables while producing a manifold-ish surface.

Runs host-side in vectorized NumPy over the (sparse) allocated voxels; the
sparse lookup is a searchsorted over sorted voxel ids (the device-side
block directory is sorted the same way). The map's four tensors come to the host in one
batch of copies (``utils.host.to_host``); the rest is the JAX module's
numpy code.
"""

from __future__ import annotations

import numpy as np

from noetic_slam_tpu_torch.models.tsdf import BLOCK, BLOCK_VOLUME, KEY_PAD
from noetic_slam_tpu_torch.utils.host import to_host


def _voxel_samples(cfg, state, min_weight: float):
    """Extract (ids (N, 3) int64 voxel coords, d (N,) tsdf) of observed
    voxels from a TsdfState."""
    keys, slots, wsum, weight = to_host(
        state.dir_keys, state.dir_slots, state.wsum, state.weight)
    tsdf = np.where(weight > 0.0, wsum / np.maximum(weight, 1e-12),
                    cfg.truncation)
    used = keys != KEY_PAD
    keys, slots = keys[used], slots[used]
    bx = (keys & 0x7FF) - 1024
    by = ((keys >> 11) & 0x7FF) - 1024
    bz = ((keys >> 22) & 0x3FF) - 512
    iv = np.arange(BLOCK_VOLUME)
    ix, iy, iz = iv & 7, (iv >> 3) & 7, (iv >> 6) & 7

    vx = (bx[:, None] * BLOCK + ix[None, :]).ravel()
    vy = (by[:, None] * BLOCK + iy[None, :]).ravel()
    vz = (bz[:, None] * BLOCK + iz[None, :]).ravel()
    d = tsdf[slots].ravel()
    w = weight[slots].ravel()
    keep = w >= min_weight
    coords = np.stack([vx, vy, vz], axis=-1)[keep]
    return coords.astype(np.int64), d[keep].astype(np.float64)


def _flat_ids(coords: np.ndarray) -> np.ndarray:
    """Pack voxel coords into sortable int64 ids (21 bits/axis)."""
    off = 1 << 20
    return ((coords[:, 2] + off) << 42) | ((coords[:, 1] + off) << 21) | (
        coords[:, 0] + off)


class _Lookup:
    def __init__(self, coords, values, default):
        self.ids = _flat_ids(coords)
        order = np.argsort(self.ids)
        self.ids = self.ids[order]
        self.values = values[order]
        self.default = default

    def get(self, coords):
        ids = _flat_ids(coords)
        pos = np.searchsorted(self.ids, ids)
        pos = np.clip(pos, 0, len(self.ids) - 1) if len(self.ids) else pos
        if len(self.ids) == 0:
            return np.full(len(ids), self.default), np.zeros(len(ids), bool)
        hit = self.ids[pos] == ids
        vals = np.where(hit, self.values[pos], self.default)
        return vals, hit

    def index(self, coords):
        ids = _flat_ids(coords)
        pos = np.searchsorted(self.ids, ids)
        pos = np.clip(pos, 0, len(self.ids) - 1)
        hit = self.ids[pos] == ids
        return pos, hit


_CORNERS = np.array([[x, y, z] for z in (0, 1) for y in (0, 1)
                     for x in (0, 1)])
# cell edges as corner index pairs (12 cube edges)
_EDGES = [(a, b) for a in range(8) for b in range(8)
          if a < b and np.sum(np.abs(_CORNERS[a] - _CORNERS[b])) == 1]


def extract_mesh(cfg, state, min_weight: float = 1.0):
    """Surface-nets mesh from a TsdfState.

    Returns (vertices (V, 3) float32 [m], triangles (F, 3) int32).
    """
    coords, d = _voxel_samples(cfg, state, min_weight)
    if len(coords) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    lut = _Lookup(coords, d, default=np.float64(cfg.truncation))

    # Candidate dual cells: anchored at every observed voxel (corners
    # v + {0,1}^3). Gather the 8 corner sdf values.
    corner_d = np.empty((len(coords), 8))
    corner_hit = np.empty((len(coords), 8), bool)
    for k, c in enumerate(_CORNERS):
        corner_d[:, k], corner_hit[:, k] = lut.get(coords + c)
    # A cell is active only if ALL corners are observed and straddle zero —
    # unobserved corners default to +trunc, which would fabricate a
    # crossing shell at the observation boundary (surface stays open
    # there instead).
    has_neg = (corner_d < 0).any(axis=1)
    has_pos = (corner_d > 0).any(axis=1)
    active = has_neg & has_pos & corner_hit.all(axis=1)
    cell_coords = coords[active]
    cd = corner_d[active]

    # Vertex = mean of edge zero-crossings within the cell.
    verts = np.zeros((len(cell_coords), 3))
    wsum = np.zeros((len(cell_coords), 1))
    for (a, b) in _EDGES:
        da, db = cd[:, a], cd[:, b]
        cross = (da < 0) != (db < 0)
        t = np.where(cross, da / np.where(da - db == 0, 1.0, da - db), 0.0)
        pt = _CORNERS[a] + t[:, None] * (_CORNERS[b] - _CORNERS[a])
        verts += np.where(cross[:, None], pt, 0.0)
        wsum += cross[:, None].astype(float)
    verts = cell_coords + verts / np.maximum(wsum, 1.0)
    verts_m = ((verts + 0.5) * cfg.voxel_size).astype(np.float32)

    cell_lut = _Lookup(cell_coords, np.arange(len(cell_coords)), -1)

    # Quads: one per sign-changing primal edge (v -> v+e_axis); the four
    # cells sharing that edge are v, v-e_b, v-e_c, v-e_b-e_c.
    tris = []
    axes = np.eye(3, dtype=np.int64)
    for axis in range(3):
        ea = axes[axis]
        eb, ec = axes[(axis + 1) % 3], axes[(axis + 2) % 3]
        d0 = d
        d1, hit1 = lut.get(coords + ea)
        cross = hit1 & ((d0 < 0) != (d1 < 0))
        base = coords[cross]
        flip = d0[cross] < 0
        quads = []
        ok = np.ones(len(base), bool)
        for offset in (np.zeros(3, np.int64), -eb, -eb - ec, -ec):
            vi, hit = cell_lut.index(base + offset)
            vi = cell_lut.values[vi] if len(cell_lut.ids) else vi
            ok &= hit
            quads.append(vi)
        q = np.stack(quads, axis=-1)[ok]
        fl = flip[ok]
        # orientation: flip winding when the edge goes from inside out
        q = np.where(fl[:, None], q[:, ::-1], q)
        tris.append(np.stack([q[:, 0], q[:, 1], q[:, 2]], axis=-1))
        tris.append(np.stack([q[:, 0], q[:, 2], q[:, 3]], axis=-1))
    if tris:
        faces = np.concatenate(tris).astype(np.int32)
    else:
        faces = np.zeros((0, 3), np.int32)
    return verts_m, faces
