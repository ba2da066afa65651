"""Host-side keyframe archive + incrementally corrected dense-map volume
(port of ``noetic_slam_tpu.runtime.archive``).

Same design as the JAX module: every keyframe ever created is kept on the
host (int16 local-frame clouds at an adaptive per-keyframe scale), and an
UNCLAMPED "archive volume" (``models.tsdf.NO_CLAMP``, or occupancy
``l_min``/``l_max`` at -/+1e30) always equals the sum of every entry's
contribution at its current pose. A pose-graph correction subtracts each
moved entry at its old pose (sign -1) and re-adds it at the new one, so it
costs O(moved keyframes), and payload rows no moved entry touches are
never read or written. ``snapshot_live`` clamps once and becomes the live
map after a closure.

Every fuse goes through ``_fuse_scan``: ``_CHUNK_KF`` entries per fusion
call (the per-call ``scan_block_cap`` applies to a chunk's stream, so the
chunking of real entries is JAX's), each with its sign. On the card the
payload update is kernel B (TSDF) or C (occupancy).

The cancellation contract: an entry's sample stream must not depend on
where it sits in a chunk or a bucket, so that a sign -1 fuse scatters the
exact negation of its +1 stream. So the local -> world transform is
explicit multiply-adds in a fixed order (no batched matmul, whose GEMM can
change with the batch size), the samples are generated per entry, and the
block-major sorts of the shared skeleton are stable. A chunk made only of
sign-0 padding maps every sample to the drop key; it is skipped (the same
result, without its launches).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from noetic_slam_tpu_torch import resolve_device
from noetic_slam_tpu_torch.models import occupancy as occ_mod
from noetic_slam_tpu_torch.models import tsdf as tsdf_mod
from noetic_slam_tpu_torch.utils.geometry import quat_to_mat, quat_to_mat_np
from noetic_slam_tpu_torch.utils.host import to_device

Tensor = torch.Tensor

_QMAX = 32766.0
_CHUNK_KF = 4     # keyframes per fusion call


@dataclasses.dataclass
class ArchiveEntry:
    """One keyframe, local-frame quantized, plus the pose at which it is
    currently fused into the archive volume."""
    q: np.ndarray          # (4,) f32 wxyz — fused-at pose
    p: np.ndarray          # (3,) f32
    xyz_q: np.ndarray      # (N, 3) int16 local-frame
    scale: float
    valid: np.ndarray      # (N,) bool


def _world(xyz_q: Tensor, scale: Tensor, q: Tensor, p: Tensor) -> Tensor:
    """World-frame cloud of one entry: dequantize, then R x + p as
    explicit multiply-adds, the same operations whatever the batch."""
    local = xyz_q.to(torch.float32) * scale
    R = quat_to_mat(q)
    lx, ly, lz = local[:, 0:1], local[:, 1:2], local[:, 2:3]
    return lx * R[:, 0] + ly * R[:, 1] + lz * R[:, 2] + p


def _fuse_entry(cfg, vol, xyz_q, scale, valid, q, p, sign,
                backend: str = "tsdf"):
    """Single-keyframe fuse (tests and golden references; the system
    routes everything through ``_fuse_scan``)."""
    world = _world(xyz_q, scale, q, p)
    if backend == "occupancy":
        return occ_mod.integrate_signed(cfg, vol, world, valid, p, sign)
    return tsdf_mod.integrate_signed(cfg, vol, world, valid, p, sign)


def _fuse_scan(cfg, vol, xyz_q: Tensor, scale: Tensor, valid: Tensor,
               q: Tensor, p: Tensor, sign: np.ndarray,
               backend: str = "tsdf"):
    """Fuse B keyframe contributions, ``_CHUNK_KF`` per fusion call.
    ``xyz_q (B, N, 3) int16``, ``sign (B,)`` host values in {+1, -1, 0} (0
    = padding, whose zero weights or deltas drop every sample). B must be
    a multiple of ``_CHUNK_KF``. Updates ``vol``'s payload in place and
    returns it."""
    B = xyz_q.shape[0]
    sg = to_device(np.asarray(sign, np.float32), xyz_q.device)
    for c0 in range(0, B, _CHUNK_KF):
        if not np.any(sign[c0:c0 + _CHUNK_KF]):
            continue                  # padding only: nothing to fuse
        parts = []
        for b in range(c0, c0 + _CHUNK_KF):
            world = _world(xyz_q[b], scale[b], q[b], p[b])
            if backend == "occupancy":
                pos, delta = occ_mod._beam_samples(cfg, world, valid[b], p[b])
                parts.append((pos, delta * sg[b]))
            else:
                pos, sdf, w = tsdf_mod._ray_samples(cfg, world, valid[b],
                                                    p[b])
                parts.append((pos, sdf, w * sg[b]))
        cat = [torch.cat(ch) for ch in zip(*parts)]
        if backend == "occupancy":
            vol = occ_mod._integrate_deltas(cfg, vol, *cat)
        else:
            vol = tsdf_mod._integrate_samples(cfg, vol, *cat)
    return vol


def _snapshot_tsdf(lcfg, vol: tsdf_mod.TsdfState) -> tsdf_mod.TsdfState:
    """Archive volume -> fresh live TsdfState: the live ``max_weight``
    clamp applied once, every leaf copied (the live map is updated in
    place per scan; no aliasing allowed)."""
    w = torch.clamp(vol.weight, min=0.0)    # signed-cancel residuals
    clamped = torch.clamp(w, max=lcfg.max_weight)
    wsum = torch.where(w > 1e-12,
                       vol.wsum * (clamped / torch.clamp(w, min=1e-12)), 0.0)
    return tsdf_mod.TsdfState(
        dir_keys=vol.dir_keys.clone(), dir_slots=vol.dir_slots.clone(),
        num_blocks=vol.num_blocks.clone(), wsum=wsum, weight=clamped,
        dropped=vol.dropped.clone())


def _snapshot_occ(lcfg, vol: occ_mod.OccupancyState
                  ) -> occ_mod.OccupancyState:
    return occ_mod.OccupancyState(
        dir_keys=vol.dir_keys.clone(), dir_slots=vol.dir_slots.clone(),
        num_blocks=vol.num_blocks.clone(),
        logodds=torch.clamp(vol.logodds, lcfg.l_min, lcfg.l_max),
        dropped=vol.dropped.clone())


class _EntriesView:
    """Dict-like view of the archive's stacked host storage (keyed by graph
    node id); reads return copies, writes go through ``__setitem__``."""

    def __init__(self, ar: "KeyframeArchive"):
        self._ar = ar

    def __len__(self) -> int:
        return len(self._ar._idx)

    def __contains__(self, node) -> bool:
        return int(node) in self._ar._idx

    def __iter__(self) -> Iterator[int]:
        return iter(self._ar._idx)

    def keys(self):
        return self._ar._idx.keys()

    def items(self):
        for node in self._ar._idx:
            yield node, self[node]

    def __getitem__(self, node) -> ArchiveEntry:
        i = self._ar._idx[int(node)]
        return ArchiveEntry(
            q=self._ar._q[i].copy(), p=self._ar._p[i].copy(),
            xyz_q=self._ar._xyz[i].copy(), scale=float(self._ar._scale[i]),
            valid=self._ar._valid[i].copy())

    def __setitem__(self, node, e: ArchiveEntry) -> None:
        self._ar._set_entry(int(node), e)


class KeyframeArchive:
    def __init__(self, map_cfg, backend: str = "tsdf", device=None):
        self.backend = backend
        self.device = resolve_device(device)
        self.live_cfg = map_cfg
        if backend == "occupancy":
            self.cfg = dataclasses.replace(map_cfg, l_min=-1e30, l_max=1e30)
        else:
            self.cfg = dataclasses.replace(map_cfg,
                                           max_weight=tsdf_mod.NO_CLAMP)
        self.volume = self._empty_volume()
        # stacked host storage (insertion-ordered; _idx maps node -> row).
        # _q/_p are the FUSE-time poses (a later subtract must replay the
        # exact pose each cloud was fused at); _q_exact/_p_exact mirror the
        # graph's current optimised pose of every entry, which closure
        # maths against archived entries must use.
        self._idx: Dict[int, int] = {}
        self._q = np.zeros((0, 4), np.float32)
        self._p = np.zeros((0, 3), np.float32)
        self._q_exact = np.zeros((0, 4), np.float32)
        self._p_exact = np.zeros((0, 3), np.float32)
        self._xyz = np.zeros((0, 0, 3), np.int16)
        self._scale = np.zeros((0,), np.float32)
        self._valid = np.zeros((0, 0), bool)
        self._n = 0

    def _empty_volume(self):
        if self.backend == "occupancy":
            return occ_mod.init_occupancy(self.cfg, self.device)
        return tsdf_mod.init_tsdf(self.cfg, self.device)

    def __len__(self) -> int:
        return self._n

    @property
    def entries(self) -> _EntriesView:
        return _EntriesView(self)

    # ------------------------------------------------------------ storage
    def _ensure(self, extra: int, n_pts: int) -> None:
        cap = self._q.shape[0]
        need = self._n + extra
        if self._xyz.shape[1] == 0 and n_pts:
            self._xyz = np.zeros((cap, n_pts, 3), np.int16)
            self._valid = np.zeros((cap, n_pts), bool)
        if need <= cap:
            return
        new_cap = max(64, cap)
        while new_cap < need:
            new_cap *= 2
        grow = lambda a, fill=0: np.concatenate(            # noqa: E731
            [a, np.full((new_cap - cap,) + a.shape[1:], fill, a.dtype)])
        self._q, self._p = grow(self._q), grow(self._p)
        self._q_exact = grow(self._q_exact)
        self._p_exact = grow(self._p_exact)
        self._xyz, self._scale = grow(self._xyz), grow(self._scale)
        self._valid = grow(self._valid, False)

    def _row(self, node: int) -> int:
        i = self._idx.get(node)
        if i is None:
            i = self._n
            self._idx[node] = i
            self._n += 1
        return i

    def _set_entry(self, node: int, e: ArchiveEntry) -> None:
        if node not in self._idx:
            self._ensure(1, e.xyz_q.shape[0])
        i = self._row(node)
        self._q[i] = self._q_exact[i] = np.asarray(e.q, np.float32)
        self._p[i] = self._p_exact[i] = np.asarray(e.p, np.float32)
        self._xyz[i] = np.asarray(e.xyz_q, np.int16)
        self._scale[i] = float(e.scale)
        self._valid[i] = np.asarray(e.valid, bool)

    def pose_of(self, node: int):
        """(q, p) copies of the entry's EXACT (optimiser-current) pose."""
        i = self._idx[int(node)]
        return self._q_exact[i].copy(), self._p_exact[i].copy()

    # ------------------------------------------------------------- ingest
    def add(self, node: int, q, p, xyz_world, valid) -> None:
        """Archive one keyframe (``add_batch`` of one)."""
        self.add_batch([int(node)], np.asarray(q, np.float32)[None],
                       np.asarray(p, np.float32)[None],
                       np.asarray(xyz_world, np.float32)[None],
                       np.asarray(valid, bool)[None])

    def add_batch(self, nodes, qs, ps, xyz_world, valid) -> None:
        """Archive B keyframes (world-frame clouds at poses (q, p)) and
        fuse them into the archive volume."""
        B = len(nodes)
        if B == 0:
            return
        qs = np.asarray(qs, np.float32)
        ps = np.asarray(ps, np.float32)
        valid = np.asarray(valid, bool)
        xyz_world = np.asarray(xyz_world, np.float32)
        self._ensure(B, xyz_world.shape[1])
        rows = np.zeros((B,), np.int64)
        for k, node in enumerate(nodes):
            i = rows[k] = self._row(int(node))
            local = (xyz_world[k] - ps[k]) @ quat_to_mat_np(qs[k])
            local = np.where(valid[k][:, None], local, 0.0).astype(np.float32)
            amax = float(np.abs(local).max()) if local.size else 0.0
            scale = max(amax / _QMAX, 1e-4)
            self._xyz[i] = np.clip(np.round(local / scale), -_QMAX, _QMAX
                                   ).astype(np.int16)
            self._scale[i] = scale
            self._q[i], self._p[i], self._valid[i] = qs[k], ps[k], valid[k]
            self._q_exact[i], self._p_exact[i] = qs[k], ps[k]
        self._dispatch_fuse(rows, self._q[rows], self._p[rows],
                            np.ones((B,), np.float32))

    # ------------------------------------------------------- pose updates
    def apply_poses(self, node_q: np.ndarray, node_p: np.ndarray,
                    eps_t: float | None = None,
                    eps_r: float | None = None) -> int:
        """Move archived keyframes to their optimised graph poses: subtract
        each moved entry at its old pose and re-add it at the new one, in
        one batch. Returns the number re-fused. A keyframe whose pose moved
        less than eps_t = voxel/4 and eps_r = voxel/(4 max_range) (the
        defaults) is left: its samples would move by at most half a voxel.
        Every entry's exact pose follows the graph regardless."""
        if eps_t is None:
            eps_t = 0.25 * self.cfg.voxel_size
        if eps_r is None:
            eps_r = 0.25 * self.cfg.voxel_size / max(self.cfg.max_range, 1.0)
        if self._n == 0:
            return 0
        nodes = np.fromiter(self._idx.keys(), np.int64, len(self._idx))
        rows = np.fromiter(self._idx.values(), np.int64, len(self._idx))
        keep = nodes < len(node_p)
        nodes, rows = nodes[keep], rows[keep]
        nq = np.asarray(node_q, np.float32)[nodes]
        npos = np.asarray(node_p, np.float32)[nodes]
        self._q_exact[rows] = nq
        self._p_exact[rows] = npos
        dt = np.linalg.norm(npos - self._p[rows], axis=-1)
        dots = np.abs(np.sum(nq * self._q[rows], axis=-1))
        dr = 2.0 * np.arccos(np.clip(dots, 0.0, 1.0))
        moved_m = (dt > eps_t) | (dr > eps_r)
        rows_m = rows[moved_m]
        if len(rows_m) == 0:
            return 0
        self._dispatch_fuse(
            np.concatenate([rows_m, rows_m]),
            np.concatenate([self._q[rows_m], nq[moved_m]]),
            np.concatenate([self._p[rows_m], npos[moved_m]]),
            np.concatenate([np.full(len(rows_m), -1.0, np.float32),
                            np.full(len(rows_m), 1.0, np.float32)]))
        self._q[rows_m] = nq[moved_m]
        self._p[rows_m] = npos[moved_m]
        return int(len(rows_m))

    # fixed fuse bucket sizes (entries per dispatch), as in JAX: large
    # move sets decompose into repeated largest buckets plus a tail, and
    # padding entries carry sign 0
    _BUCKETS = (2 * _CHUNK_KF, 16 * _CHUNK_KF, 64 * _CHUNK_KF)

    def _dispatch_fuse(self, rows: np.ndarray, qs: np.ndarray,
                       ps: np.ndarray, signs: np.ndarray) -> None:
        B = len(rows)
        big = self._BUCKETS[-1]
        off = 0
        while off < B:
            take = min(B - off, big)
            m = next(b for b in self._BUCKETS if b >= take)
            sl = slice(off, off + take)
            pad = m - take
            r, q, p, s = rows[sl], qs[sl], ps[sl], signs[sl]
            if pad:
                r = np.concatenate([r, np.zeros((pad,), rows.dtype)])
                q = np.concatenate(
                    [q, np.tile(np.asarray([1, 0, 0, 0], np.float32),
                                (pad, 1))])
                p = np.concatenate([p, np.zeros((pad, 3), np.float32)])
                s = np.concatenate([s, np.zeros((pad,), np.float32)])
            dev = lambda a: to_device(a, self.device)       # noqa: E731
            self.volume = _fuse_scan(
                self.cfg, self.volume, dev(self._xyz[r]),
                dev(self._scale[r]), dev(self._valid[r]), dev(q), dev(p), s,
                backend=self.backend)
            off += take

    def warmup(self, n_pts: int | None = None) -> None:
        """The JAX method pre-compiles every fuse bucket on sign-0 entries;
        eager torch compiles nothing, and a padding-only chunk is skipped,
        so this does nothing. Kept for the callers' sake."""

    # ------------------------------------------------------------ outputs
    def snapshot_live(self):
        """Fresh live-map state (clamped per the live config, every leaf
        copied)."""
        if self.backend == "occupancy":
            return _snapshot_occ(self.live_cfg, self.volume)
        return _snapshot_tsdf(self.live_cfg, self.volume)

    # -------------------------------------------------------- persistence
    def pack(self) -> dict:
        """Stacked host arrays for checkpointing, in node order."""
        if self._n == 0:
            return {}
        nodes = np.asarray(sorted(self._idx), np.int32)
        rows = np.asarray([self._idx[int(n)] for n in nodes], np.int64)
        return {
            "nodes": nodes,
            "q": self._q[rows].copy(),
            "p": self._p[rows].copy(),
            "q_exact": self._q_exact[rows].copy(),
            "p_exact": self._p_exact[rows].copy(),
            "xyz_q": self._xyz[rows].copy(),
            "scale": self._scale[rows].copy(),
            "valid": self._valid[rows].copy(),
        }

    def unpack(self, data: dict) -> None:
        """Restore entries (a JAX ``pack()`` loads too) and replay them
        into a fresh archive volume."""
        self.volume = self._empty_volume()
        self._idx = {}
        self._n = 0
        self._q = np.zeros((0, 4), np.float32)
        self._p = np.zeros((0, 3), np.float32)
        self._q_exact = np.zeros((0, 4), np.float32)
        self._p_exact = np.zeros((0, 3), np.float32)
        self._xyz = np.zeros((0, 0, 3), np.int16)
        self._scale = np.zeros((0,), np.float32)
        self._valid = np.zeros((0, 0), bool)
        if not data or "nodes" not in data:
            return
        nodes = np.asarray(data["nodes"])
        B = len(nodes)
        self._ensure(B, np.asarray(data["xyz_q"]).shape[1])
        for i, node in enumerate(nodes):
            self._idx[int(node)] = i
        self._q[:B] = np.asarray(data["q"], np.float32)
        self._p[:B] = np.asarray(data["p"], np.float32)
        self._q_exact[:B] = np.asarray(data.get("q_exact", data["q"]),
                                       np.float32)
        self._p_exact[:B] = np.asarray(data.get("p_exact", data["p"]),
                                       np.float32)
        self._xyz[:B] = np.asarray(data["xyz_q"], np.int16)
        self._scale[:B] = np.asarray(data["scale"], np.float32)
        self._valid[:B] = np.asarray(data["valid"], bool)
        self._n = B
        self._dispatch_fuse(np.arange(B, dtype=np.int64), self._q[:B],
                            self._p[:B], np.ones((B,), np.float32))
