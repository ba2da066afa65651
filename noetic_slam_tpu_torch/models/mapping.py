"""Map maintenance nodes: sparse keyframe map + dense map recorder (port of
``noetic_slam_tpu.models.mapping``).

Equivalents of the reference's two mapping consumers, expressed as
in-program composition instead of topic subscribers:

- ``KeyframeMap`` ~ dlio::MapNode (src/dlio/src/dlio/map.cc:15-111): keeps
  the voxel-filtered union of keyframe clouds, periodic publish becomes an
  on-demand ``cloud()``; the ``save_pcd`` service (map.cc:81-110,
  srv/save_pcd.srv) becomes ``save_pcd(leaf_size, path)``.
- ``DenseMapRecorder`` ~ Dliomapping_Node (src/dliomapping/
  dliomapping.cpp:41-99): accumulates world-frame deskewed clouds and
  writes rolling PLY shards every ``shard_every`` scans and at close().

Device reads go through ``utils.host.to_host``: ``KeyframeMap.update``
fetches all of its new keyframes in one batch of copies (the JAX module
fetches one keyframe at a time).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from noetic_slam_tpu_torch.io.export import write_pcd, write_ply
from noetic_slam_tpu_torch.utils.host import to_host


def _voxel_downsample_np(xyz: np.ndarray, leaf: float) -> np.ndarray:
    """Host-side voxel-grid centroid filter (export path, not hot)."""
    if leaf <= 0 or len(xyz) == 0:
        return xyz
    keys = np.floor(xyz / leaf).astype(np.int64)
    packed = (keys[:, 0] * 73856093) ^ (keys[:, 1] * 19349663) ^ (
        keys[:, 2] * 83492791)
    order = np.argsort(packed, kind="stable")
    packed_s = packed[order]
    xyz_s = xyz[order]
    first = np.concatenate([[True], packed_s[1:] != packed_s[:-1]])
    seg = np.cumsum(first) - 1
    n = seg[-1] + 1 if len(seg) else 0
    sums = np.zeros((n, 3))
    np.add.at(sums, seg, xyz_s)
    counts = np.zeros((n,))
    np.add.at(counts, seg, 1.0)
    return (sums / counts[:, None]).astype(np.float32)


class KeyframeMap:
    """Sparse map = union of keyframe clouds (already world-corrected in the
    odometry state). Pulls only *new* keyframes per update (one batch of
    copies for all of them), mirroring MapNode's incremental
    accumulation."""

    def __init__(self, leaf_size: float = 0.25):
        self.leaf_size = leaf_size
        self._clouds: list[np.ndarray] = []
        self._n_kf_seen = 0

    def update(self, odom_state) -> int:
        """Ingest keyframes added since the last call. Returns new count."""
        n = int(odom_state.kf_count)
        lo = self._n_kf_seen
        new = max(n - lo, 0)
        if new:
            xyz, valid = to_host(odom_state.kf_xyz[lo:n],
                                 odom_state.kf_valid[lo:n])
            for i in range(new):
                cloud = xyz[i][valid[i]]
                if self.leaf_size > 0:
                    cloud = _voxel_downsample_np(cloud, self.leaf_size)
                self._clouds.append(cloud)
        self._n_kf_seen = n
        return new

    def cloud(self) -> np.ndarray:
        if not self._clouds:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(self._clouds)

    def save_pcd(self, leaf_size: float, save_path: str) -> bool:
        """save_pcd service semantics (map.cc:81-110): voxelize the full map
        with the requested leaf and write ``<save_path>/dlio_map.pcd``."""
        cloud = self.cloud()
        if len(cloud) == 0:
            return False
        cloud = _voxel_downsample_np(cloud, leaf_size)
        try:
            write_pcd(os.path.join(save_path, "dlio_map.pcd"), cloud)
            return True
        except OSError:
            return False


class DenseMapRecorder:
    """Accumulates world-frame deskewed clouds; writes rolling PLY shards
    (timestamped like dliomapping.cpp:64-86)."""

    def __init__(self, out_dir: str, shard_every: int = 1000,
                 max_points_per_scan: Optional[int] = None):
        self.out_dir = out_dir
        self.shard_every = shard_every
        self.max_points = max_points_per_scan
        self._bufs: list[np.ndarray] = []
        self._count = 0
        self._shard_idx = 0
        os.makedirs(out_dir, exist_ok=True)

    def add(self, world_xyz, world_valid) -> None:
        xyz, valid = to_host(world_xyz, world_valid)
        cloud = xyz[valid]
        if self.max_points is not None and len(cloud) > self.max_points:
            cloud = cloud[:: len(cloud) // self.max_points + 1]
        self._bufs.append(cloud.astype(np.float32))
        self._count += 1
        if self._count % self.shard_every == 0:
            self._write_shard()

    def _write_shard(self) -> None:
        if not self._bufs:
            return
        cloud = np.concatenate(self._bufs)
        name = f"{int(time.time())}_{self._shard_idx}.ply"
        write_ply(os.path.join(self.out_dir, name), cloud)
        self._bufs = []
        self._shard_idx += 1

    def close(self) -> None:
        self._write_shard()
