"""Motion deskew (port of ``noetic_slam_tpu.ops.deskew``): each point is
moved into the world frame by the interpolated pose of its timestamp,
composed with the baselink<-lidar extrinsic:
``p_world = R_frame @ (R_ext @ p + t_ext) + p_frame``.
Memory-bound elementwise work; plain torch."""

from __future__ import annotations

import torch

from noetic_slam_tpu_torch.ops.pointcloud import SENTINEL, PreparedScan
from noetic_slam_tpu_torch.utils.geometry import quat_rotate

Tensor = torch.Tensor


def deskew_points(scan: PreparedScan, frames_q: Tensor, frames_p: Tensor,
                  R_ext: Tensor, t_ext: Tensor) -> Tensor:
    """(N, 3) world-frame points; invalid slots keep the sentinel."""
    q = frames_q[scan.frame_idx]
    p = frames_p[scan.frame_idx]
    local = scan.xyz @ R_ext.T + t_ext
    world = quat_rotate(q, local) + p
    return torch.where(scan.valid[:, None], world, SENTINEL)


def transform_cloud(xyz: Tensor, valid: Tensor, T: Tensor) -> Tensor:
    """Rigid transform of a masked cloud by one 4x4 (sentinel preserved)."""
    out = xyz @ T[:3, :3].T + T[:3, 3]
    return torch.where(valid[:, None], out, SENTINEL)
