"""Poses against the simulator's ground truth (plain NumPy, float64).

The ground truth is the benchmark's own path model (``gen.path``); these
functions read the program's poses only to judge them.
"""

from __future__ import annotations

import numpy as np


def quat_to_mat(q) -> np.ndarray:
    """(n, 4) wxyz -> (n, 3, 3)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], axis=1)


def relative_error(idx, R_est, p_est, R_gt, p_gt, span: int) -> np.ndarray:
    """Translation error of the motion over ``span`` scans, in the earlier
    scan's frame: for every pair of rows whose scan indices ``idx`` differ
    by ``span``, | Re_a^T (pe_b - pe_a) - Rg_a^T (pg_b - pg_a) |. The
    world frames of the two sides need not agree."""
    pos = {int(k): n for n, k in enumerate(idx)}
    a = np.array([pos[k] for k in pos if k + span in pos], np.int64)
    if not len(a):
        return np.zeros(0)
    b = np.array([pos[int(idx[j]) + span] for j in a], np.int64)
    de = np.einsum("nji,nj->ni", R_est[a], p_est[b] - p_est[a])
    dg = np.einsum("nji,nj->ni", R_gt[a], p_gt[b] - p_gt[a])
    return np.linalg.norm(de - dg, axis=-1)


def aligned_error(p_est, p_gt) -> np.ndarray:
    """Position errors after the rigid (Umeyama, no scale) alignment of
    ``p_est`` onto ``p_gt``."""
    e, g = np.asarray(p_est, np.float64), np.asarray(p_gt, np.float64)
    mu_e, mu_g = e.mean(0), g.mean(0)
    H = (e - mu_e).T @ (g - mu_g)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    return np.linalg.norm((e - mu_e) @ R.T + mu_g - g, axis=-1)


def ate_rmse(traj_stamps, traj_pos, gt_stamps, gt_pos) -> float:
    """Absolute trajectory error RMSE against the time-interpolated ground
    truth after the rigid alignment: the port's ``utils.synthetic.
    ate_rmse``, worked out here so that the yardstick does not move with
    the program."""
    gt = np.stack([np.interp(traj_stamps, gt_stamps, gt_pos[:, k])
                   for k in range(3)], axis=-1)
    return float(np.sqrt(np.mean(aligned_error(traj_pos, gt) ** 2)))
