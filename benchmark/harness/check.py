"""The comparison that decides ``correct``: what the window produced,
against the benchmark's own ground truth and plain reference.

Numbers worked out; a cell compares those its ``limits/<cell>.json``
names, each against its limit, and prints the rest:

- ``missing_poses``: scans handed over in the window with no pose in the
  trajectory that ``flush()`` returns (exact: limit 0);
- ``lost_keyframes``: keyframes the sync lost (exact: limit 0);
- ``pose_err_m``: the median, over the window's scans, of each scan's
  pose error against the simulator's path, taken on the motion since the
  scan before (so that drift does not add up): the deskew and the
  registration of a typical scan;
- ``pose_jumps``: the window's scans whose error, taken so, passes the
  map backend's ``jump_m``: a scan placed that far off writes its
  surfaces out of place in the map (exact: limit 0);
- ``ate_m``: the RMS position error of the window's poses against the
  path after a rigid alignment (the port's ``synthetic.ate_rmse``, worked
  out again): drift, printed (the control's rounding reads as much as a
  sound run's drift);
- the map's numbers, from the module of the configuration's map backend
  (``maps/<dlio.map_backend>.py``, found by ``spec.map_module``): its
  ``numbers(rec, checks)`` and ``control(rec, checks)``, for the maps a
  traffic file's ``checks`` names.

The pose numbers are worked out in every cell. The helpers that place a
scan's points in the world (``scan_index``, ``wire_points``,
``world_points``) are here, for every backend's reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness import spec
from benchmark.reference import truth


def scan_index(stamps, sensor) -> np.ndarray:
    """The scan each trajectory stamp belongs to (a stamp lies in its
    sweep: at the middle without per-point times, at the median column
    time with them)."""
    return np.floor((np.asarray(stamps) - float(sensor.sweep_start(0)))
                    / sensor.period + 1e-6).astype(np.int64)


def _window(rec):
    """The window's trajectory rows, their scan indices, and the path's
    poses at their stamps."""
    traj = rec.traj
    idx = scan_index(traj[:, 0], rec.sensor)
    w = (idx >= rec.first_scan) & (idx < rec.end_scan)
    R_gt, p_gt = rec.sensor.truth(traj[w, 0])
    return traj[w], idx[w], R_gt, p_gt


def pose_numbers(rec, R_est=None, p_est=None) -> tuple:
    """{number: value} of the window's poses, and the per-scan errors.
    ``R_est``, ``p_est`` stand in for the program's poses (the control)."""
    rows, idx, R_gt, p_gt = _window(rec)
    handed = rec.end_scan - rec.first_scan
    if R_est is None:
        R_est, p_est = truth.quat_to_mat(rows[:, 4:8]), rows[:, 1:4]
    err = truth.relative_error(idx, R_est, p_est, R_gt, p_gt, 1)
    jump = _maps(rec).jump_m(rec.dlio)
    out = {"missing_poses": int(handed - len(np.unique(idx))),
           "pose_err_m": float(np.median(err)) if len(err) else float("inf"),
           "pose_jumps": int(np.sum(err > jump)) if len(err) else 1,
           "ate_m": truth.ate_rmse(rows[:, 0], p_est, rows[:, 0], p_gt)
           if len(rows) >= 3 else float("inf")}
    return out, err


def wire_points(xyz: np.ndarray) -> np.ndarray:
    """The scan as the configuration's quantized wire carries it
    (``preproc.quantized_wire``): int16 steps of max |coordinate| / 32766
    (at least 0.1 mm), decoded in float64."""
    xyz_f = np.where(np.isfinite(xyz), xyz, 1e6).astype(np.float32)
    ok = np.all(np.abs(xyz_f) < 1e5, axis=-1)
    amax = float(np.abs(np.where(ok[:, None], xyz_f, 0.0)).max()) \
        if len(xyz_f) else 0.0
    scale = max(amax / 32766.0, 1e-4)
    q = np.clip(np.round(xyz_f / scale), -32766, 32766)
    out = q.astype(np.float64) * float(np.float32(scale))
    return np.where(ok[:, None], out, np.nan)


def world_points(rec, i, row, dev):
    """Scan ``i``'s points in the world, as the program's pose ``row``
    places them; valid rows after the configuration's crop box."""
    header, xyz, pt = rec.scans_by_index[i]
    if rec.dlio["preproc"]["quantized_wire"]:
        xyz = wire_points(xyz)
    x = torch.as_tensor(np.asarray(xyz, np.float64), device=dev)
    crop = float(rec.dlio["preproc"]["crop_size"])
    valid = (torch.isfinite(x).all(-1) & (x.abs() < 1e5).all(-1)
             & ~(x.abs() <= crop).all(-1))
    R = torch.as_tensor(truth.quat_to_mat(row[None, 4:8])[0], device=dev)
    p = torch.as_tensor(np.asarray(row[1:4], np.float64), device=dev)
    if pt is not None and rec.dlio["preproc"]["deskew"]:
        # the sweep's own motion, from the path, about the pose's stamp,
        # at each point's time as the wire carries it (float16 with the
        # quantized wire)
        if rec.dlio["preproc"]["quantized_wire"]:
            pt = pt.astype(np.float16).astype(np.float64)
        Rc, pc = rec.sensor.truth(header + pt)
        Rs, ps = rec.sensor.truth(np.array([row[0]]))
        Rc_t = torch.as_tensor(Rc, device=dev)
        pc_t = torch.as_tensor(pc - ps[0], device=dev)
        w_path = torch.einsum("nij,nj->ni", Rc_t, x) + pc_t
        x = w_path @ torch.as_tensor(Rs[0], device=dev)   # Rs^T w, rows
    return x @ R.T + p, valid, p


def _maps(rec):
    return spec.map_module(rec.dlio["map_backend"])


def control(rec, checks) -> dict:
    """The control's numbers: the reference put in the program's place
    and worked out in TF32 (its poses, and its map's sample positions),
    against the float64 reference."""
    _, _, R_gt, p_gt = _window(rec)
    r32 = lambda a: to_tf32(torch.as_tensor(a)).numpy()     # noqa: E731
    out, err = pose_numbers(rec, r32(R_gt), r32(p_gt))
    out = {k: out[k] for k in ("pose_err_m", "pose_jumps", "ate_m")}
    out["pose_err_max_m"] = float(err.max()) if len(err) else None
    out.update(_maps(rec).control(rec, checks))
    return out


def compare(rec, checks):
    """Every number of the cell's checks, {name: value}, and the window's
    per-scan pose errors."""
    out, err = pose_numbers(rec)
    out["lost_keyframes"] = int(rec.lost_keyframes)
    out.update(_maps(rec).numbers(rec, checks))
    return out, err


def judge(numbers: dict, limits: dict) -> tuple:
    """({number: {"value", "limit"}}, correct) for the cell's ``limits``:
    correct when every number limited is there, finite, and within its
    limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in limits if k in numbers}
    ok = len(checks) == len(limits) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return checks, ok


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Values rounded to TF32 (10 bits of mantissa), in their dtype."""
    b = x.to(torch.float32).view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32).to(x.dtype)
