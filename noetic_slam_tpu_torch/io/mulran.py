"""MulRan dataset reader.

The port's own copy of ``noetic_slam_tpu/io/mulran.py`` (numpy only);
``tests/test_torch_copies.py`` holds the two to identical reads.

Replaces the reference's Qt file player data layer
(src/file_player_mulran/src/ROSThread.cpp:95-284) with a plain Python
loader. Formats (from the reference parsers):

- ``sensor_data/data_stamp.csv``: ``<stamp_ns>,<sensor>`` rows, the global
  dispatch order (ROSThread.cpp:133-147).
- ``sensor_data/xsens_imu.csv``: ``stamp,qx,qy,qz,qw[,ex,ey,ez,gx,gy,gz,
  ax,ay,az,mx,my,mz]`` — 8-field (orientation only, version 1) or 17-field
  (version 2, gyro at cols 8-10, accel at 11-13) rows
  (ROSThread.cpp:172-249).
- ``sensor_data/gps.csv``: stamp + 12 doubles (lat/lon/alt + 9 cov)
  (ROSThread.cpp:148-170).
- ``sensor_data/Ouster/<stamp_ns>.bin``: raw float32 records
  ``x, y, z, intensity`` (OS1-64, ring = k % 64 + 1; no per-point time)
  (ROSThread.cpp:498-524).
- ``global_pose.csv``: stamp + row-major 3x4 world pose — ground truth
  (ROSThread.cpp:743-780).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class MulranDataset:
    root: str
    imu_stamps: np.ndarray       # (M,) float64 seconds
    imu_quat: np.ndarray         # (M, 4) wxyz orientation (sensor-reported)
    imu_gyro: np.ndarray         # (M, 3) rad/s (zeros for v1 logs)
    imu_accel: np.ndarray        # (M, 3) m/s^2 (zeros for v1 logs)
    imu_version: int
    scan_stamps: np.ndarray      # (S,) float64 seconds
    scan_files: list
    gps: Optional[np.ndarray]    # (G, 13) stamp + fields or None
    radar_stamps: np.ndarray     # (R,) float64 seconds (polar images)
    radar_files: list
    gt_stamps: Optional[np.ndarray]   # (T,) float64 seconds
    gt_poses: Optional[np.ndarray]    # (T, 3, 4) row-major world poses

    @classmethod
    def load(cls, root: str) -> "MulranDataset":
        sd = os.path.join(root, "sensor_data")

        # IMU
        imu_path = os.path.join(sd, "xsens_imu.csv")
        stamps, quat, gyro, accel = [], [], [], []
        version = 0
        if os.path.exists(imu_path):
            with open(imu_path) as f:
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) not in (8, 17):
                        continue
                    vals = [float(x) for x in parts]
                    stamps.append(vals[0] * 1e-9)
                    qx, qy, qz, qw = vals[1:5]
                    quat.append([qw, qx, qy, qz])
                    if len(parts) == 17:
                        version = 2
                        gyro.append(vals[8:11])
                        accel.append(vals[11:14])
                    else:
                        version = 1
                        gyro.append([0.0, 0.0, 0.0])
                        accel.append([0.0, 0.0, 0.0])

        # Scans
        ouster_dir = os.path.join(sd, "Ouster")
        scan_files, scan_stamps = [], []
        if os.path.isdir(ouster_dir):
            for name in sorted(os.listdir(ouster_dir)):
                if name.endswith(".bin"):
                    scan_files.append(os.path.join(ouster_dir, name))
                    scan_stamps.append(int(name[:-4]) * 1e-9)

        # Radar polar images (published as-is by the reference player,
        # ROSThread.cpp:561-597; listed here for export/analysis use)
        radar_dir = os.path.join(sd, "radar", "polar")
        radar_files, radar_stamps = [], []
        if os.path.isdir(radar_dir):
            for name in sorted(os.listdir(radar_dir)):
                if name.endswith(".png"):
                    radar_files.append(os.path.join(radar_dir, name))
                    radar_stamps.append(int(name.split(".")[0]) * 1e-9)

        # GPS
        gps_path = os.path.join(sd, "gps.csv")
        gps = None
        if os.path.exists(gps_path):
            try:
                gps = np.loadtxt(gps_path, delimiter=",", ndmin=2)
                gps[:, 0] *= 1e-9
            except Exception:
                gps = None

        # Ground truth
        gt_path = os.path.join(root, "global_pose.csv")
        gt_stamps = gt_poses = None
        if os.path.exists(gt_path):
            rows = np.loadtxt(gt_path, delimiter=",", ndmin=2)
            if rows.shape[1] == 13:
                gt_stamps = rows[:, 0] * 1e-9
                gt_poses = rows[:, 1:].reshape(-1, 3, 4)

        return cls(root, np.asarray(stamps), np.asarray(quat),
                   np.asarray(gyro), np.asarray(accel), version,
                   np.asarray(scan_stamps), scan_files, gps,
                   np.asarray(radar_stamps), radar_files, gt_stamps,
                   gt_poses)

    def read_scan(self, i: int) -> np.ndarray:
        """Scan i as (N, 4) float32: x, y, z, intensity (ROSThread.cpp
        binary record layout)."""
        raw = np.fromfile(self.scan_files[i], dtype=np.float32)
        return raw[: (len(raw) // 4) * 4].reshape(-1, 4)

    def events(self, kinds=("imu", "scan")) -> Iterator[tuple]:
        """Merged (stamp, kind, index) stream in time order — the
        replacement for data_stamp.csv dispatch (the csv is redundant with
        the per-sensor stamps and not always present). ``kinds`` may also
        include "gps" (gps.csv rows) and "radar" (polar image stamps) —
        the file player's remaining publisher threads
        (ROSThread.cpp:562-631)."""
        order = {"imu": 0, "gps": 1, "radar": 2, "scan": 3}
        ev = []
        if "imu" in kinds:
            ev += [(t, "imu", i) for i, t in enumerate(self.imu_stamps)]
        if "scan" in kinds:
            ev += [(t, "scan", i) for i, t in enumerate(self.scan_stamps)]
        if "gps" in kinds and self.gps is not None:
            ev += [(t, "gps", i) for i, t in enumerate(self.gps[:, 0])]
        if "radar" in kinds:
            ev += [(t, "radar", i) for i, t in enumerate(self.radar_stamps)]
        ev.sort(key=lambda e: (e[0], order[e[1]]))
        return iter(ev)

    def read_radar(self, i: int) -> "np.ndarray":
        """Decode polar radar image i to a (H, W) array (PNG via PIL)."""
        from PIL import Image

        return np.asarray(Image.open(self.radar_files[i]))
