"""Scans and IMU of a spinning LiDAR moving along the path.

Vectorised over points, after ``utils/synthetic.Sim.scan`` of the port:
fresh surface points every sweep, each seen at the pose of its own
firing time, so the motion's distortion is in the points. What differs:
the points are drawn from the scene's rectangles with a density of
``cos(incidence) / range^2`` (a spinning sensor's even angular sampling),
only inside the sensor's vertical field of view and range, and a point's
time is its column's: the azimuth it lies at, in ``cols`` steps over the
sweep. Occlusion is not modelled (as in ``Sim``). A sweep lasts one scan
period; its header stamp is the sweep's start when the scan carries
per-point times and its middle when it does not (the stamp the
registration of an undeskewed sweep stands for).
"""

from __future__ import annotations

import numpy as np

from benchmark.gen.path import Path
from benchmark.gen.scene import Scene


def column_transform(R_cols, p_cols, col, world):
    """Sensor-frame points ``R^T (w - p)`` with the pose of each point's
    column: ``R_cols`` (C, 3, 3), ``p_cols`` (C, 3), ``col`` (n,),
    ``world`` (3, n) (coordinates first), all in one dtype and relative to
    one origin. Returns (3, n)."""
    Rt = np.ascontiguousarray(np.moveaxis(R_cols, 0, -1))      # (3, 3, C)
    pt = np.ascontiguousarray(p_cols.T)                        # (3, C)
    d = [world[k] - pt[k][col] for k in range(3)]
    return np.stack([Rt[0, j][col] * d[0] + Rt[1, j][col] * d[1]
                     + Rt[2, j][col] * d[2] for j in range(3)])


class Sensor:
    """``sensor``: the configuration's ``sensor`` object; ``path``,
    ``scene``: the traffic's; ``seed``: the run's."""

    def __init__(self, sensor: dict, path: Path, scene: Scene, seed: int):
        self.cfg = sensor
        self.path, self.scene, self.seed = path, scene, seed
        self.period = 1.0 / float(sensor["rate_hz"])
        self.cols = int(sensor["cols"])
        self.n = int(sensor["rows"]) * self.cols
        self.times = bool(sensor["point_times"])
        self.max_range = float(sensor["max_range"])
        self.min_range = float(sensor["min_range"])
        self.fov = np.deg2rad(np.asarray(sensor["vertical_fov_deg"], float))
        self.imu_dt = 1.0 / float(sensor["imu_hz"])
        self.calib = float(sensor["imu_calib_s"])

    # -------------------------------------------------------------- stamps
    def scan_stamp(self, i) -> np.ndarray:
        """Header stamp of scan ``i`` (scans start at t = 0)."""
        off = 0.0 if self.times else 0.5 * self.period
        return np.asarray(i, np.float64) * self.period + off

    def sweep_start(self, i) -> np.ndarray:
        return np.asarray(i, np.float64) * self.period

    def imu_stamp(self, j) -> np.ndarray:
        """Stamp of IMU sample ``j``; the first ``imu_calib_s`` seconds are
        at rest before t = 0."""
        return np.asarray(j, np.float64) * self.imu_dt - self.calib

    def imu(self, j0: int, j1: int):
        """IMU samples [j0, j1): (stamps, gyro, accel)."""
        t = self.imu_stamp(np.arange(j0, j1))
        g, a = self.path.imu(t)
        return t, g, a

    def column_poses(self, i: int):
        """(times (C,) absolute, R (C, 3, 3), p (C, 3)) of scan ``i``'s
        columns."""
        t = self.sweep_start(i) + np.arange(self.cols) * (self.period
                                                          / self.cols)
        R, p = self.path.pose(t)
        return t, R, p

    # ---------------------------------------------------------------- scan
    def _visible(self, rects, o, dist_h):
        """The rectangles' centres, vertical half-edges and weights after
        cutting each wall to the height band the sensor's field of view
        reaches at its distance, and dropping ground inside the blind ring
        under the sensor."""
        c, v = rects.c.copy(), rects.v.copy()
        wall = np.abs(rects.n[:, 2]) < 0.5
        half_w = np.linalg.norm(rects.u, axis=-1)
        near = np.clip(dist_h - half_w, 0.5, None)
        far = dist_h + half_w
        lo = o[2] + np.minimum(near * np.tan(self.fov[0]),
                               far * np.tan(self.fov[0])) - 0.2
        hi = o[2] + np.maximum(near * np.tan(self.fov[1]),
                               far * np.tan(self.fov[1])) + 0.2
        z0 = np.maximum(c[:, 2] - np.abs(v[:, 2]), lo)
        z1 = np.minimum(c[:, 2] + np.abs(v[:, 2]), hi)
        shown = np.where(wall, z1 > z0, True)
        c[:, 2] = np.where(wall & shown, 0.5 * (z0 + z1), c[:, 2])
        v[:, 2] = np.where(wall & shown, 0.5 * (z1 - z0), v[:, 2])
        area = np.where(wall, 4.0 * half_w * np.abs(v[:, 2]), rects.area)
        blind = (o[2] - c[:, 2]) / np.tan(-self.fov[0]) - 0.5 * np.sqrt(
            rects.area)
        shown &= ~((~wall) & (dist_h < blind))
        return c, v, np.where(shown, area, 0.0)

    def scan(self, i: int):
        """Scan ``i``: (header stamp, xyz (n, 3) float32 sensor frame,
        per-point offsets from the header (n,) float64, or None). Rows past
        the points found in view are zeros, as a sensor reports no return.
        The same ``(seed, i)`` gives the same scan."""
        rng = np.random.default_rng([self.seed, 3, i])
        t_cols, R_cols, p_cols = self.column_poses(i)
        mid = self.cols // 2
        o, R_mid = p_cols[mid], R_cols[mid]
        s_mid, _, _ = self.path.s_of_t(t_cols[mid])
        rects = self.scene.near(float(s_mid), 1.5 * self.max_range + 40.0)

        rel = rects.c - o
        dist = np.linalg.norm(rel, axis=-1)
        dist_h = np.linalg.norm(rel[:, :2], axis=-1)
        c, v, area = self._visible(rects, o, dist_h)
        half = 0.5 * np.sqrt(rects.area)
        cos_inc = np.abs(np.sum(rel * rects.n, axis=-1)) / np.clip(
            dist, 1e-6, None)
        wgt = np.where(dist < self.max_range + half,
                       area * np.clip(cos_inc, 0.05, 1.0)
                       / np.clip(dist, 2.0, None) ** 2, 0.0)
        m = int(1.3 * self.n)
        counts = rng.multinomial(m, wgt / wgt.sum())
        idx = np.repeat(np.arange(len(wgt)), counts)
        # points relative to the mid-sweep position, in float32, (3, m)
        cl = np.ascontiguousarray((c - o).T.astype(np.float32))
        u32 = np.ascontiguousarray(rects.u.T.astype(np.float32))
        v32 = np.ascontiguousarray(v.T.astype(np.float32))
        ab = rng.random((2, m), dtype=np.float32) * 2.0 - 1.0
        pts = np.stack([cl[k][idx] + ab[0] * u32[k][idx] + ab[1] * v32[k][idx]
                        for k in range(3)])

        # the column of each point: its azimuth about the mid-sweep pose
        R_mid32 = R_mid.astype(np.float32)
        fwd, left = R_mid32[:, 0] @ pts, R_mid32[:, 1] @ pts
        az = np.arctan2(left, fwd)
        col = ((az * np.float32(self.cols / (2 * np.pi))).astype(np.int64)
               + self.cols) % self.cols
        xyz = column_transform(R_cols.astype(np.float32),
                               (p_cols - o).astype(np.float32), col, pts)
        rh2 = xyz[0] * xyz[0] + xyz[1] * xyz[1]
        r2 = rh2 + xyz[2] * xyz[2]
        tlo, thi = np.tan(self.fov)
        z, zs = xyz[2], np.sign(xyz[2])
        # elevation inside [lo, hi] without a square root: z^2 against
        # tan^2 * rh^2 on each side of the horizon
        ok = ((r2 > self.min_range ** 2) & (r2 < self.max_range ** 2)
              & np.where(zs >= 0, z * z <= thi * thi * rh2,
                         z * z <= tlo * tlo * rh2))
        sel = np.flatnonzero(ok)[: self.n]
        sel = sel[np.argsort(col[sel].astype(np.int16), kind="stable")]
        out = np.zeros((self.n, 3), np.float32)
        out[: len(sel)] = xyz[:, sel].T
        header = float(self.scan_stamp(i))
        if not self.times:
            return header, out, None
        pt = np.zeros(self.n, np.float64)
        pt[: len(sel)] = t_cols[col[sel]] - header
        if len(sel) < self.n:
            pt[len(sel):] = pt[len(sel) - 1] if len(sel) else 0.0
        return header, out, pt

    def truth(self, stamps):
        """Ground-truth sensor pose at ``stamps``: (R (n, 3, 3), p (n, 3))."""
        return self.path.pose(np.asarray(stamps, np.float64))
