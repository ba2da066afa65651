"""Host-side odometry pipeline (port of ``noetic_slam_tpu.runtime.pipeline``).

The same host loop as the JAX module: a float64 IMU buffer on the host, the
static IMU calibration and gravity alignment before the first scan, scans
rebased to header-to-header deltas and packed into fixed-shape
``StepInput`` tensors, the trajectory kept in a device ring and fetched in
bulk by ``flush()``. ``process_scan`` raises ``NeedMoreImu`` while the IMU
buffer does not cover the sweep end.

Differences: the device is an argument (left at ``None``, the card; the
tests pass ``"cpu"``); the step runs eagerly and updates the state
in place; ``process_scans`` is a loop with ``process_scan``'s semantics
(packs the whole batch first, so a batch without IMU coverage submits
nothing); ``host_syncs`` counts the device->host reads that steer control
flow (GICP's outer loop and the step's branches).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from noetic_slam_tpu_torch import resolve_device
from noetic_slam_tpu_torch.config import DlioConfig
from noetic_slam_tpu_torch.models.odometry import (
    OdomState,
    StepInput,
    init_state,
    make_odometry_step,
    make_slam_step,
)
from noetic_slam_tpu_torch.models.occupancy import init_occupancy
from noetic_slam_tpu_torch.models.tsdf import init_tsdf
from noetic_slam_tpu_torch.ops.gicp import HostSyncs
from noetic_slam_tpu_torch.utils.host import to_device


class NeedMoreImu(Exception):
    """Raised when the IMU buffer does not yet cover the scan sweep."""


@dataclasses.dataclass
class TrajectoryEntry:
    stamp: float                 # absolute seconds
    p: np.ndarray                # (3,)
    q: np.ndarray                # (4,) wxyz
    is_keyframe: bool
    num_corr: int
    gicp_iterations: int


class OdometryPipeline:
    def __init__(self, cfg: DlioConfig | None = None, *, device=None,
                 with_tsdf: bool = False):
        self.cfg = cfg or DlioConfig()
        self.device = resolve_device(device)
        self.with_tsdf = with_tsdf
        self._syncs = HostSyncs()
        if with_tsdf:
            self._step = make_slam_step(self.cfg, self._syncs)
            # tsdf_state holds whichever dense map cfg.map_backend selects
            # (tsdf | occupancy); the JAX pipeline keeps the same name
            if self.cfg.map_backend == "occupancy":
                self.tsdf_state = init_occupancy(self.cfg.occupancy,
                                                 self.device)
            else:
                self.tsdf_state = init_tsdf(self.cfg.tsdf, self.device)
        else:
            self._step = make_odometry_step(self.cfg, self._syncs)
            self.tsdf_state = None
        self.state: Optional[OdomState] = None

        self._imu_stamps = np.zeros((0,), np.float64)
        self._imu_ang = np.zeros((0, 3), np.float64)
        self._imu_acc = np.zeros((0, 3), np.float64)
        self._imu_max = self.cfg.imu.buffer_size

        self.calibrated = not (self.cfg.imu.calibrate_gyro
                               or self.cfg.imu.calibrate_accel
                               or self.cfg.imu.gravity_align)
        self._calib_first_stamp: Optional[float] = None
        self._calib_gyro: List[np.ndarray] = []
        self._calib_accel: List[np.ndarray] = []

        self.prev_header: Optional[float] = None
        self.headers: List[float] = []
        self.first_scan_stamp: Optional[float] = None
        self.trajectory: List[TrajectoryEntry] = []
        self._flushed_scans = 0
        self.last_output = None
        self.imu_dropped = 0
        self._decim_rng = np.random.default_rng(0)

    @property
    def host_syncs(self) -> int:
        """Device->host reads that steered control flow so far."""
        return self._syncs.n

    # ------------------------------------------------------------------ IMU
    def push_imu(self, stamp: float, ang_vel, lin_accel) -> None:
        """Feed one raw IMU sample (absolute stamp, sensor frame)."""
        ang_vel = np.asarray(ang_vel, np.float64)
        lin_accel = np.asarray(lin_accel, np.float64)
        if not self.calibrated:
            if self._calib_first_stamp is None:
                self._calib_first_stamp = stamp
            if stamp - self._calib_first_stamp < self.cfg.imu.calib_time:
                self._calib_gyro.append(ang_vel)
                self._calib_accel.append(lin_accel)
                return
            self._finish_calibration()
        # late or duplicate samples are dropped and counted
        if len(self._imu_stamps) and stamp <= self._imu_stamps[-1]:
            self.imu_dropped += 1
            return
        self._imu_stamps = np.append(self._imu_stamps, stamp)[-self._imu_max:]
        self._imu_ang = np.vstack([self._imu_ang, ang_vel])[-self._imu_max:]
        self._imu_acc = np.vstack([self._imu_acc, lin_accel])[-self._imu_max:]

    def _finish_calibration(self) -> None:
        """Static bias + gravity-alignment estimate (raw samples rotated
        into the baselink frame first)."""
        R = np.asarray(self.cfg.extrinsics.baselink2imu_R).reshape(3, 3)
        gyro_avg = R @ np.mean(self._calib_gyro, axis=0)
        accel_avg = R @ np.mean(self._calib_accel, axis=0)
        g = self.cfg.gravity
        q0 = np.array([1.0, 0, 0, 0])
        ba = np.asarray(self.cfg.imu.accel_bias, np.float64)
        bg = np.asarray(self.cfg.imu.gyro_bias, np.float64)
        grav_vec = np.array([0.0, 0.0, g])
        if self.cfg.imu.gravity_align:
            grav_est = accel_avg - ba
            grav_est = grav_est / np.linalg.norm(grav_est) * abs(g)
            a = grav_est / np.linalg.norm(grav_est)
            b = np.array([0.0, 0, 1.0])
            q0 = np.concatenate([[1.0 + a.dot(b)], np.cross(a, b)])
            q0 = q0 / np.linalg.norm(q0)
            grav_vec = grav_est
        if self.cfg.imu.calibrate_accel:
            ba = accel_avg - grav_vec
        if self.cfg.imu.calibrate_gyro:
            bg = gyro_avg
        self.state = init_state(self.cfg, self.device, q0=q0, ba0=ba, bg0=bg)
        self.calibrated = True

    # ----------------------------------------------------------------- scan
    def imu_covers(self, stamp: float) -> bool:
        return len(self._imu_stamps) > 0 and self._imu_stamps[-1] >= stamp

    def _pack_scan(self, header_stamp: float, xyz: np.ndarray,
                   point_times: Optional[np.ndarray], header_delta: float):
        """Pack one scan into the fixed-shape StepInput arrays (numpy; the
        JAX pipeline's wire formats). Raises NeedMoreImu if the IMU buffer
        does not cover the sweep end."""
        cap = self.cfg.capacity
        n = cap.max_points
        m = xyz.shape[0]
        if m > n:
            keep = self._decim_rng.choice(m, n, replace=False)
            keep.sort()
            xyz = xyz[keep]
            point_times = None if point_times is None else point_times[keep]
            m = n
        deskew = point_times is not None and self.cfg.preproc.deskew
        pt = np.zeros(m, np.float64) if point_times is None else point_times
        sweep_end_abs = header_stamp + (float(pt.max()) if deskew and m
                                        else 0.0)
        if not self.imu_covers(sweep_end_abs):
            raise NeedMoreImu(f"IMU must cover {sweep_end_abs:.6f}")

        xyz_f = np.where(np.isfinite(xyz), xyz, 1e6).astype(np.float32)
        row_ok = np.all(np.abs(xyz_f) < 1e5, axis=-1)
        if self.cfg.preproc.quantized_wire:
            amax = (float(np.abs(np.where(row_ok[:, None], xyz_f, 0.0)).max())
                    if m else 0.0)
            scale = max(amax / 32766.0, 1e-4)
            q = np.full((n, 3), 32767, np.int16)
            q[:m] = np.clip(np.round(xyz_f / scale), -32766, 32766
                            ).astype(np.int16)
            q[:m][~row_ok] = 32767
            pt16 = np.zeros((n,), np.float16)
            pt16[:m] = pt
            points, pts_t = q, pt16
            scalars_extra = [scale, 0.0, 0.0, 0.0]
        else:
            points = np.full((n, 4), 1e6, np.float32)
            points[:m, :3] = xyz_f
            points[:m, 3] = pt
            pts_t = None
            scalars_extra = []

        # IMU window rebased to this header (float64 subtraction on host)
        M = cap.max_imu_window
        lo = np.searchsorted(
            self._imu_stamps,
            min(header_stamp + header_delta * -1.0, header_stamp) - 0.3) - 4
        sl = slice(max(int(lo), 0), max(int(lo), 0) + M)
        k = len(self._imu_stamps[sl])
        imu = np.zeros((M, 7), np.float32)
        imu[:k, 0] = self._imu_stamps[sl] - header_stamp
        if k:
            imu[k:, 0] = imu[k - 1, 0] + 1.0 + np.arange(M - k)
        imu[:k, 1:4] = self._imu_ang[sl]
        imu[:k, 4:7] = self._imu_acc[sl]

        head = [header_delta, 1.0 if deskew else 0.0, float(k)]
        scalars = np.array(head + scalars_extra + [0.0], np.float32)
        return points, imu, scalars, pts_t

    def _to_device(self, packed) -> StepInput:
        points, imu, scalars, pts_t = packed
        dev = lambda a: to_device(a, self.device)          # noqa: E731
        return StepInput(points=dev(points), imu=dev(imu),
                         scalars=dev(scalars),
                         pt=None if pts_t is None else dev(pts_t))

    def _submit(self, inp: StepInput):
        if self.with_tsdf:
            (self.state, self.tsdf_state), out = self._step(
                (self.state, self.tsdf_state), inp)
        else:
            self.state, out = self._step(self.state, inp)
        return out

    def _pre_submit_checks(self):
        if not self.calibrated:
            raise NeedMoreImu("IMU calibration in progress")
        if self.state is None:
            self.state = init_state(self.cfg, self.device)

    def _post_submit(self, header_stamp: float, out):
        self.prev_header = header_stamp
        self.headers.append(header_stamp)
        self.last_output = out
        if len(self.headers) % (self.cfg.capacity.max_trajectory // 2) == 0:
            self.flush()

    def process_scan(self, header_stamp: float, xyz: np.ndarray,
                     point_times: Optional[np.ndarray] = None):
        """Run one scan through the step. ``point_times`` are per-point
        offsets [s] from ``header_stamp`` (None -> no deskew). Returns the
        StepOutput (device tensors); the trajectory comes from
        ``flush()``."""
        self._pre_submit_checks()
        if self.first_scan_stamp is None:
            self.first_scan_stamp = header_stamp
        header_delta = (0.0 if self.prev_header is None
                        else header_stamp - self.prev_header)
        inp = self._to_device(self._pack_scan(header_stamp, xyz, point_times,
                                              header_delta))
        out = self._submit(inp)
        self._post_submit(header_stamp, out)
        return out

    def process_scans(self, batch) -> None:
        """Run a list of (header_stamp, xyz, point_times|None) scans with
        ``process_scan``'s semantics. The whole batch is packed first, so
        a batch without IMU coverage raises NeedMoreImu before any scan
        runs."""
        if not batch:
            return
        self._pre_submit_checks()
        if self.first_scan_stamp is None:
            self.first_scan_stamp = batch[0][0]
        packed, prev = [], self.prev_header
        for header_stamp, xyz, point_times in batch:
            header_delta = 0.0 if prev is None else header_stamp - prev
            packed.append(self._pack_scan(header_stamp, xyz, point_times,
                                          header_delta))
            prev = header_stamp
        for (header_stamp, _, _), p in zip(batch, packed):
            out = self._submit(self._to_device(p))
            self._post_submit(header_stamp, out)

    # ------------------------------------------------------------- results
    def flush(self) -> np.ndarray:
        """Fetch the device trajectory ring (one bulk transfer) and append
        to ``self.trajectory``. Returns the full (T, 8) trajectory: stamp,
        p, q."""
        if self.state is None:
            return np.zeros((0, 8))
        traj = self.state.traj.cpu().numpy()
        nproc = int(self.state.num_scans)
        for i in range(self._flushed_scans, min(nproc, traj.shape[0])):
            row = traj[i]
            stamp = self.headers[int(row[0])] + float(row[1])
            self.trajectory.append(TrajectoryEntry(
                stamp, row[2:5].copy(), row[5:9].copy(), bool(row[9] > 0.5),
                int(row[10]), int(row[11])))
        self._flushed_scans = max(self._flushed_scans,
                                  min(nproc, traj.shape[0]))
        return self.trajectory_array()

    @property
    def num_processed(self) -> int:
        self.flush()
        return self._flushed_scans

    @property
    def submap_overflow(self) -> int:
        """Cumulative keyframes selected for the submap but dropped because
        max_submap_kf was exceeded."""
        if self.state is None:
            return 0
        return int(self.state.submap_overflow)

    @property
    def num_skipped(self) -> int:
        return int(self.state.total_steps) - self.num_processed

    def trajectory_array(self) -> np.ndarray:
        """(T, 8) array: stamp, px, py, pz, qw, qx, qy, qz."""
        if not self.trajectory:
            return np.zeros((0, 8))
        return np.array([[e.stamp, *e.p, *e.q] for e in self.trajectory])
