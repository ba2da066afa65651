"""IMU-rate pose extrapolation (host-side). The port's own copy of
``noetic_slam_tpu.runtime.poseext`` (numpy only), held to the original by
``tests/test_torch_copies.py``; it keeps the original's stale-index
defect at ``pose_at`` (ROADMAP Queue 3), since a fix changes results in
both packages.

The reference publishes odom/pose at IMU rate from its IMU callback and a
100 Hz timer (odom.cc:315-488 publishPose; propagateState at
odom.cc:1248-1284 is the equation set): a live consumer (controller,
planner) can query pose between scans. In this framework the fused state
lives on device and syncs to the host once per batch (the
runtime.slam._gather_sync snapshot), so high-rate pose queries are served
by a HOST extrapolator: propagate the last fused state through the
already-buffered IMU samples (runtime.pipeline keeps them in float64)
with the same equations the device observer uses (models.odometry
propagate_state_batch / tests.reference_math.propagate_state_ref).

Cost model: queries are expected monotone in time (a pose publisher), so
propagation is incremental — each query advances through only the IMU
samples since the previous query. A backwards query re-propagates from
the seed (rare; still only one batch of samples).

Accuracy: the extrapolated pose at the next scan's stamp differs from the
next FUSED pose by the GICP correction of that scan (mm-scale in steady
state) plus bias drift over the extrapolation horizon — bounded by
tests/test_poseext.py against the full pipeline.
"""

from __future__ import annotations

import numpy as np

from noetic_slam_tpu_torch.config import DlioConfig


def _quat_mul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_rotate(q, v):
    u, w = q[1:], q[0]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


class PoseExtrapolator:
    """Serve ~IMU-rate pose queries from the last fused state snapshot.

    ``pipeline``: the OdometryPipeline whose float64 IMU buffer provides
    the samples (no duplicate buffering). ``seed`` is called by
    SlamSystem's sync drain with each fused snapshot; ``pose_at(t)``
    returns (q wxyz, p) extrapolated to absolute time ``t``.
    """

    def __init__(self, cfg: DlioConfig, pipeline):
        self.cfg = cfg
        self.pipeline = pipeline
        self._R = np.asarray(cfg.extrinsics.baselink2imu_R,
                             np.float64).reshape(3, 3)
        self._t = np.asarray(cfg.extrinsics.baselink2imu_t, np.float64)
        self._sm = np.asarray(cfg.imu.accel_sm, np.float64).reshape(3, 3)
        self._g = np.array([0.0, 0.0, cfg.gravity])
        self.seed_stamp = None
        self._seed = None          # (q, p, v, bg, ba) float64
        # incremental propagation cursor
        self._cur = None           # (stamp, q, p, v, prev_w)
        self.seeds = 0

    # ------------------------------------------------------------- seeding
    def seed(self, stamp, q, p, v, bg, ba) -> None:
        """Install a fused-state snapshot (from the sync gather). Queries
        at t <= stamp return the propagated-to-stamp... the seed itself."""
        self.seed_stamp = float(stamp)
        self._seed = tuple(np.asarray(x, np.float64)
                           for x in (q, p, v, bg, ba))
        self._cur = None
        self.seeds += 1

    # ----------------------------------------------------------- condition
    def _condition(self, w_raw, a_raw, w_prev_cg, dt):
        """One sample of condition_imu (models/odometry.py:285-310) in
        float64: extrinsic rotation, lever-arm (Euler + centripetal)
        compensation, accel scale, bias subtraction."""
        _, _, _, bg, ba = self._seed
        w_cg = self._R @ w_raw
        a_cg = self._R @ a_raw
        wdot = (w_cg - w_prev_cg) / max(dt, 1e-8)
        a_cg = (a_cg + np.cross(wdot, -self._t)
                + np.cross(w_cg, np.cross(w_cg, -self._t)))
        return w_cg - bg, self._sm @ a_cg - ba, w_cg

    # -------------------------------------------------------------- query
    def pose_at(self, t: float):
        """(q wxyz, p) at absolute time ``t`` — the fused seed propagated
        through buffered IMU samples in (seed_stamp, t], then constant
        velocity/orientation-rate beyond the last sample. None before the
        first seed."""
        if self._seed is None:
            return None
        t = float(t)
        stamps = self.pipeline._imu_stamps
        if self._cur is not None and t < self._cur[0]:
            self._cur = None                   # backwards query: restart
        if self._cur is None:
            q, p, v, _, _ = (x.copy() for x in self._seed)
            i = int(np.searchsorted(stamps, self.seed_stamp, "right"))
            # previous conditioned angular rate for the Euler term; the
            # sample before the window reuses itself (condition_imu quirk)
            w_prev = (self._R @ self.pipeline._imu_ang[max(i - 1, 0)]
                      if len(stamps) else np.zeros(3))
            self._cur = [self.seed_stamp, q, p, v, w_prev, i]
        stamp, q, p, v, w_prev, i = self._cur
        # propagate through whole samples in (stamp, t]
        while i < len(stamps) and stamps[i] <= t:
            dt = stamps[i] - stamp
            w, a, w_prev = self._condition(
                self.pipeline._imu_ang[i], self.pipeline._imu_acc[i],
                w_prev, dt)
            q, p, v = self._step(q, p, v, w, a, dt)
            stamp = stamps[i]
            i += 1
        self._cur = [stamp, q, p, v, w_prev, i]
        # partial tail: hold the last conditioned rates over (stamp, t]
        dt = t - stamp
        if dt > 0 and i > 0 and len(stamps):
            w, a, _ = self._condition(
                self.pipeline._imu_ang[i - 1], self.pipeline._imu_acc[i - 1],
                w_prev, max(dt, 1e-8))
            q2, p2, v2 = self._step(q, p, v, w, a, dt)
            return q2.copy(), p2.copy()
        return q.copy(), p.copy()

    def _step(self, q, p, v, w, a, dt):
        """One propagateState step (odom.cc:1248-1284 /
        reference_math.propagate_state_ref): world-frame accel minus
        gravity, then the first-order quaternion step."""
        acc_w = _quat_rotate(q, a) - self._g
        p = p + v * dt + 0.5 * dt * dt * acc_w
        v = v + acc_w * dt
        dq = _quat_mul(q, np.concatenate([[0.0], w]))
        q = q + 0.5 * dt * dq
        return q / np.linalg.norm(q), p, v
