"""Synthetic LiDAR+IMU world simulator.

The port's own copy of ``noetic_slam_tpu/utils/synthetic.py`` (numpy
only); ``tests/test_torch_copies.py`` holds the two to bitwise-equal
output.

Generates physically-consistent scan + IMU streams for a vehicle moving
through a structured world — the framework's equivalent of the reference's
test bags (src/dlio/README.md "Test Data"): used by the end-to-end odometry
tests, the benchmark harness, and the compile-check entry point.

The simulated sensor samples fresh surface points every sweep (no fixed
correspondence between scans), per-point timestamps advance across the
sweep, and the IMU reports body-frame angular velocity and specific force
consistent with the trajectory (f = R^T (a_world + g e_z))."""

from __future__ import annotations

import dataclasses

import numpy as np

GRAVITY = 9.80665


def loop_pose_of(t, period=20.0, radius=8.0):
    """Closed-loop trajectory: circle of given period/radius with yaw
    following the path — returns to the start, for loop-closure tests."""
    t = float(t)
    ang = 2 * np.pi * t / period
    p = np.array([radius * np.sin(ang), radius * (1 - np.cos(ang)),
                  0.02 * np.sin(0.7 * t)])
    yaw = ang
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz, p


def spiral_pose_of(t, period=20.0, r0=8.0, dr=0.6):
    """Expanding-spiral trajectory: every lap runs ``dr`` meters outside
    the previous one, so the vehicle keeps covering NEW ground (keyframe
    creation never stops — the km-scale soak regime) while each lap passes
    within ``dr`` of the previous lap (loop-closure candidates the whole
    run). Yaw follows the path."""
    t = float(t)
    ang = 2 * np.pi * t / period
    r = r0 + dr * t / period
    p = np.array([r * np.sin(ang), r0 - r * np.cos(ang),
                  0.02 * np.sin(0.7 * t)])
    yaw = ang
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz, p


@dataclasses.dataclass
class Sim:
    world: np.ndarray            # (W, 3) surface points
    imu_stamps: np.ndarray       # (M,)
    imu_ang: np.ndarray          # (M, 3) body frame
    imu_acc: np.ndarray          # (M, 3) body frame specific force
    scan_stamps: np.ndarray      # (T,) sweep start times
    gt_stamps: np.ndarray        # dense gt sample times
    gt_pos: np.ndarray           # (G, 3)
    gt_quat: np.ndarray          # (G, 4) wxyz
    duration: float
    rng: np.random.Generator
    sweep_time: float
    n_points: int
    max_range: float
    pose_fn: object = None

    def pose(self, t):
        """Ground-truth pose at time t: (R (3,3), p (3,))."""
        fn = self.pose_fn or _pose_of
        return fn(np.asarray(t))

    def scan(self, i: int):
        """Generate sweep i: (header_stamp, xyz (N,3) sensor frame,
        point_times (N,) offsets from header)."""
        t0 = self.scan_stamps[i]
        # Column-quantized per-point times, like a spinning LiDAR (Ouster
        # columns_per_frame; lidar_scan.h data_format): many points share
        # each firing timestamp.
        cols = 512
        pt = np.sort(self.rng.integers(0, cols, self.n_points)
                     * (self.sweep_time / cols))
        # sample world points within range of the mid-sweep position
        fn = self.pose_fn or _pose_of
        R_mid, p_mid = fn(t0 + 0.5 * self.sweep_time)
        d = np.linalg.norm(self.world - p_mid, axis=-1)
        cand = np.flatnonzero(d < self.max_range)
        pick = self.world[self.rng.choice(cand, self.n_points)]
        xyz = np.empty((self.n_points, 3), np.float32)
        for k in range(self.n_points):
            R, p = fn(t0 + pt[k])
            xyz[k] = R.T @ (pick[k] - p)
        return t0, xyz, pt.astype(np.float64)


def _pose_of(t):
    """Smooth trajectory: gentle arc + slight bobbing, yaw following path."""
    t = float(t)
    vx, vy = 1.2, 0.5
    p = np.array([vx * t + 0.3 * np.sin(0.5 * t),
                  vy * t + 0.2 * np.cos(0.4 * t) - 0.2,
                  0.05 * np.sin(0.8 * t)])
    yaw = 0.25 * np.sin(0.6 * t)
    pitch = 0.03 * np.sin(0.9 * t)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    return Rz @ Ry, p


def _numeric_imu(t, dt=1e-4, pose_fn=None):
    """Body rates + specific force by numeric differentiation of the pose."""
    fn = pose_fn or _pose_of
    R0, p0 = fn(t - dt)
    R1, p1 = fn(t)
    R2, p2 = fn(t + dt)
    # angular velocity: vee(R^T dR/dt)
    dR = (R2 - R0) / (2 * dt)
    W = R1.T @ dR
    w = np.array([W[2, 1] - W[1, 2], W[0, 2] - W[2, 0], W[1, 0] - W[0, 1]]) / 2
    a_world = (p2 - 2 * p1 + p0) / dt ** 2
    f = R1.T @ (a_world + np.array([0.0, 0.0, GRAVITY]))
    return w, f


def make_world(rng, extent=30.0, n=20000) -> np.ndarray:
    """Structured world: ground plane, boundary walls, scattered boxes
    (box count scales with area so big worlds keep local landmarks —
    place recognition needs distinctive geometry everywhere)."""
    pts = []
    m = n // 4
    n_boxes = max(12, int(12 * (extent / 30.0) ** 2))
    # ground
    g = np.c_[rng.uniform(-extent, extent, m), rng.uniform(-extent, extent, m),
              np.zeros(m)]
    pts.append(g)
    # walls
    for k in range(2):
        s = extent if k == 0 else -extent
        pts.append(np.c_[np.full(m // 2, s), rng.uniform(-extent, extent, m // 2),
                         rng.uniform(0, 5, m // 2)])
        pts.append(np.c_[rng.uniform(-extent, extent, m // 2), np.full(m // 2, s),
                         rng.uniform(0, 5, m // 2)])
    # boxes
    for _ in range(n_boxes):
        c = rng.uniform(-extent * 0.7, extent * 0.7, 2)
        w, h = rng.uniform(0.5, 2.0, 2)
        face = rng.integers(0, 3)
        q = max(n // (4 * n_boxes), 16)
        u = rng.uniform(-w, w, q)
        v = rng.uniform(0, h, q)
        if face == 0:
            pts.append(np.c_[c[0] + u, np.full(q, c[1] + w), v])
        elif face == 1:
            pts.append(np.c_[np.full(q, c[0] + w), c[1] + u, v])
        else:
            pts.append(np.c_[c[0] + u, c[1] + rng.uniform(-w, w, q),
                             np.full(q, h)])
    return np.concatenate(pts).astype(np.float32)


def path_pose_of(segments, v=2.0, start_xy=(0.0, 0.0), start_yaw=0.0):
    """Pose function for a tangent-continuous piecewise path driven at
    constant speed ``v``: segments are ("straight", length_m) or
    ("arc", radius_m, angle_rad) with angle > 0 turning left, < 0 right.
    Each segment starts where (and heading how) the previous one ended,
    so IMU synthesized by numeric differentiation stays finite (heading
    is C0-continuous; lateral acceleration steps at junctions like a real
    vehicle's steering input). Returns pose_fn(t) -> (R, p); time past
    the last segment continues straight. Used by the drift-recovery and
    corridor soaks to script revisit topologies (excursion + return leg)
    that closed-form circles/spirals cannot express."""
    # precompute segment start states
    starts = []                 # (s0, x, y, yaw)
    x, y, yaw = float(start_xy[0]), float(start_xy[1]), float(start_yaw)
    s0 = 0.0
    for seg in segments:
        starts.append((s0, x, y, yaw))
        if seg[0] == "straight":
            length = float(seg[1])
            x += length * np.cos(yaw)
            y += length * np.sin(yaw)
            s0 += length
        else:
            r, ang = float(seg[1]), float(seg[2])
            sgn = 1.0 if ang >= 0 else -1.0
            cx = x - sgn * r * np.sin(yaw)
            cy = y + sgn * r * np.cos(yaw)
            yaw2 = yaw + ang
            x = cx + sgn * r * np.sin(yaw2)
            y = cy - sgn * r * np.cos(yaw2)
            yaw = yaw2
            s0 += r * abs(ang)
    total = s0
    end_state = (x, y, yaw)

    def fn(t):
        s = float(t) * v
        if s >= total:
            x0, y0, yaw0 = end_state
            d = s - total
            px, py = x0 + d * np.cos(yaw0), y0 + d * np.sin(yaw0)
            yawp = yaw0
        else:
            # find segment (few segments: linear scan)
            k = 0
            for k in range(len(segments) - 1, -1, -1):
                if s >= starts[k][0]:
                    break
            s0k, x0, y0, yaw0 = starts[k]
            ds = s - s0k
            seg = segments[k]
            if seg[0] == "straight":
                px = x0 + ds * np.cos(yaw0)
                py = y0 + ds * np.sin(yaw0)
                yawp = yaw0
            else:
                r, ang = float(seg[1]), float(seg[2])
                sgn = 1.0 if ang >= 0 else -1.0
                cx = x0 - sgn * r * np.sin(yaw0)
                cy = y0 + sgn * r * np.cos(yaw0)
                yawp = yaw0 + sgn * ds / r
                px = cx + sgn * r * np.sin(yawp)
                py = cy - sgn * r * np.cos(yawp)
        p = np.array([px, py, 0.02 * np.sin(0.7 * float(t))])
        cy_, sy_ = np.cos(yawp), np.sin(yawp)
        Rz = np.array([[cy_, -sy_, 0], [sy_, cy_, 0], [0, 0, 1]])
        return Rz, p

    fn.total_length = total
    fn.duration_at_speed = total / v
    return fn


def ramp_start(pose_fn, ramp_s: float = 1.5):
    """C1 start-velocity ramp: pose_fn assumed parameterized at constant
    speed from t=0; the wrapper holds still at t<=0 and accelerates
    quadratically over ``ramp_s`` seconds (a step from rest to cruise
    speed at t=0 is an unphysical impulse the observer has to absorb —
    measured ~2.5 m of immediate error on the drift-soak path)."""
    def fn(t):
        u = float(t)
        if u <= 0.0:
            tau = 0.0
        elif u <= ramp_s:
            tau = u * u / (2.0 * ramp_s)
        else:
            tau = u - ramp_s / 2.0
        return pose_fn(tau)
    return fn


def make_sim(duration=3.0, imu_hz=100.0, scan_hz=10.0, n_points=2048,
             max_range=45.0, calib_time=0.0, seed=0, pose_fn=None,
             imu_noise=0.0, imu_gyro_ramp=None, world_extent=30.0,
             world_n=20000, world_pts=None) -> Sim:
    """Build a simulation. ``calib_time`` seconds of stationary IMU samples
    (pure gravity) are prepended for the static calibration procedure.
    ``pose_fn`` overrides the trajectory (e.g. ``loop_pose_of``);
    ``imu_noise`` adds white noise to gyro/accel (drift injection).
    ``imu_gyro_ramp`` (3,) rad/s per second: a slowly growing gyro bias
    applied AFTER the static calibration window — the drift-injection
    knob for the descriptor-recovery soak (a constant bias would be
    absorbed by the static calibration; a ramp outruns the observer's
    bias tracking and accumulates multi-meter position drift).
    ``world_extent``/``world_n`` size the world for long excursions;
    ``world_pts`` ((W, 3) float32) overrides the generated world entirely
    (scenario-specific geometry, e.g. the drift soak's street canyon)."""
    rng = np.random.default_rng(seed)
    world = (np.asarray(world_pts, np.float32) if world_pts is not None
             else make_world(rng, extent=world_extent, n=world_n))
    fn = pose_fn or _pose_of

    imu_t = np.arange(-calib_time, duration + 0.2, 1.0 / imu_hz)
    ang = np.zeros((len(imu_t), 3))
    acc = np.zeros((len(imu_t), 3))
    R0, _ = fn(0.0)
    for i, t in enumerate(imu_t):
        if t < 0:
            ang[i] = 0.0
            acc[i] = R0.T @ np.array([0.0, 0.0, GRAVITY])
        else:
            ang[i], acc[i] = _numeric_imu(max(t, 1e-3), pose_fn=fn)
            if imu_noise > 0:
                ang[i] += rng.normal(scale=imu_noise, size=3)
                acc[i] += rng.normal(scale=imu_noise * 10, size=3)
            if imu_gyro_ramp is not None:
                ang[i] += np.asarray(imu_gyro_ramp, float) * t

    scan_t = np.arange(0.0, duration, 1.0 / scan_hz)
    gt_t = np.arange(0.0, duration + 0.1, 0.01)
    gt_pos = np.stack([fn(t)[1] for t in gt_t])
    gt_quat = np.stack([_mat_to_quat(fn(t)[0]) for t in gt_t])
    return Sim(world, imu_t, ang, acc, scan_t, gt_t, gt_pos, gt_quat,
               duration, rng, 1.0 / scan_hz, n_points, max_range, fn)


def _mat_to_quat(R):
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w < 1e-8:
        return np.array([1.0, 0, 0, 0])
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def ate_rmse(traj_stamps, traj_pos, gt_stamps, gt_pos,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE vs time-interpolated ground truth.

    With ``align=True`` (default, standard TUM/evo methodology) a rigid
    SE(3) Umeyama alignment is applied first — the estimate's world frame is
    anchored to the first keyframe, which bakes in the motion during the
    bootstrap sweep (the reference does the same, odom.cc:712-718)."""
    gt = np.stack([np.interp(traj_stamps, gt_stamps, gt_pos[:, k])
                   for k in range(3)], axis=-1)
    est = np.asarray(traj_pos, np.float64)
    if align and len(est) >= 3:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        H = (est - mu_e).T @ (gt - mu_g)
        U, _, Vt = np.linalg.svd(H)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
        est = (R @ (est - mu_e).T).T + mu_g
    err = est - gt
    return float(np.sqrt(np.mean(np.sum(err ** 2, axis=-1))))
