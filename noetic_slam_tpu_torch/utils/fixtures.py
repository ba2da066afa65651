"""Seeded fixture writers: an Ouster capture, a MulRan directory and a
ROS1 bag of a simulated sequence.

The port's own copies of ``scripts/make_pcap_fixture.write_fixture``
(here ``write_pcap_fixture``) and ``scripts/make_mulran_fixture.
write_fixture`` (here ``write_mulran_fixture``, with ``still_then``),
wired to the port's ``io.ouster``, ``io.pcap`` and ``utils.synthetic``.
``tests/test_torch_ingest.py`` holds their files byte-equal to the
scripts' for the same seed.

- ``write_pcap_fixture``: the exact UDP stream a live Ouster sensor
  produces (RNG19_RFL8_SIG16_NIR16 lidar packets and 48-byte IMU packets)
  from an analytic scene (cylinder room, floor, ceiling, pillars)
  traversed by a C1 trajectory with a stationary hold for IMU calibration,
  plus its metadata JSON and a TUM ground truth. Ranges are exact ray
  intersections per column-firing pose, so the stream is motion-distorted
  and the per-point times are real column times.
- ``write_mulran_fixture``: the on-disk MulRan formats the reference file
  player parses (``sensor_data/data_stamp.csv``, ``xsens_imu.csv``,
  ``Ouster/<stamp>.bin``, ``gps.csv``, ``radar/polar/<stamp>.png`` and
  ``global_pose.csv``) from the synthetic simulator, without per-point
  times (run with deskew off, as on real MulRan).
- ``write_sim_bag``: a ``synthetic.make_sim`` sequence as a recorded bag
  (IMU and PointCloud2 with per-point times).
"""

from __future__ import annotations

import json
import os

import numpy as np

from noetic_slam_tpu_torch.io import ouster as ou
from noetic_slam_tpu_torch.io import pcap as pcap_mod
from noetic_slam_tpu_torch.io.rosbag import BagWriter
from noetic_slam_tpu_torch.utils import synthetic

PCAP_BASE_NS = 1_600_000_000_000_000_000
MULRAN_BASE_NS = 1_561_000_000_000_000_000  # realistic MulRan-era epoch
G = synthetic.GRAVITY


def still_then(pose_fn, hold: float, ramp: float = 1.0):
    """Trajectory wrapper: stationary at pose_fn(0) for ``hold`` seconds
    (the static-calibration window), then pose_fn over a C1 time warp
    (quadratic velocity ramp of ``ramp`` seconds — a hard kink would put an
    unphysical acceleration spike into the numerically-differentiated IMU)."""
    def fn(t):
        u = float(t) - hold
        if u <= 0.0:
            tau = 0.0
        elif u <= ramp:
            tau = u * u / (2.0 * ramp)
        else:
            tau = u - ramp / 2.0
        return pose_fn(tau)
    return fn


def make_info(h=16, w=512):
    return ou.SensorInfo(
        pixels_per_column=h, columns_per_frame=w, columns_per_packet=16,
        pixel_shift_by_row=np.zeros(h, int),
        beam_azimuth_angles=np.zeros(h),
        beam_altitude_angles=np.linspace(-15.0, 15.0, h),
        beam_to_lidar=np.eye(4), lidar_to_sensor=np.eye(4),
        udp_profile_lidar=ou.PROFILE_SINGLE)


# Vertical pillars inside the room: a bare cylinder room is rotationally
# symmetric (yaw + tangential translation near-degenerate for
# registration); pillars break the symmetry like furniture/columns would.
_PILLARS = np.array([[3.0, 1.0, 0.45], [-2.0, 4.0, 0.6], [1.5, -3.5, 0.5],
                     [-4.0, -2.0, 0.4], [5.0, -1.0, 0.35],
                     [-1.0, 6.0, 0.5], [6.0, 3.0, 0.45]])


def _ranges_m(dirs_w, origin, radius=8.0, z_floor=-0.8, z_ceil=3.0,
              rng=None):
    """Exact ray ranges from ``origin`` ((3,), or (N, 3): one per ray)
    along world directions into the cylinder room (+ pillars); 5 mm
    surface noise. Elementwise, so rays of several columns in one call
    give each column's bits, and the noise is drawn in ray order."""
    ux, uy, uz = dirs_w[:, 0], dirs_w[:, 1], dirs_w[:, 2]
    origin = np.asarray(origin)
    px, py, pz = origin[..., 0], origin[..., 1], origin[..., 2]
    a = ux * ux + uy * uy
    b = 2 * (px * ux + py * uy)
    c = px * px + py * py - radius * radius
    disc = np.maximum(b * b - 4 * a * c, 0.0)
    r_cyl = np.where(a > 1e-9, (-b + np.sqrt(disc)) / np.maximum(
        2 * a, 1e-9), np.inf)
    r_fl = np.where(uz < -1e-6, (z_floor - pz) / uz, np.inf)
    r_ce = np.where(uz > 1e-6, (z_ceil - pz) / uz, np.inf)
    r = np.minimum(np.minimum(np.where(r_cyl > 0, r_cyl, np.inf), r_fl),
                   r_ce)
    for cx, cy, pr in _PILLARS:
        qx, qy = px - cx, py - cy
        bp = 2 * (qx * ux + qy * uy)
        cp = qx * qx + qy * qy - pr * pr
        dp = bp * bp - 4 * a * cp
        hit = (dp > 0) & (a > 1e-9)
        r_p = np.where(hit, (-bp - np.sqrt(np.maximum(dp, 0.0)))
                       / np.maximum(2 * a, 1e-9), np.inf)
        r_p = np.where(r_p > 0.1, r_p, np.inf)
        r = np.minimum(r, r_p)
    if rng is not None:
        r = r + rng.normal(scale=0.005, size=r.shape)
    return r


def _lidar_packet(pf, frame_id, m_ids, ts_ns, rng_mm):
    """One RNG19_RFL8_SIG16_NIR16 lidar packet: frame id, per column its
    timestamp, measurement id and status 1, per pixel the 19-bit range
    [mm] and reflectivity 200."""
    buf = np.zeros(pf.lidar_packet_size, np.uint8)
    buf[2:4] = np.frombuffer(int(frame_id).to_bytes(2, "little"), np.uint8)
    cols = buf[pf.packet_header_size:
               pf.packet_header_size + pf.cols * pf.col_size].reshape(
                   pf.cols, pf.col_size)
    cols[:, 0:8] = np.asarray(ts_ns, "<u8").view(np.uint8).reshape(-1, 8)
    cols[:, 8:10] = np.asarray(m_ids, "<u2").view(np.uint8).reshape(-1, 2)
    cols[:, 10:12] = np.asarray([1, 0], np.uint8)
    px = cols[:, pf.col_header_size:
              pf.col_header_size + pf.h * pf.chan].reshape(
                  pf.cols, pf.h, pf.chan)
    words = (np.asarray(rng_mm, np.uint32).T & 0x0007FFFF).astype("<u4")
    px[:, :, 0:4] = words.view(np.uint8).reshape(pf.cols, pf.h, 4)
    px[:, :, 4] = 200                                # reflectivity
    return buf.tobytes()


def _imu_packet(ts_ns, accel_ms2, gyro_rads):
    """48-byte IMU packet: sys ts at 0:8, accel [g] f32 at 24:36, gyro
    [deg/s] f32 at 36:48 (parse_imu_packet's inverse)."""
    buf = bytearray(48)
    buf[0:8] = int(ts_ns).to_bytes(8, "little")
    f = np.empty(6, np.float32)
    f[0:3] = np.asarray(accel_ms2) / G
    f[3:6] = np.asarray(gyro_rads) * 180.0 / np.pi
    buf[24:48] = f.tobytes()
    return bytes(buf)


def write_pcap_fixture(out_dir: str, hold: float = 3.5,
                       drive: float = 4.0, seed: int = 9, h: int = 16,
                       w: int = 512, frame_hz: float = 10.0) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    info = make_info(h, w)
    pf = ou.PacketFormat(info)
    direction, offset = ou.make_xyz_lut(info)
    # the LUT folds the mm->m range unit into direction (xyz = dir *
    # range_mm); the raycast needs unit directions
    dirs = direction.reshape(h, w, 3)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    rng = np.random.default_rng(seed)
    fn = still_then(synthetic._pose_of, hold)

    packets = []
    # IMU stream at 100 Hz
    T = hold + drive
    for t in np.arange(0.0, T, 0.01):
        wv, f = synthetic._numeric_imu(t, pose_fn=fn)
        packets.append((t, 7503, _imu_packet(PCAP_BASE_NS + int(t * 1e9),
                                             f, wv)))

    # lidar frames: column v of frame k fires at k/hz + v * (1/hz)/w
    dt_col = (1.0 / frame_hz) / w
    cpp = info.columns_per_packet
    n_frames = int(T * frame_hz) - 1
    for k in range(n_frames):
        t0 = k / frame_hz
        for p in range(w // cpp):
            m_ids = np.arange(cpp) + p * cpp
            t_cols = t0 + m_ids * dt_col
            ts_ns = (PCAP_BASE_NS + (t_cols * 1e9)).astype(np.uint64)
            # the packet's rays column by column (each at its firing
            # pose), cast in one call
            dw, origin = [], []
            for tv, v in zip(t_cols, m_ids):
                R, ppos = fn(tv)
                dw.append(dirs[:, v, :] @ R.T)
                origin.append(np.broadcast_to(ppos, (h, 3)))
            r = _ranges_m(np.concatenate(dw), np.concatenate(origin),
                          rng=rng)
            rng_mm = np.clip(r * 1000.0, 0, 40_000).astype(
                np.uint32).reshape(cpp, h).T
            packets.append((float(t_cols[0]), 7502,
                            _lidar_packet(pf, k + 1, m_ids, ts_ns, rng_mm)))

    packets.sort(key=lambda e: e[0])
    pcap_path = os.path.join(out_dir, "fixture.pcap")
    n = pcap_mod.write_pcap(pcap_path, packets)

    meta_path = os.path.join(out_dir, "metadata.json")
    with open(meta_path, "w") as f:
        f.write(info.to_json())

    gt_path = os.path.join(out_dir, "gt.tum")
    with open(gt_path, "w") as f:
        for t in np.arange(0.0, T, 0.05):
            R, p = fn(t)
            q = synthetic._mat_to_quat(R)
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")

    return {"pcap": pcap_path, "metadata": meta_path, "gt": gt_path,
            "n_packets": n, "n_frames": n_frames,
            "bytes": os.path.getsize(pcap_path)}


def write_mulran_fixture(out: str, duration: float = 8.0,
                         hold: float = 3.5, n_points: int = 2048,
                         seed: int = 42, imu_hz: float = 100.0,
                         scan_hz: float = 10.0, pose_fn=None) -> dict:
    """``pose_fn`` overrides the driving trajectory (e.g.
    synthetic.loop_pose_of for a closed loop); the stationary calibration
    hold is prepended either way."""
    fn = still_then(pose_fn or synthetic._pose_of, hold)
    sim = synthetic.make_sim(duration=hold + duration, imu_hz=imu_hz,
                             scan_hz=scan_hz, n_points=n_points,
                             calib_time=0.0, seed=seed, pose_fn=fn)

    sd = os.path.join(out, "sensor_data")
    ouster_dir = os.path.join(sd, "Ouster")
    os.makedirs(ouster_dir, exist_ok=True)

    rng = np.random.default_rng(seed + 1)
    events = []

    # --- IMU: 17-field xsens v2 rows ------------------------------------
    with open(os.path.join(sd, "xsens_imu.csv"), "w") as f:
        for i, t in enumerate(sim.imu_stamps):
            ns = MULRAN_BASE_NS + int(round(t * 1e9))
            R, _ = sim.pose(t)
            q = synthetic._mat_to_quat(R)          # wxyz
            g = sim.imu_ang[i]
            a = sim.imu_acc[i]
            row = ([ns, q[1], q[2], q[3], q[0], 0.0, 0.0, 0.0,
                    g[0], g[1], g[2], a[0], a[1], a[2], 0.0, 0.0, 0.0])
            f.write(",".join(f"{v:.9g}" if k else str(v)
                             for k, v in enumerate(row)) + "\n")
            events.append((ns, "imu"))

    # --- Scans: float32 x,y,z,intensity bins ----------------------------
    n_scans = 0
    for i, t in enumerate(sim.scan_stamps):
        if t < hold - 0.5:        # park the sensor during calibration
            continue
        ns = MULRAN_BASE_NS + int(round(t * 1e9))
        _, xyz, _ = sim.scan(i)
        rec = np.empty((xyz.shape[0], 4), np.float32)
        rec[:, :3] = xyz
        rec[:, 3] = rng.uniform(0, 512, xyz.shape[0]).astype(np.float32)
        rec.tofile(os.path.join(ouster_dir, f"{ns}.bin"))
        events.append((ns, "ouster"))
        n_scans += 1

    # --- dispatch order --------------------------------------------------
    events.sort()
    with open(os.path.join(sd, "data_stamp.csv"), "w") as f:
        for ns, tag in events:
            f.write(f"{ns},{tag}\n")

    # --- ground truth: stamp_ns + row-major 3x4 -------------------------
    with open(os.path.join(out, "global_pose.csv"), "w") as f:
        for t in np.arange(0.0, hold + duration, 0.1):
            ns = MULRAN_BASE_NS + int(round(t * 1e9))
            R, p = sim.pose(t)
            T = np.concatenate([R, p[:, None]], axis=1)   # (3, 4)
            f.write(str(ns) + ","
                    + ",".join(f"{v:.9g}" for v in T.reshape(-1)) + "\n")

    # --- gps.csv: stamp_ns + lat/lon/alt + 9 covariance -----------------
    # (ROSThread.cpp:152-170 parse; lat/lon synthesized from the ground-
    # truth positions at ~1e-5 deg/m around a MulRan-plausible origin).
    n_gps = 0
    with open(os.path.join(sd, "gps.csv"), "w") as f:
        for t in np.arange(0.0, hold + duration, 0.25):
            ns = MULRAN_BASE_NS + int(round(t * 1e9))
            _, p = sim.pose(t)
            lat = 36.37 + p[1] * 9.0e-6
            lon = 127.36 + p[0] * 1.12e-5
            row = [ns, f"{lat:.9f}", f"{lon:.9f}", f"{p[2]:.4f}"] + \
                ["2.25", "0", "0", "0", "2.25", "0", "0", "0", "9.0"]
            f.write(",".join(str(v) for v in row) + "\n")
            n_gps += 1

    # --- radar/polar PNGs: <stamp_ns>.png mono8 -------------------------
    # (directory layout + name convention, ROSThread.cpp:262-284; content
    # is synthetic — the player only moves the images, it never parses
    # them).
    from PIL import Image

    radar_dir = os.path.join(sd, "radar", "polar")
    os.makedirs(radar_dir, exist_ok=True)
    rng_r = np.random.default_rng(seed + 2)
    n_radar = 0
    for t in np.arange(hold, hold + duration, 0.25):
        ns = MULRAN_BASE_NS + int(round(t * 1e9))
        img = (rng_r.integers(0, 60, (64, 128))
               + np.linspace(0, 180, 128)[None, :]).astype(np.uint8)
        Image.fromarray(img, mode="L").save(
            os.path.join(radar_dir, f"{ns}.png"))
        n_radar += 1

    return {"out": out, "n_scans": n_scans, "n_imu": len(sim.imu_stamps),
            "n_gps": n_gps, "n_radar": n_radar,
            "duration_s": hold + duration, "n_points": n_points}


BAG_EPOCH = 1_600_000_000.0   # [s] added to the simulator's stamps


def write_sim_bag(path: str, sim, compression: str = "none",
                  scans=None) -> dict:
    """A ROS1 bag of a ``synthetic.make_sim`` sequence, as a driver
    records it: ``sensor_msgs/Imu`` at each IMU stamp and
    ``sensor_msgs/PointCloud2`` (x, y, z and per-point ``t`` [ns], stamped
    at the sweep's start) once its last point is measured, every stamp
    shifted by ``BAG_EPOCH``. So each scan lands in the bag before the IMU
    sample that covers its sweep end, and a replay holds it back
    (``NeedMoreImu``) until that sample arrives. ``scans``: the first
    scans as ``sim.scan`` drew them (default: every scan, drawn here)."""
    if scans is None:
        scans = [sim.scan(i) for i in range(len(sim.scan_stamps))]
    events = sorted([(t, 1, i) for i, t in enumerate(sim.imu_stamps)]
                    + [(h + pt.max(), 0, i)
                       for i, (h, _, pt) in enumerate(scans)])
    w = BagWriter(path, compression=compression)
    for _, kind, i in events:
        if kind == 1:
            w.write_imu("/imu/data_raw", sim.imu_stamps[i] + BAG_EPOCH,
                        sim.imu_ang[i], sim.imu_acc[i])
        else:
            header, xyz, pt = scans[i]
            w.write_pointcloud2("/os1_points", header + BAG_EPOCH, xyz,
                                (pt * 1e9).astype(np.uint32))
    w.close()
    return {"bag": path, "n_scans": len(scans),
            "n_imu": len(sim.imu_stamps), "bytes": os.path.getsize(path)}
