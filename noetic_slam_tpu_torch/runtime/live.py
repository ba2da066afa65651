"""Live sensor driver: UDP packets -> scans -> SLAM.

The single-process composition of the reference's driver nodelet chain
(OusterSensor connection loop + packet handlers + PointCloudProcessor,
src/ouster/src/os_sensor_nodelet.cpp:510-570, os_driver_nodelet.cpp) and
the odometry subscriber: the native UDP receiver thread
(runtime.native.UdpSource ~ client.cpp poll loop) feeds the Python-side
ScanBatcher; completed frames project through the XYZ LUT and go straight
into the SLAM system — no serialization boundary.

Timestamp strategies (lidar_packet_handler.h:85-311):
- "sensor": scan stamp estimated from column timestamps with gap
  imputation/extrapolation (compute_scan_ts_0/_n via io.ouster.
  ScanTimestamper).
- "ptp":    TIME_FROM_PTP_1588 — sensor strategy after adding
  ptp_utc_tai_offset to every column/IMU timestamp (clamped at 0,
  lidar_packet_handler.h:253-264, imu_packet_handler.h:36-41).
- "host":   scan stamp = host receive time of the frame's first packet,
  extrapolated back to column 0 (TIME_FROM_ROS_TIME,
  lidar_packet_handler.h:234-282); per-point times stay relative to the
  sensor column clock either way.

Failure handling mirrors the driver's poll-error accounting
(os_sensor_nodelet.cpp:458-469): consecutive read timeouts beyond a limit
raise, so a supervisor can reset the source.

The port's own copy of ``noetic_slam_tpu.runtime.live`` (it imports nothing
of the JAX package): packets go through the port's ``io.ouster`` and
``runtime.native`` and a reset through the port's ``io.sensor_http``.
``tests/test_torch_live.py`` holds it to the original.

One departure: the JAX driver drops every frame that the system refuses
with ``NeedMoreImu``. After the calibration hold that is the frame whose
covering IMU sample has not been drained yet; the sample lands with or
just after the next frame's first packet, which completes the frame, and
the IMU is drained only at the start of a poll. At the sensor's pace,
with the receiver waiting in its lidar read, it then drops nearly every
frame (``chip_smoke.py`` phase 13 streams a capture at 10 Hz under both
rules). The port holds such a frame and submits it again after the
next IMU drain, as the replay loops hold a scan pending (the reference's
odometry waits for the IMU, odom.cc:1024-1028); a newer frame replaces a
held one. Frames refused during the calibration hold are still dropped.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from noetic_slam_tpu_torch.io import ouster as ou
from noetic_slam_tpu_torch.runtime import native
from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu


class LiveDriver:
    def __init__(self, slam, info: ou.SensorInfo, lidar_port: int = 7502,
                 imu_port: int = 7503, timestamp_mode: str = "sensor",
                 ptp_utc_tai_offset_s: float = -37.0,
                 max_read_errors: int = 60,
                 sensor_hostname: str | None = None,
                 mtp_group: str | None = None, max_resets: int = 3):
        if timestamp_mode not in ("sensor", "ptp", "host"):
            raise ValueError(f"unknown timestamp_mode {timestamp_mode!r}")
        self.slam = slam
        self.info = info
        self.pf = ou.PacketFormat(info)
        self.batcher = ou.ScanBatcher(info)
        self.direction, self.offset = ou.make_xyz_lut(info)
        self.timestamp_mode = timestamp_mode
        self.ptp_offset_ns = (int(ptp_utc_tai_offset_s * 1e9)
                              if timestamp_mode == "ptp" else 0)
        self.timestamper = ou.ScanTimestamper(info, self.ptp_offset_ns)
        self._col_spacing_ns = ou.scan_col_ts_spacing_ns(info)
        self._host_frame_ts: Optional[float] = None
        self.max_read_errors = max_read_errors
        self.sensor_hostname = sensor_hostname
        self.max_resets = max_resets
        self.n_resets = 0
        self._ports = (lidar_port, imu_port)
        self._mtp_group = mtp_group
        self.source = native.UdpSource(lidar_port, imu_port,
                                       self.pf.lidar_packet_size,
                                       self.pf.imu_packet_size,
                                       mtp_group=mtp_group)
        self.n_scans = 0
        self.n_imu = 0
        self._errors = 0
        self._held = None            # (header, xyz, rel_t) awaiting IMU
        self.n_held = 0              # frames held back for their IMU
        self.n_refused = 0           # frames dropped: calibration hold, or
                                     # replaced while held

    def poll_once(self, timeout_ms: int = 100) -> bool:
        """Drain available packets; process at most one completed frame.
        Returns True if anything was received."""
        got = False
        imu_buf = self.source.read_imu(timeout_ms=0)
        while imu_buf is not None:
            ts_ns, accel, gyro = self.pf.parse_imu_packet(imu_buf)
            if self.timestamp_mode == "host":
                stamp = time.time()
            else:  # sensor / ptp (imu_packet_handler.h:36-41)
                stamp = int(ou.ts_safe_offset_add(
                    np.uint64(ts_ns), self.ptp_offset_ns)) * 1e-9
            self.slam.push_imu(stamp, gyro, accel)
            self.n_imu += 1
            got = True
            imu_buf = self.source.read_imu(timeout_ms=0)
        if got and self._held is not None:
            self._submit(*self._held)

        # sensor/ptp stamps don't need per-packet receive times: drain a
        # whole chunk in one native call + one batch parse (the per-packet
        # Python hop otherwise bounds throughput at 2048x20 rates — see
        # ScanBatcher.push_many). Host-stamp mode needs the receive time of
        # each frame's first packet, so it keeps the per-packet path.
        if self.timestamp_mode != "host":
            buf, n = self.source.read_lidar_many(max_n=64,
                                                 timeout_ms=timeout_ms)
            if n == 0:
                self._errors += 1
                if self._errors >= self.max_read_errors:
                    self._attempt_reset()
                return got
            self._errors = 0
            for scan in self.batcher.push_many(buf, n):
                self._process_frame(scan, None)
            return True

        pkt = self.source.read_lidar(timeout_ms=timeout_ms)
        if pkt is None:
            self._errors += 1
            if self._errors >= self.max_read_errors:
                self._attempt_reset()
            return got
        self._errors = 0
        got = True
        done = self.batcher.push(pkt)
        if self.timestamp_mode == "host":
            # TIME_FROM_ROS_TIME: receive time of a frame's FIRST packet,
            # extrapolated back to column 0 by the packet's first
            # measurement id (lidar_packet_handler.h:234-242,266-282).
            # On rollover `pkt` opens the next frame, so stash its estimate
            # after consuming the previous one for the completed scan.
            first_m_id = int(np.frombuffer(
                pkt, np.uint16, 1, offset=self.pf.packet_header_size + 8)[0])
            pkt_frame_ts = time.time() - (self._col_spacing_ns
                                          * first_m_id * 1e-9)
            if self._host_frame_ts is None:
                self._host_frame_ts = pkt_frame_ts
            if done is not None:
                self._process_frame(done, self._host_frame_ts)
                self._host_frame_ts = pkt_frame_ts
        elif done is not None:
            self._process_frame(done, None)
        return got

    def _process_frame(self, scan: ou.LidarScan,
                       host_ts: Optional[float]) -> None:
        scan_ts_ns = self.timestamper(scan.timestamp)
        xyz, rel_t, valid, scan_ts_ns = ou.scan_to_points(
            scan, self.direction, self.offset, scan_ts_ns=scan_ts_ns,
            ts_offset_ns=self.ptp_offset_ns)
        header = host_ts if host_ts is not None else scan_ts_ns * 1e-9
        xyz = np.where(valid[:, None], xyz, np.float32(np.nan))
        if self._held is not None:       # replaced by a newer frame
            self._held = None
            self.n_refused += 1
        self._submit(header, xyz, rel_t.astype(np.float64))

    def _submit(self, header: float, xyz: np.ndarray,
                rel_t: np.ndarray) -> None:
        """One frame into the system. A frame the IMU does not cover yet is
        held for the next IMU drain; during the calibration hold it is
        dropped."""
        try:
            self.slam.process_scan(header, xyz, rel_t)
        except NeedMoreImu:
            if self._held is None and getattr(self.slam, "calibrated", True):
                self._held = (header, xyz, rel_t)
                self.n_held += 1
            elif self._held is None:
                self.n_refused += 1
            return
        self._held = None
        self.n_scans += 1

    def _attempt_reset(self) -> None:
        """Self-reset after sustained packet loss — the driver behavior at
        os_sensor_nodelet.cpp:458-469 (poll-error counter -> sensor
        reinitialization + reconnection). Without a configured sensor
        hostname the condition escalates to the supervisor."""
        if self.sensor_hostname is None or self.n_resets >= self.max_resets:
            raise TimeoutError(
                f"no lidar packets for {self.max_read_errors} polls after "
                f"{self.n_resets} reset attempts (sensor reset required)")
        from noetic_slam_tpu_torch.io.sensor_http import SensorHttp

        self.n_resets += 1
        self._errors = 0
        try:
            SensorHttp(self.sensor_hostname).reinitialize()
        except Exception:
            pass  # reinit best-effort; reopening sockets below still helps
        self.source.close()
        self.source = native.UdpSource(self._ports[0], self._ports[1],
                                       self.pf.lidar_packet_size,
                                       self.pf.imu_packet_size,
                                       mtp_group=self._mtp_group)
        self.batcher = ou.ScanBatcher(self.info)

    def run(self, duration_s: Optional[float] = None) -> None:
        t0 = time.monotonic()
        while duration_s is None or time.monotonic() - t0 < duration_s:
            self.poll_once()

    def close(self):
        self.source.close()
