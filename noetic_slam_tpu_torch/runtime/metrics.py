"""Runtime metrics + terminal dashboard.

Equivalent of the reference's hand-rolled observability (SURVEY.md §5):
per-scan compute times and rates (odom.cc:743,828,952-954), CPU%/RSS from
/proc (odom.cc:1831-1869), and the per-scan terminal dashboard
(odom.cc:1787-1988) — plus JAX-profiler hooks the reference had no
equivalent for.

The port's own copy of ``noetic_slam_tpu.runtime.metrics`` (it imports
nothing of the JAX package); ``tests/test_torch_ingest.py`` holds it to the
original.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Optional

import numpy as np


class RateTracker:
    """Sliding-window rate estimate from message stamps."""

    def __init__(self, window: int = 100):
        self.stamps: deque = deque(maxlen=window)

    def push(self, stamp: float) -> None:
        self.stamps.append(stamp)

    @property
    def hz(self) -> float:
        if len(self.stamps) < 2:
            return 0.0
        dt = self.stamps[-1] - self.stamps[0]
        return (len(self.stamps) - 1) / dt if dt > 0 else 0.0


class ProcessStats:
    """CPU utilization + RSS from /proc (reference reads /proc/self/stat and
    times(); same sources here)."""

    def __init__(self):
        self._last = None

    def sample(self) -> dict:
        try:
            with open("/proc/self/stat") as f:
                parts = f.read().split()
            utime, stime = int(parts[13]), int(parts[14])
            rss_pages = int(parts[23])
        except OSError:
            return {"cpu_percent": 0.0, "rss_gb": 0.0}
        clk = os.sysconf("SC_CLK_TCK")
        page = os.sysconf("SC_PAGE_SIZE")
        now = time.monotonic()
        cpu = 0.0
        if self._last is not None:
            (lu, ls, lt) = self._last
            wall = now - lt
            if wall > 0:
                cpu = 100.0 * ((utime - lu) + (stime - ls)) / clk / wall
        self._last = (utime, stime, now)
        return {"cpu_percent": cpu, "rss_gb": rss_pages * page / 2 ** 30}


class SlamMetrics:
    """Aggregates per-scan statistics; renders a dashboard line/panel."""

    def __init__(self):
        self.comp_times: deque = deque(maxlen=1000)
        self.lidar_rate = RateTracker()
        self.imu_rate = RateTracker(window=500)
        self.proc = ProcessStats()
        self.n_scans = 0
        self.n_keyframes = 0
        self.distance_traveled = 0.0
        self._last_p: Optional[np.ndarray] = None

    def scan_done(self, stamp: float, comp_time: float, p,
                  is_keyframe: bool) -> None:
        self.comp_times.append(comp_time)
        self.lidar_rate.push(stamp)
        self.n_scans += 1
        self.n_keyframes += int(is_keyframe)
        p = np.asarray(p)
        if self._last_p is not None:
            self.distance_traveled += float(np.linalg.norm(p - self._last_p))
        self._last_p = p

    def imu_seen(self, stamp: float) -> None:
        self.imu_rate.push(stamp)

    def summary(self) -> dict:
        ct = np.asarray(self.comp_times) if self.comp_times else np.zeros(1)
        s = self.proc.sample()
        return {
            "scans": self.n_scans,
            "keyframes": self.n_keyframes,
            "distance_m": round(self.distance_traveled, 2),
            "comp_ms_avg": round(float(ct.mean()) * 1000, 2),
            "comp_ms_max": round(float(ct.max()) * 1000, 2),
            "lidar_hz": round(self.lidar_rate.hz, 1),
            "imu_hz": round(self.imu_rate.hz, 1),
            **{k: round(v, 2) for k, v in s.items()},
        }

    def dashboard(self, pose_p=None) -> str:
        """Compact terminal panel (the odom.cc:1871-1987 dashboard's role)."""
        m = self.summary()
        lines = [
            "+---------------- noetic_slam_tpu ----------------+",
            f"| scans {m['scans']:>7}   keyframes {m['keyframes']:>5}"
            f"   dist {m['distance_m']:>8.2f} m |",
            f"| comp {m['comp_ms_avg']:>6.1f} ms avg {m['comp_ms_max']:>7.1f}"
            f" ms max            |",
            f"| lidar {m['lidar_hz']:>5.1f} Hz   imu {m['imu_hz']:>6.1f} Hz"
            f"   cpu {m['cpu_percent']:>5.1f}%%    |",
            f"| rss {m['rss_gb']:>6.2f} GB"
            + " " * 38 + "|",
        ]
        if pose_p is not None:
            p = np.asarray(pose_p)
            lines.insert(1, f"| p = [{p[0]:>8.2f} {p[1]:>8.2f} {p[2]:>8.2f}]"
                         + " " * 17 + "|")
        lines.append("+-------------------------------------------------+")
        return "\n".join(lines)
