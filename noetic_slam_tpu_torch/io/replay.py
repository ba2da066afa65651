"""Deterministic dataset replay over the port's pipeline (port of
``noetic_slam_tpu.io.replay``).

Events are dispatched strictly in stamp order and a scan runs once the IMU
covers its sweep end (the reference's cv wait), with optional real-time
pacing. The JAX module's ``replay_dataset`` imports the JAX pipeline, so
the port carries its own loop and its own ``NeedMoreImu``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu


@dataclasses.dataclass
class ReplayClock:
    """Deterministic clock with optional real-time pacing (play rate)."""
    rate: float = 0.0            # 0 = as fast as possible
    _start_wall: float = 0.0
    _start_data: float = 0.0
    started: bool = False

    def wait_until(self, stamp: float) -> None:
        if self.rate <= 0:
            return
        if not self.started:
            self._start_wall = time.monotonic()
            self._start_data = stamp
            self.started = True
            return
        delay = (self._start_wall + (stamp - self._start_data) / self.rate
                 - time.monotonic())
        if delay > 0:
            time.sleep(delay)


def replay_dataset(dataset, pipeline, rate: float = 0.0,
                   max_scans: Optional[int] = None,
                   on_scan: Optional[Callable] = None,
                   skip_stop_region: Optional[tuple] = None,
                   batch: int = 1,
                   on_batch: Optional[Callable] = None) -> dict:
    """Drive a MulranDataset (or anything with its interface: ``events()``,
    ``read_scan(i)``, ``imu_stamps``/``imu_gyro``/``imu_accel``) through
    the port's ``OdometryPipeline``.

    ``on_scan(idx, out)`` receives each StepOutput; ``skip_stop_region``
    (t0, t1) drops events inside an absolute stamp window; ``batch`` > 1
    hands K scans at a time to ``process_scans`` (requires rate == 0 and
    no ``on_scan``), with ``on_batch(n_scans)`` after each.
    Returns {"n_scans", "n_imu", "wall_time"}.
    """
    if batch > 1 and (rate > 0 or on_scan is not None):
        raise ValueError("batch>1 requires rate=0 and no per-scan callbacks")
    clock = ReplayClock(rate=rate)
    n_scans = n_imu = 0
    pending = None       # scan waiting for IMU coverage
    ready: list = []     # batched mode: scans awaiting one submission
    t0 = time.perf_counter()

    def flush_ready():
        nonlocal n_scans
        pipeline.process_scans(ready)
        n_scans += len(ready)
        ready.clear()
        if on_batch is not None:
            on_batch(n_scans)

    def run_scan(stamp, idx):
        nonlocal n_scans
        raw = dataset.read_scan(idx)
        if batch > 1:
            # coverage gate before queueing: a flush never fails on a scan
            # already accepted into the batch
            if not pipeline.imu_covers(stamp):
                raise NeedMoreImu(f"IMU must cover {stamp:.6f}")
            ready.append((stamp, raw[:, :3], None))
            if len(ready) >= batch:
                flush_ready()
            return
        out = pipeline.process_scan(stamp, raw[:, :3], point_times=None)
        if on_scan is not None:
            on_scan(idx, out)
        n_scans += 1

    for stamp, kind, idx in dataset.events():
        if (skip_stop_region
                and skip_stop_region[0] <= stamp <= skip_stop_region[1]):
            continue
        clock.wait_until(stamp)
        if kind == "imu":
            pipeline.push_imu(dataset.imu_stamps[idx], dataset.imu_gyro[idx],
                              dataset.imu_accel[idx])
            n_imu += 1
            if pending is not None and pipeline.calibrated:
                try:
                    run_scan(*pending)
                    pending = None
                except NeedMoreImu:
                    pass
        elif kind == "scan":
            if not pipeline.calibrated:
                continue
            try:
                run_scan(stamp, idx)
            except NeedMoreImu:
                pending = (stamp, idx)
        if max_scans is not None and n_scans + len(ready) >= max_scans:
            break
    if ready:
        flush_ready()
    return {"n_scans": n_scans, "n_imu": n_imu,
            "wall_time": time.perf_counter() - t0}
