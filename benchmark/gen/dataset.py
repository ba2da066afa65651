"""A dataset with the MulRan reader's interface (``events()``,
``read_scan(i)``, ``imu_stamps`` / ``imu_gyro`` / ``imu_accel``) over the
generated sequence, for the port's own replay loop
(``io.replay.replay_dataset``). Scans come from ``source(i)`` (a
``Prefetch``'s ``get``), the IMU from the sensor model.

The sequence is endless: ``events()`` merges the IMU and scan stamps in
time order (IMU first at equal stamps, as the MulRan reader orders them)
until ``stop()`` is called, and every array is computed when indexed, in
blocks. ``read_scan`` runs under the harness's ``generate`` span and adds
its host seconds (the wait for the scan) to ``gen_seconds``; it keeps
every scan it hands over in ``scans`` for the comparison after the
window.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.gen.sensor import Sensor


class _Blocks:
    """An endless IMU column computed in blocks of ``size`` samples."""

    def __init__(self, sensor: Sensor, col: int, size: int = 4096):
        self._sensor, self._col, self._size = sensor, col, size
        self._cache: dict = {}

    def __getitem__(self, j: int):
        k, r = divmod(int(j), self._size)
        blk = self._cache.get(k)
        if blk is None:
            blk = self._sensor.imu(k * self._size, (k + 1) * self._size)
            self._cache = {k: blk}        # replay reads forward only
        return blk[self._col][r]


class SyntheticDataset:
    """``sensor``: the sensor model; ``source(i)``: scan ``i`` as
    (header, xyz, per-point offsets or None); ``span``: a context-manager
    factory that names a host span (the harness's ``Spans``)."""

    def __init__(self, sensor: Sensor, source, span):
        self.sensor = sensor
        self._source = source
        self._span = span
        self.imu_stamps = _Blocks(sensor, 0)
        self.imu_gyro = _Blocks(sensor, 1)
        self.imu_accel = _Blocks(sensor, 2)
        self._stop = False
        self.gen_seconds = 0.0
        self.gen_scans = 0
        self.scans: dict = {}          # index -> (header, xyz, times)
        self._last = None

    def stop(self) -> None:
        """End ``events()`` before its next event."""
        self._stop = True

    def events(self, kinds=("imu", "scan")):
        j = i = 0
        while not self._stop:
            t_imu = float(self.sensor.imu_stamp(j))
            t_scan = float(self.sensor.scan_stamp(i))
            if t_imu <= t_scan:
                yield t_imu, "imu", j
                j += 1
            else:
                yield t_scan, "scan", i
                i += 1

    def read_scan(self, i: int) -> np.ndarray:
        """Scan ``i`` as (n, 4) float32: x, y, z and a zero intensity (the
        replay loop reads a scan again after waiting for IMU coverage)."""
        if self._last is not None and self._last[0] == i:
            return self._last[1]
        t0 = time.perf_counter()
        with self._span("generate"):
            header, xyz, pt = self._source(i)
        self.gen_seconds += time.perf_counter() - t0
        self.gen_scans += 1
        self.scans[i] = (header, xyz, pt)
        raw = np.concatenate([xyz, np.zeros((len(xyz), 1), np.float32)],
                             axis=1)
        self._last = (i, raw)
        return raw
