"""Scans made ahead of their use, in a process of their own, so that the
generator's cost stays off the host thread that drives the program.

``Prefetch(sensor_cfg, traffic, seed)`` starts one worker,
``python -m benchmark.gen.producer <arguments>``: a thread there makes
scans 0, 1, 2, ... in order, up to ``depth`` ahead, and another writes
each to the worker's standard output (a length-prefixed JSON header, then
the raw float32 points and float64 times), so that a replay that takes a
batch of scans at once finds them made. ``get(i)`` reads scan ``i`` from
the pipe on the calling thread: the measured process starts no thread of
its own. ``close()`` ends the worker and waits for it. The worker imports
numpy and this package's generator only, and shares nothing but the pipe.
"""

from __future__ import annotations

import fcntl
import json
import os
import queue
import struct
import subprocess
import sys
import threading

import numpy as np

from benchmark.gen.path import Path
from benchmark.gen.scene import Scene
from benchmark.gen.sensor import Sensor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_sensor(sensor_cfg: dict, traffic: dict, seed: int) -> Sensor:
    path = Path(traffic["path"], seed)
    return Sensor(sensor_cfg, path, Scene(path, traffic["scene"], seed),
                  seed)


def _write(out, i, header, xyz, pt) -> None:
    meta = json.dumps({"i": i, "header": header, "n": len(xyz),
                       "pt": pt is not None}).encode()
    out.write(struct.pack("<I", len(meta)) + meta)
    out.write(np.ascontiguousarray(xyz, np.float32).tobytes())
    if pt is not None:
        out.write(np.ascontiguousarray(pt, np.float64).tobytes())
    out.flush()


def main() -> None:
    """The worker: every scan of the sequence, until the pipe closes."""
    args = json.loads(sys.argv[1])
    sensor = make_sensor(args["sensor"], args["traffic"], args["seed"])
    made: queue.Queue = queue.Queue(maxsize=int(args["depth"]))

    def make() -> None:
        i = 0
        while True:
            made.put((i, *sensor.scan(i)))
            i += 1

    threading.Thread(target=make, daemon=True).start()
    out = sys.stdout.buffer
    try:
        while True:
            _write(out, *made.get())
    except BrokenPipeError:
        pass


class Prefetch:
    def __init__(self, sensor_cfg: dict, traffic: dict, seed: int,
                 depth: int = 24):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
        arg = json.dumps({"sensor": sensor_cfg, "traffic": traffic,
                          "seed": seed, "depth": depth})
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.gen.producer", arg],
            stdout=subprocess.PIPE, cwd=REPO, env=env)
        try:        # a pipe that holds a whole scan: one read a scan
            fcntl.fcntl(self._proc.stdout, fcntl.F_SETPIPE_SZ, 1 << 20)
        except OSError:
            pass
        self._next = 0

    def _read(self, n: int) -> bytes:
        buf = self._proc.stdout.read(n)
        if len(buf) < n:
            raise RuntimeError("the scan generator ended (exit code "
                               f"{self._proc.poll()})")
        return buf

    def get(self, i: int):
        """Scan ``i``: (header, xyz, per-point offsets or None). Scans are
        taken in rising order; those passed over are dropped."""
        if i < self._next:
            raise ValueError(f"scan {i} was passed over (next {self._next})")
        while True:
            (m,) = struct.unpack("<I", self._read(4))
            meta = json.loads(self._read(m))
            n = meta["n"]
            xyz = np.frombuffer(self._read(12 * n), np.float32).reshape(n, 3)
            pt = (np.frombuffer(self._read(8 * n), np.float64)
                  if meta["pt"] else None)
            self._next = meta["i"] + 1
            if meta["i"] == i:
                return meta["header"], xyz, pt

    def close(self) -> None:
        self._proc.terminate()
        try:
            self._proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._proc.stdout.close()


if __name__ == "__main__":
    main()
