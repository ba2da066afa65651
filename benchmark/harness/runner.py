"""One run of one cell: set-up, the measured window, and the record that
the metric readers and the comparison read.

The entry the window drives is the port's own:

- ``replay`` traffic: ``io.replay.replay_dataset(ds, slam, rate=0,
  batch=K, on_batch=...)`` with ``slam.maybe_close_loop()`` after each
  batch, as ``cli slam --batch K`` runs a MulRan sequence;
- ``live`` traffic: ``slam.process_scan`` one scan at a time, as
  ``runtime.live.LiveDriver`` hands over an assembled frame, and the next
  scan only after this scan's pose has been read on the host (a closed
  loop, one client); ``maybe_close_loop`` is never called, as in
  ``cli live``.

Set-up is the ``SlamSystem`` as the CLI builds it, ``warmup()``, and the
traffic's ``setup_data_s`` seconds of scans through the same entry. The
window opens after a ``torch.cuda.synchronize()`` and closes at the first
batch (or scan) boundary after ``seconds``, after another. Then the
trajectory is flushed and the map taken by ``capture`` of the
configuration's map backend module (``maps/<dlio.map_backend>.py``),
before the system is freed.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np

from benchmark.gen.dataset import SyntheticDataset
from benchmark.gen.producer import Prefetch, make_sensor
from benchmark.harness import spec
from benchmark.harness.spans import Spans
from benchmark.harness.trace import Stretch

TRACE_SECONDS = 3.0


@dataclasses.dataclass
class Record:
    """What one run leaves for the readers and the comparison."""
    setup_s: float = 0.0
    window_s: float = 0.0
    scans: int = 0                 # handed over in the window
    first_scan: int = 0            # index of the window's first scan
    end_scan: int = 0              # one past its last
    latencies: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)  # deltas
    spans: dict = dataclasses.field(default_factory=dict)     # seconds
    trace: dict | None = None
    gen_ms_per_scan: float = 0.0
    memory_peak_bytes: int = 0
    # for the comparison
    traj: np.ndarray | None = None
    payload: object = None         # the map backend module's capture
    lost_keyframes: int = 0
    scans_by_index: dict | None = None
    sensor: object = None
    dlio: dict | None = None
    ref_device: object = None
    extra: dict = dataclasses.field(default_factory=dict)


def _counters(slam) -> dict:
    from noetic_slam_tpu_torch.ops.cuda.nn_kernel import nn1_fused
    from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import block_accumulate

    return {"host_syncs": slam.host_syncs,
            "kernel_a_calls": nn1_fused.launches,
            "kernel_b_calls": block_accumulate.launches,
            "lost_keyframes": slam.sync_lost_keyframes,
            "reg_rejected": int(slam.odometry.state.reg_rejected),
            "loop_closures": slam.loop_closures,
            "submap_overflow": slam.odometry.submap_overflow}


def build_system(config: dict, device):
    """The ``SlamSystem`` of a configuration file, as the CLI builds it."""
    from noetic_slam_tpu_torch.config.params import load_config
    from noetic_slam_tpu_torch.runtime.slam import SlamSystem

    cfg = load_config(overrides=config["dlio"])
    return SlamSystem(cfg, device=device, **config["system"])


class _Timed:
    """The system as ``replay_dataset`` sees it, with each batch under the
    ``replay_batch`` span and the newest stamp handed over kept."""

    def __init__(self, slam, spans):
        self._slam, self._spans = slam, spans
        self.last_stamp = -np.inf

    def push_imu(self, *a):
        self._slam.push_imu(*a)

    @property
    def calibrated(self):
        return self._slam.calibrated

    def imu_covers(self, stamp):
        return self._slam.imu_covers(stamp)

    def process_scans(self, batch):
        with self._spans("replay_batch"):
            self._slam.process_scans(batch)
        self.last_stamp = batch[-1][0]


class Window:
    """The phases of a run: set-up until the data reaches ``setup_data``
    seconds, then ``seconds`` of wall time, with a traced stretch when
    ``trace``."""

    def __init__(self, seconds, setup_data, trace, spans, sync):
        self.seconds, self.setup_data = seconds, setup_data
        self.spans, self.sync = spans, sync
        self.phase = "setup"
        self.t_open = self.t_close = None
        self.stretch = Stretch(spans) if trace else None
        self.opened = []            # callbacks at the opening

    def step(self, data_stamp: float, n_scans: int) -> bool:
        """Called at each batch (or scan) boundary with the newest stamp
        and the scans handed over so far. Returns True when the window has
        closed."""
        now = time.perf_counter()
        if self.phase == "setup":
            if data_stamp >= self.setup_data:
                self.sync()
                for f in self.opened:
                    f()
                self.t_open = time.perf_counter()
                self.n_open = n_scans
                self.phase = "window"
                self.spans.counting = True
            return False
        if self.phase != "window":
            return True
        st = self.stretch
        if st is not None:
            el = now - self.t_open
            if not st.running and not st.done and \
                    el >= max(2.0, self.seconds / 3):
                st.start()
                self._n_trace, self._t_trace = n_scans, time.perf_counter()
            elif st.running and now - self._t_trace >= TRACE_SECONDS:
                st.scans = n_scans - self._n_trace
                st.stop()
        if now - self.t_open >= self.seconds:
            if st is not None and st.running:
                st.scans = n_scans - self._n_trace
                st.stop()
            self.sync()
            self.t_close = time.perf_counter()
            self.n_close = n_scans
            self.phase = "done"
            self.spans.counting = False
            return True
        return False


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, hooks=None) -> Record:
    """One run; ``device``: a torch device (the card, or the CPU in the
    tests); ``hooks(slam)`` may wrap the system before set-up (the tests'
    faults)."""
    import torch

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    spans = Spans()
    sensor = make_sensor(config["sensor"], traffic, seed)
    prefetch = Prefetch(config["sensor"], traffic, seed)
    rec = Record(sensor=sensor, dlio=config["dlio"])
    try:
        slam = build_system(config, device)
        if hooks is not None:
            hooks(slam)
        slam.warmup()
        win = Window(seconds, float(traffic["setup_data_s"]), trace, spans,
                     sync)
        if win.stretch is not None:
            win.stretch.warm()
        base: dict = {}
        win.opened.append(lambda: base.update(_counters(slam)))
        if traffic["mode"] == "replay":
            _replay(slam, sensor, prefetch, traffic, win, spans, rec)
        elif traffic["mode"] == "live":
            _live(slam, sensor, prefetch, win, spans, rec)
        else:
            raise ValueError(f"traffic mode {traffic['mode']!r}")
        rec.setup_s = win.t_open - t_start
        rec.window_s = win.t_close - win.t_open
        rec.scans = win.n_close - win.n_open
        if win.stretch is not None and win.stretch.done:
            rec.trace = win.stretch.result()
        rec.spans = dict(spans.totals)
        if on_card:
            rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        # after the window: drain the pipelined sync (replay: the CLI's
        # closure cadence syncs; live never syncs), read the outputs
        if traffic["mode"] == "replay":
            slam.sync_graph()
        now = _counters(slam)
        rec.counters = {k: now[k] - base[k] for k in now}
        rec.lost_keyframes = rec.counters["lost_keyframes"]
        rec.traj = slam.flush()
        rec.payload = spec.map_module(config["dlio"]["map_backend"]) \
            .capture(slam, traffic["checks"])
        rec.extra["loop_closures_total"] = slam.loop_closures
        rec.extra["submap_overflow_total"] = slam.odometry.submap_overflow
        del slam
    finally:
        prefetch.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rec.ref_device = torch.device(device)
    return rec


def _replay(slam, sensor, prefetch, traffic, win, spans, rec):
    from noetic_slam_tpu_torch.io.replay import replay_dataset

    ds = SyntheticDataset(sensor, prefetch.get, spans)
    timed = _Timed(slam, spans)

    def on_batch(n):
        with spans("close_loop", sync=win.stretch is not None):
            slam.maybe_close_loop()
        if win.step(timed.last_stamp, n):
            ds.stop()

    replay_dataset(ds, timed, rate=0.0, batch=int(traffic["batch"]),
                   on_batch=on_batch)
    # scans are handed over in index order from the first, so the window's
    # are the indices [n_open, n_close)
    rec.first_scan, rec.end_scan = win.n_open, win.n_close
    rec.scans_by_index = ds.scans
    rec.gen_ms_per_scan = 1e3 * ds.gen_seconds / max(ds.gen_scans, 1)


def _live(slam, sensor, prefetch, win, spans, rec):
    import torch

    scans = {}
    j = 0                                   # next IMU sample
    gen_s = 0.0

    def push_until(t):
        nonlocal j
        t_imu, g, a = sensor.imu(j, j + 64)
        while t_imu[0] <= t:
            k = int(np.searchsorted(t_imu, t, side="right"))
            for m in range(k):
                slam.push_imu(float(t_imu[m]), g[m], a[m])
            j += k
            if k < len(t_imu):
                break
            t_imu, g, a = sensor.imu(j, j + 64)

    with spans("imu_push"):
        push_until(-1e-9)                   # the static calibration
    i = 0
    while True:
        t0 = time.perf_counter()
        with spans("generate"):
            header, xyz, pt = prefetch.get(i)
        gen_s += time.perf_counter() - t0
        scans[i] = (header, xyz, pt)
        sweep_end = header + (float(pt.max()) if pt is not None else 0.0)
        with spans("imu_push"):
            push_until(sweep_end + 0.02)
        t_hand = time.perf_counter()
        out = slam.process_scan(header, xyz, pt)
        with spans("pose_read"):
            torch.cat([out.pose_q, out.pose_p]).cpu()
        lat = time.perf_counter() - t_hand
        if win.phase == "window":
            rec.latencies.append(lat)
        i += 1
        if win.step(header, i):
            break
    rec.first_scan, rec.end_scan = win.n_open, win.n_close
    rec.scans_by_index = scans
    rec.gen_ms_per_scan = 1e3 * gen_s / max(i, 1)
