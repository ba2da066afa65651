"""Profiling and measurement helpers (port of
``noetic_slam_tpu.runtime.profiling``, same names and signatures).

- ``slope_timer``: per-op seconds from the slope between a short and a
  long window of chained ops, each window ending in a dependent fetch
  (on the card, a host read such as ``float(torch.sum(...))`` or a
  ``torch.cuda.synchronize()``), so that the fixed fetch overhead
  cancels.
- ``device_trace``: a context manager around ``torch.profiler`` with CUDA
  activity; writes a trace that TensorBoard (torch-tb-profiler) or
  Chrome's trace viewer loads, and yields whether the profiler started.
- ``StageTimer``: named-stage wall aggregation for host-side pipelines
  (the port's own copy of the JAX class, held to the original by
  ``tests/test_torch_copies.py``).
- ``span`` / ``RECORDER``: the port's own spans (``SpanRecorder``): the
  scan's root, the step's stages, GICP's iterations, host reads, set-up
  and the closure path. Off by default, where a span costs a flag check
  (and is a ``record_function`` range while a torch profiler runs).
- ``chip_peaks`` / ``roofline_report``: the card's published peaks and
  one line of achieved rates against them. The port's kernels run in f32
  (TF32 is off package-wide), so the operations are measured against the
  f32 CUDA-core peak, not the bf16 tensor-core one.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import socket
import threading
import time
from time import time_ns as _now
from typing import Callable, Dict, NamedTuple

from torch.autograd import profiler as _autograd_profiler

__all__ = ["slope_timer", "device_trace", "StageTimer", "SpanRecord",
           "SpanRecorder", "RECORDER", "span", "CHIP_PEAKS", "chip_peaks",
           "roofline_report"]


def slope_timer(run_window: Callable[[int], None], *, n1: int = 3,
                n2: int = 9, warmup: int = 1) -> float:
    """Measure true per-op seconds of ``run_window(k)`` (which must execute
    ``k`` chained fresh-data ops and end with a dependent fetch: on the
    card the launches return before the work is done, so a window without
    one times the enqueue).

    Returns seconds/op = (t(n2) - t(n1)) / (n2 - n1); the warm-up window
    takes the first call's costs (the kernels' build, allocator growth),
    and the fixed fetch overhead cancels in the difference.
    """
    if n2 <= n1:
        raise ValueError("n2 must exceed n1")
    run_window(warmup)
    t0 = time.perf_counter()
    run_window(n1)
    t1 = time.perf_counter()
    run_window(n2)
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (n2 - n1)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``with device_trace("trace_dir") as started:`` — runs the body under
    ``torch.profiler`` (CPU activity, and CUDA activity where there is a
    card) and writes its trace into ``logdir``. Yields whether the
    profiler started; the body runs either way (a profiler that cannot
    start, e.g. because another one is running in this process, is the
    one failure tolerated, as in the JAX version)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    started = False
    # a second session does not raise on start but corrupts the first
    if not torch.autograd.profiler._is_profiler_enabled:
        try:
            prof.start()
            started = True
        except RuntimeError:
            pass
    try:
        yield started
    finally:
        if started:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            # TensorBoard's torch profiler plugin reads *.pt.trace.json
            prof.export_chrome_trace(os.path.join(
                logdir, f"{socket.gethostname()}_{os.getpid()}"
                f".{time.time_ns()}.pt.trace.json"))


class StageTimer:
    """Accumulate named host-side stage durations; render as a table.

    >>> st = StageTimer()
    >>> with st("parse"):
    ...     ...
    >>> print(st.table())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean_ms(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1) * 1e3

    def snapshot(self) -> dict:
        """Copy of the cumulative totals/counts — callers diff successive
        snapshots for per-window stage attribution (soak artifact)."""
        return {"totals": dict(self.totals), "counts": dict(self.counts)}

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """Stage table covering the interval between two snapshots."""
        out = {}
        for k, v in after["totals"].items():
            dv = v - before["totals"].get(k, 0.0)
            dc = after["counts"][k] - before["counts"].get(k, 0)
            if dc or dv > 1e-9:
                out[k] = {"calls": dc, "total_s": round(dv, 3)}
        return out

    def table(self) -> str:
        rows = ["stage                     calls   total_s   mean_ms"]
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            rows.append(f"{k:<25} {self.counts[k]:>5} "
                        f"{self.totals[k]:>9.3f} {self.mean_ms(k):>9.2f}")
        return "\n".join(rows)


class SpanRecord(NamedTuple):
    """One closed span. Times are ``time.time_ns()``, the clock of the
    torch profiler's CPU events."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int      # id of the span it opened in, -1 at the top
    scan: int        # the pipeline's index of its scan, -1 outside one


class _Span:
    __slots__ = ("_rec", "name", "scan", "id", "parent", "child_ns", "_t0",
                 "_range")

    def __init__(self, rec: "SpanRecorder", name: str, scan):
        self._rec, self.name, self.scan = rec, name, scan

    def __enter__(self):
        stack = self._rec._stack()
        top = stack[-1] if stack else None
        if self.scan is None:
            self.scan = top.scan if top is not None else -1
        self.parent = top.id if top is not None else -1
        self.id = next(self._rec._ids)
        self.child_ns = 0
        self._t0 = _now()
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        t1 = _now()
        stack = self._rec._stack()
        stack.pop()
        if exc[0] is not None:       # work not done: no record
            return False
        dur = t1 - self._t0
        if stack:
            stack[-1].child_ns += dur
        self._rec._add(SpanRecord(self.name, self._t0, t1, self.id,
                                  self.parent, self.scan),
                       dur, dur - self.child_ns)
        return False


_OFF = contextlib.nullcontext()


class SpanRecorder:
    """Named host spans, one process-wide recorder (``RECORDER``).

    ``span(name, scan=None)`` is a context manager. Off (the default) it
    is a flag check, and a ``torch.profiler.record_function`` range of
    the same name while a torch profiler runs, so that a device trace can
    say what the host was doing. On (``enable()``) it also keeps a
    ``SpanRecord``: name, start and end on the profiler's clock, the span
    it opened in (a stack per thread) and its scan, which the root span
    sets (``scan=``) and every nested span inherits. A span left by an
    exception keeps no record (a scan that ``NeedMoreImu`` holds back is
    recorded once, when it is taken); its time counts to the span it
    opened in. Records go into a ring of ``capacity``; totals, self times
    (a span's time less its children's) and counts by name are kept for
    the whole recording."""

    def __init__(self, capacity: int = 1 << 17):
        self.on = False
        self.capacity = capacity
        self._local = threading.local()
        self._lock = threading.Lock()
        self._reset()

    def _reset(self) -> None:
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._ids = itertools.count()
        self.totals: Dict[str, int] = {}        # ns
        self.self_totals: Dict[str, int] = {}   # ns
        self.counts: Dict[str, int] = {}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, r: SpanRecord, dur: int, own: int) -> None:
        with self._lock:
            self._ring.append(r)
            self.totals[r.name] = self.totals.get(r.name, 0) + dur
            self.self_totals[r.name] = self.self_totals.get(r.name, 0) + own
            self.counts[r.name] = self.counts.get(r.name, 0) + 1

    def span(self, name: str, scan: int | None = None):
        """``with span("odometry.gicp"):`` — see the class."""
        if self.on:
            return _Span(self, name, scan)
        if _autograd_profiler._is_profiler_enabled:
            return _autograd_profiler.record_function(name)
        return _OFF

    def enable(self) -> None:
        """Start a fresh recording (earlier records and totals dropped)."""
        with self._lock:
            self._reset()
            self.on = True

    def disable(self) -> None:
        """Stop recording; what was recorded stays readable."""
        self.on = False

    def records(self) -> list:
        """The newest ``capacity`` records, in the order they closed."""
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> dict:
        """Cumulative seconds and counts by name in ``StageTimer``'s
        format, for ``delta``."""
        with self._lock:
            return {"totals": {k: v * 1e-9 for k, v in self.totals.items()},
                    "counts": dict(self.counts)}

    delta = staticmethod(StageTimer.delta)

    def stage_table(self) -> dict:
        """name -> calls, total and self seconds over the recording."""
        with self._lock:
            return {k: {"calls": self.counts[k],
                        "total_s": self.totals[k] * 1e-9,
                        "self_s": self.self_totals[k] * 1e-9}
                    for k in self.counts}

    def table(self) -> str:
        rows = ["stage                          calls   total_s    self_s"
                "   mean_ms"]
        tab = self.stage_table()
        for k in sorted(tab, key=lambda k: -tab[k]["self_s"]):
            t = tab[k]
            rows.append(f"{k:<30} {t['calls']:>5} {t['total_s']:>9.3f} "
                        f"{t['self_s']:>9.3f} "
                        f"{1e3 * t['total_s'] / t['calls']:>9.2f}")
        return "\n".join(rows)


RECORDER = SpanRecorder()
span = RECORDER.span


# ---------------------------------------------------------------------------
# Roofline accounting
# ---------------------------------------------------------------------------

# torch.cuda.get_device_name() prefix -> (bf16 dense tensor-core TFLOP/s,
# HBM GB/s, f32 CUDA-core TFLOP/s) per card: NVIDIA's H100 data sheet,
# dense rates at the full power limit. First prefix match wins.
CHIP_PEAKS = (
    ("NVIDIA H100 PCIe", (756.0, 2000.0, 51.0)),
    ("NVIDIA H100 80GB HBM3", (989.0, 3350.0, 67.0)),     # SXM5
)


def chip_peaks():
    """((bf16_tflops, hbm_gbps, f32_tflops), name) for the attached card;
    (None, name) for a card without an entry, (None, "cpu") without one."""
    import torch

    if not torch.cuda.is_available():
        return None, "cpu"
    kind = torch.cuda.get_device_name()
    for prefix, peaks in CHIP_PEAKS:
        if kind.startswith(prefix):
            return peaks, kind
    return None, kind


def roofline_report(name: str, seconds: float, flops: float | None = None,
                    bytes_moved: float | None = None) -> str:
    """One line of absolute utilization: achieved GFLOP/s / GB/s and the
    percent of the card's f32 CUDA-core / HBM peak.

    ``flops``/``bytes_moved`` are per call; the caller states the counting
    basis (e.g. dense-equivalent FLOPs for a pruned kernel) at the call
    site."""
    peaks, kind = chip_peaks()
    parts = [f"{name:<34}"]
    if flops is not None:
        gf = flops / seconds / 1e9
        parts.append(f"{gf:10.1f} GFLOP/s")
        if peaks:
            parts.append(f"({gf / (peaks[2] * 1e3) * 100:5.1f}% of "
                         f"{peaks[2]:.0f}T f32 CUDA cores)")
    if bytes_moved is not None:
        gb = bytes_moved / seconds / 1e9
        parts.append(f"{gb:8.1f} GB/s")
        if peaks:
            parts.append(f"({gb / peaks[1] * 100:5.1f}% of "
                         f"{peaks[1]:.0f}GB/s HBM)")
    if not peaks:
        parts.append(f"[no peak table for {kind}]")
    return " ".join(parts)
