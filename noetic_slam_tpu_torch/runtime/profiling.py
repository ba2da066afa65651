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
- ``chip_peaks`` / ``roofline_report``: the card's published peaks and
  one line of achieved rates against them. The port's kernels run in f32
  (TF32 is off package-wide), so the operations are measured against the
  f32 CUDA-core peak, not the bf16 tensor-core one.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Callable, Dict

__all__ = ["slope_timer", "device_trace", "StageTimer", "CHIP_PEAKS",
           "chip_peaks", "roofline_report"]


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
