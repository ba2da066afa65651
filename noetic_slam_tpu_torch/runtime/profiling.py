"""Host-side stage timing (the port's own copy of
``noetic_slam_tpu.runtime.profiling.StageTimer``, held to the original by
``tests/test_torch_copies.py``). The JAX module's ``slope_timer``,
``device_trace`` and roofline helpers are not ported: CUDA events and
``torch.profiler`` take their place (ROADMAP item 15)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

__all__ = ["StageTimer"]


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
