"""The statistics of the end-to-end metrics."""

from __future__ import annotations

import math


def window_rate(count: int, seconds: float) -> float:
    """Work over the whole window: every item handed over, over the
    window's wall seconds. No slopes and no medians of chunks, so a stall
    anywhere in the window counts in full."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return count / seconds


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of all values at or below it, over every value given."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]

