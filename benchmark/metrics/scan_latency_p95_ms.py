"""95th percentile, over every scan of the window, of the time from the
scan's hand-off to ``process_scan`` until its pose is read on the host."""

from benchmark.harness.stats import p95


def read(rec):
    return 1e3 * p95(rec.latencies) if rec.latencies else None
