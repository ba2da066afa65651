"""Scans per second: every scan ``replay_dataset`` handed over in the
window, over the window's wall seconds."""

from benchmark.harness.stats import window_rate


def read(rec):
    return window_rate(rec.scans, rec.window_s) if rec.scans else None
