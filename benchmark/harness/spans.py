"""The harness's own spans around its calls into the program: host
seconds summed by name while counting is on, and a ``record_function``
range of the same name, so that a device trace can say what the host was
doing in each idle gap."""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

NAMES = ("replay_batch", "close_loop", "generate", "pose_read", "imu_push",
         "trace_stretch")


class Spans:
    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}
        self.counting = False

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        """``sync``: end the span with ``torch.cuda.synchronize()``, so
        that it holds the device work it queued."""
        t0 = time.perf_counter()
        with record_function(name):
            yield
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
        if self.counting:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)
            self.counts[name] = self.counts.get(name, 0) + 1
