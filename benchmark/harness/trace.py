"""A device trace over a steady stretch of the window, and its reduction.

``Stretch`` runs ``torch.profiler`` (CPU and CUDA activity) from
``start()`` to ``stop()``; the stretch is the harness's ``trace_stretch``
range. ``reduce_events`` turns the profiler's events into:

- ``window_s``: the stretch's wall seconds;
- ``busy_s``: the union of the device's kernel, copy and set intervals
  inside it;
- ``kernels``: device seconds by operation name;
- ``gaps``: idle seconds inside the stretch by what the host was doing,
  the nest of the harness's spans and the program's ``record_function``
  ranges open on the host at each gap's middle ("replay_batch>
  odometry.gicp").

Nothing is written to disk.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.spans import NAMES as HARNESS_SPANS

PROGRAM_PREFIXES = ("odometry.", "tsdf.", "occupancy.")


def _is_label(name: str) -> bool:
    return name in HARNESS_SPANS or name.startswith(PROGRAM_PREFIXES)


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class Stretch:
    """``warm()`` in set-up (the tracer's first start loads it), ``start()``
    and ``stop()`` inside the window, ``result()`` after it."""

    def __init__(self, spans):
        self._spans = spans
        self._prof = None
        self._ctx = None
        self.scans = 0
        self.done = False

    def warm(self) -> None:
        import torch

        with _profile():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        self._prof = _profile()
        self._prof.start()
        self._ctx = self._spans("trace_stretch")
        self._ctx.__enter__()

    @property
    def running(self) -> bool:
        return self._ctx is not None

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._ctx.__exit__(None, None, None)
        self._ctx = None
        self._prof.stop()
        self.done = True

    def result(self) -> dict:
        out = reduce_events(self._prof.profiler.kineto_results.events())
        out["scans"] = self.scans
        self._prof = None
        return out


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of intervals (n, 2), sorted and disjoint."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > ends[:-1]]
    starts = iv[new, 0]
    last = np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]
    return np.stack([starts, ends[last]], axis=1)


def _label_segments(spans):
    """Host spans (start, end, name) -> sorted boundaries and, for each
    segment between them, the nest of spans open there."""
    ev = []
    for s, e, n in spans:
        ev.append((s, 1, n))
        ev.append((e, 0, n))
    ev.sort(key=lambda x: (x[0], x[1]))
    bounds, labels, stack = [], [], []
    for t, kind, n in ev:
        bounds.append(t)
        if kind:
            stack.append(n)
        elif n in stack:
            stack.reverse()
            stack.remove(n)
            stack.reverse()
        labels.append(">".join(s for s in stack if s != "trace_stretch")
                      or "other")
    return np.asarray(bounds, np.int64), labels


def _call(e, method, default):
    """``e.method()``, or ``default`` where this torch's events lack it."""
    f = getattr(e, method, None)
    return f() if f is not None else default


def _interval(e):
    s = e.start_ns()
    return s, s + e.duration_ns()


def reduce_events(events) -> dict:
    """The stretch's numbers from the profiler's events."""
    dev, host, window = [], [], None
    annotations = set()
    kinds: dict = {}
    for e in events:
        name = e.name()
        user = _call(e, "is_user_annotation", False)
        if str(e.device_type()).endswith("CPU"):
            if name == "trace_stretch":
                window = _interval(e)
            elif _is_label(name):
                host.append((*_interval(e), name))
            if user:
                annotations.add(name)
        else:
            kind = str(_call(e, "activity_type", ""))
            kinds[kind] = kinds.get(kind, 0) + 1
            if user or "annotation" in kind or _is_label(name):
                continue
            dev.append((*_interval(e), name))
    dev = [d for d in dev if d[2] not in annotations]
    if window is None or not dev:
        return {"window_s": None, "busy_s": None, "kernels": {}, "gaps": {},
                "activity_kinds": kinds}
    w0, w1 = window
    iv = np.array([(max(s, w0), min(e, w1)) for s, e, _ in dev], np.int64)
    iv = iv[iv[:, 1] > iv[:, 0]]
    busy = _merge(iv)
    kernels: dict = {}
    for s, e, n in dev:
        d = min(e, w1) - max(s, w0)
        if d > 0:
            kernels[n] = kernels.get(n, 0.0) + d * 1e-9
    # idle gaps inside the window, labelled by the host's open spans
    edges = np.r_[w0, busy.ravel(), w1].reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    bounds, labels = _label_segments(host)
    by_label: dict = {}
    if len(gaps):
        mid = (gaps[:, 0] + gaps[:, 1]) // 2
        k = np.searchsorted(bounds, mid, side="right") - 1
        for (g0, g1), j in zip(gaps, k):
            lab = labels[j] if j >= 0 else "other"
            by_label[lab] = by_label.get(lab, 0.0) + (g1 - g0) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": float(np.sum(busy[:, 1] - busy[:, 0])) * 1e-9,
            "kernels": kernels, "gaps": by_label, "activity_kinds": kinds}


def breakdown(tr: dict, k: int = 10) -> dict:
    """The ``breakdown`` of a traced result: the device operations that
    took most time and the idle time by what the host was doing."""
    def top(d):
        return [[n[:120], v] for n, v in
                sorted(d.items(), key=lambda x: -x[1])[:k]]
    return {"device_ops": top(tr["kernels"]), "idle_gaps": top(tr["gaps"])}
