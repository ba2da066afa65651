"""The program's spans of a window (``runtime.profiling.RECORDER``'s
records), reduced to what each scan of the window spent.

``window_summary(records, first, end)`` takes the scans ``first`` to
``end - 1`` (``Record.first_scan`` to ``end_scan``): those whose
``pipeline.scan`` root span is among the records. Each span carries the
pipeline's index of its scan. Returns None where no such root is there,
as on a program without the recorder's spans. Otherwise:

- ``gicp_iterations_per_scan``: ``odometry.gicp.correspond`` spans (one
  an outer GICP iteration) of the window's scans, over those scans;
- ``gicp_host_ms_per_iteration``: the ``odometry.gicp`` spans' host time
  over those iterations;
- ``host_read_wait_ms_per_scan``: the ``odometry.host_read`` spans' time
  (the host blocked on the device) a scan;
- ``warmup_s``, ``kernels_load_s``: the ``setup.*`` spans;
- ``root_ms``: the ``pipeline.scan`` spans' median, p95 (nearest rank)
  and largest time;
- ``self_ms_per_scan``: host self time a scan by nest of spans below the
  scan's root (``odometry.gicp>odometry.gicp.lm``), over every scan of the
  window, its median scans (45th-55th percentile of the root span's
  time) and its slowest 5%, with the counts a scan of the spans in
  ``COUNTED``;
- ``span_counts``: those spans over the window's scans.
"""

from __future__ import annotations

import math

import numpy as np

ROOT = "pipeline.scan"
COUNTED = ("odometry.gicp.correspond", "odometry.host_read",
           "odometry.submap_gather")


def self_ns(records) -> dict:
    """id -> a span's time less the time of the spans opened in it."""
    child: dict = {}
    for r in records:
        child[r.parent] = child.get(r.parent, 0) + r.end_ns - r.start_ns
    return {r.id: r.end_ns - r.start_ns - child.get(r.id, 0)
            for r in records}


def _paths(records) -> dict:
    """id -> the names from below the scan's root down to the span, joined
    by ``>`` (the scan's root itself: ``pipeline.scan``)."""
    by_id = {r.id: r for r in records}
    out = {}
    for r in records:
        names, p = [], r
        while p is not None and p.name != ROOT:
            names.append(p.name)
            p = by_id.get(p.parent)
        out[r.id] = ">".join(reversed(names)) or ROOT
    return out


def _group(scans: list, per_scan: dict, counts: dict) -> dict:
    n = max(len(scans), 1)
    table: dict = {}
    for s in scans:
        for k, v in per_scan[s].items():
            table[k] = table.get(k, 0.0) + v / n
    return {"scans": len(scans),
            "self_ms": {k: round(v, 4) for k, v in
                        sorted(table.items(), key=lambda kv: -kv[1])},
            "counts": {k: round(sum(c[s] for s in scans) / n, 3)
                       for k, c in counts.items()}}


def window_summary(records, first: int, end: int) -> dict | None:
    """See the module."""
    roots = {r.scan: r for r in records
             if r.name == ROOT and first <= r.scan < end}
    if not roots:
        return None
    mine = [r for r in records if r.scan in roots]
    own, path = self_ns(mine), _paths(mine)
    n = len(roots)

    def total_ms(name):
        return 1e-6 * sum(r.end_ns - r.start_ns for r in mine
                          if r.name == name)

    per_scan = {s: {} for s in roots}
    counts = {k: {s: 0 for s in roots} for k in COUNTED}
    for r in mine:
        d = per_scan[r.scan]
        d[path[r.id]] = d.get(path[r.id], 0.0) + 1e-6 * own[r.id]
        if r.name in counts:
            counts[r.name][r.scan] += 1
    iters = sum(counts["odometry.gicp.correspond"].values())
    by_time = sorted(roots, key=lambda s: roots[s].end_ns
                     - roots[s].start_ns)
    lo, hi = int(0.45 * n), max(int(0.55 * n), int(0.45 * n) + 1)
    slow = by_time[n - max(n // 20, 1):]

    def setup_s(name):
        d = [r.end_ns - r.start_ns for r in records if r.name == name]
        return 1e-9 * d[0] if d else None

    root_ms = np.array([1e-6 * (roots[s].end_ns - roots[s].start_ns)
                        for s in by_time])
    return {
        "scans": n,
        "gicp_iterations_per_scan": iters / n,
        "gicp_host_ms_per_iteration": (total_ms("odometry.gicp") / iters
                                       if iters else None),
        "host_read_wait_ms_per_scan": total_ms("odometry.host_read") / n,
        "warmup_s": setup_s("setup.warmup"),
        "kernels_load_s": setup_s("setup.kernels_load"),
        "root_ms": {"median": float(np.median(root_ms)),
                    "p95": float(root_ms[max(math.ceil(0.95 * n) - 1, 0)]),
                    "max": float(root_ms[-1])},
        "self_ms_per_scan": {
            "all": _group(by_time, per_scan, counts),
            "median": _group(by_time[lo:hi], per_scan, counts),
            "slowest_5pct": _group(slow, per_scan, counts)},
        "span_counts": {k: sum(c.values()) for k, c in counts.items()},
    }
