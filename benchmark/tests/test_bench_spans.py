"""``harness.program_spans.window_summary``: the program's spans of a
window reduced to iterations, host time and reads a scan (CPU): nothing
on records without the program's root span, the numbers of hand-built
records, a tiny run of the live cell whose span counts equal the
program's own counters, and ``run_spans`` without a card."""

import json
import os
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from benchmark import run, run_spans  # noqa: E402
from benchmark.harness import runner  # noqa: E402
from benchmark.harness.program_spans import window_summary  # noqa: E402
from benchmark.tests.test_bench_faults import LIVE, tiny  # noqa: E402
from noetic_slam_tpu_torch.runtime.profiling import (  # noqa: E402
    RECORDER,
    SpanRecord,
)

MS = 1_000_000


def _scan(first_id, scan, t0, iters):
    """A scan's records: the step's own 3 ms read, GICP from 10 ms on with
    ``iters`` iterations of 11 ms (correspond 2, LM 8, a 1 ms read), and
    20 ms more after it under the root."""
    i = iter(range(first_id, first_id + 100))
    root, gicp = next(i), next(i)
    out = []
    t = t0 + 5 * MS
    out.append(SpanRecord("odometry.host_read", t, t + 3 * MS, next(i),
                          root, scan))
    t = t0 + 10 * MS
    for _ in range(iters):
        out.append(SpanRecord("odometry.gicp.correspond", t, t + 2 * MS,
                              next(i), gicp, scan))
        out.append(SpanRecord("odometry.gicp.lm", t + 2 * MS, t + 10 * MS,
                              next(i), gicp, scan))
        out.append(SpanRecord("odometry.host_read", t + 10 * MS,
                              t + 11 * MS, next(i), gicp, scan))
        t += 11 * MS
    out.append(SpanRecord("odometry.gicp", t0 + 10 * MS, t, gicp, root,
                          scan))
    out.append(SpanRecord("pipeline.scan", t0, t + 20 * MS, root, -1, scan))
    return out


def test_nothing_without_the_programs_spans():
    assert window_summary([], 0, 10) is None
    other = [SpanRecord("odometry.gicp", 0, 5, 0, -1, -1)]
    assert window_summary(other, 0, 10) is None


def test_numbers_of_hand_built_records():
    records = [SpanRecord("setup.warmup", 0, 4_000 * MS, 0, -1, -1)]
    t = 5_000 * MS
    for scan, iters in enumerate([2, 3, 9, 2]):
        records += _scan(1000 * (scan + 1), scan, t, iters)
        t += 200 * MS
    # scan 0 is set-up, scans 1-2 the window, scan 3 after it
    s = window_summary(records, 1, 3)
    assert s["scans"] == 2
    assert s["gicp_iterations_per_scan"] == pytest.approx(6.0)
    assert s["gicp_host_ms_per_iteration"] == pytest.approx(11.0)
    assert s["host_read_wait_ms_per_scan"] == pytest.approx(3 + 6)
    assert s["warmup_s"] == pytest.approx(4.0)
    assert s["kernels_load_s"] is None
    assert s["span_counts"] == {"odometry.gicp.correspond": 12,
                                "odometry.host_read": 14,
                                "odometry.submap_gather": 0}
    tab = s["self_ms_per_scan"]
    assert tab["all"]["self_ms"]["odometry.gicp>odometry.gicp.lm"] == \
        pytest.approx(8 * 6)
    assert tab["all"]["self_ms"]["odometry.host_read"] == pytest.approx(3)
    assert tab["all"]["self_ms"]["odometry.gicp>odometry.host_read"] == \
        pytest.approx(6)
    assert tab["all"]["self_ms"]["odometry.gicp"] == pytest.approx(0)
    assert tab["all"]["self_ms"]["pipeline.scan"] == pytest.approx(27)
    slow = tab["slowest_5pct"]
    assert slow["scans"] == 1
    assert slow["counts"]["odometry.gicp.correspond"] == 9
    assert slow["self_ms"]["odometry.gicp>odometry.gicp.lm"] == \
        pytest.approx(72)
    assert s["root_ms"]["max"] == pytest.approx(30 + 99)


def test_tiny_live_run_counts_agree(monkeypatch, capsys):
    """``run_spans`` around a tiny run of the live cell (``run.main`` in
    its place runs the harness on the CPU): the window's ``correspond``
    spans equal its scans' GICP iterations in the trajectory, its
    ``host_read`` spans the change of the system's ``host_syncs``."""
    torch.set_num_threads(2)
    cell, cfg = tiny(LIVE)
    ran = {}

    def main(argv):
        ran["rec"] = runner.run(cfg, cell.traffic, 2 ** 31 + 21, 3.0, False,
                                torch.device("cpu"), time.perf_counter())
        ran["on_after"] = RECORDER.on
        return 0

    inner = runner.run
    monkeypatch.setattr(run, "main", main)
    assert run_spans.main([]) == 0
    assert runner.run is inner and not RECORDER.on and not ran["on_after"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    s, c, rec = line["spans"], line["counts"], ran["rec"]
    assert s["scans"] == rec.scans == rec.end_scan - rec.first_scan > 0
    assert c["trajectory_gicp_iterations"] is not None
    assert c["correspond_spans"] == c["trajectory_gicp_iterations"] == \
        s["span_counts"]["odometry.gicp.correspond"]
    assert c["host_read_spans"] == c["host_syncs"] == \
        rec.counters["host_syncs"]
    assert s["warmup_s"] > 0
    assert s["gicp_iterations_per_scan"] >= 1


def test_run_spans_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inner = runner.run
    with pytest.raises(SystemExit) as e:
        run_spans.main(["--workload", LIVE, "--seed", str(2 ** 31 + 3),
                        "--seconds", "1", "--trace", "1"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""
    assert runner.run is inner and not RECORDER.on
