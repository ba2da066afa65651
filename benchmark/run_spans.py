"""``benchmark/run.py`` with the program's span recorder on, for the
breakdown by scan that the benchmark's line does not carry.

    python3 benchmark/run_spans.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Takes ``run.py``'s arguments and runs ``run.main`` itself, so that the
set-up, window, traced stretch, comparison (``correct``) and JAX check
are run.py's, and its line is printed as run.py prints it. Around the
harness's ``runner.run`` the port's ``runtime.profiling.RECORDER`` is
enabled, before the system is built, so that set-up is recorded too. Then
one more JSON line, last: ``spans``, ``harness.program_spans.
window_summary`` of the window's scans, and ``counts``, the spans against
the program's own counters over the window: ``correspond`` spans against
the trajectory's ``gicp_iterations``, ``host_read`` spans against
``host_syncs``. The same run with the recorder off is ``run.py``'s own on
the same seed. Exits as ``run.main`` does (2 without a card); prints no
second line unless it returned 0.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run  # noqa: E402  (run.T_START: process start)


def main(argv=None) -> int:
    from benchmark.harness import runner
    from benchmark.harness.program_spans import window_summary

    inner, seen = runner.run, {}

    def recorded(*args, **kwargs):
        from noetic_slam_tpu_torch.runtime.profiling import RECORDER

        kept = []
        RECORDER.enable()
        try:
            rec = inner(*args, hooks=kept.append, **kwargs)
        finally:
            RECORDER.disable()
        seen.update(rec=rec, slam=kept[0], records=RECORDER.records())
        return rec

    runner.run = recorded
    try:
        rc = run.main(argv)
    finally:
        runner.run = inner
    if rc != 0:
        return rc
    rec, slam = seen["rec"], seen["slam"]
    summary = window_summary(seen["records"], rec.first_scan, rec.end_scan)
    counts = None
    if summary is not None:
        traj = slam.odometry.trajectory
        counts = {
            "correspond_spans":
                summary["span_counts"]["odometry.gicp.correspond"],
            "trajectory_gicp_iterations": (
                sum(e.gicp_iterations for e in
                    traj[rec.first_scan:rec.end_scan])
                if len(traj) == len(slam.odometry.headers) else None),
            "host_read_spans": summary["span_counts"]["odometry.host_read"],
            "host_syncs": rec.counters.get("host_syncs")}
    print(json.dumps({"spans": summary, "counts": counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
