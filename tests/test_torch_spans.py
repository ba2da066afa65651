"""The port's span recorder (``runtime.profiling.SpanRecorder``, ``span``)
and the spans it records on the live path, on the CPU: nesting, parents,
the scan index, self time and the ring's bound; nothing recorded and no
profiler range entered while off; the torch profiler's clock; and a small
``SlamSystem`` run whose results the recorder leaves bitwise unchanged and
whose span counts equal the pipeline's own counters."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from noetic_slam_tpu_torch.config import (
    CapacityConfig,
    DlioConfig,
    KeyframeConfig,
    TsdfConfig,
)
from noetic_slam_tpu_torch.models import posegraph as pg
from noetic_slam_tpu_torch.ops.cuda import _build
from noetic_slam_tpu_torch.runtime import profiling
from noetic_slam_tpu_torch.runtime.pipeline import (
    NeedMoreImu,
    OdometryPipeline,
)
from noetic_slam_tpu_torch.runtime.profiling import (
    RECORDER,
    SpanRecorder,
)
from noetic_slam_tpu_torch.runtime.slam import SlamSystem
from noetic_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)
CPU = "cpu"


@pytest.fixture
def recording():
    """The process-wide recorder, on for the test and off after it."""
    RECORDER.enable()
    try:
        yield RECORDER
    finally:
        RECORDER.disable()


def test_nesting_parent_scan_self_time_and_ring(monkeypatch):
    ticks = iter(range(0, 10**6, 10))
    monkeypatch.setattr(profiling, "_now", lambda: next(ticks))
    rec = SpanRecorder(capacity=4)
    rec.enable()
    with rec.span("root", scan=7):            # 0 .. 70
        with rec.span("a"):                   # 10 .. 40
            with rec.span("b"):               # 20 .. 30
                pass
        with rec.span("a"):                   # 50 .. 60
            pass
    with rec.span("top"):                     # 80 .. 90
        pass
    by = {}
    for r in rec.records():
        by.setdefault(r.name, []).append(r)
    # the ring keeps the newest 4 of 5 records, in the order they closed
    assert [r.name for r in rec.records()] == ["a", "a", "root", "top"]
    root, top = by["root"][0], by["top"][0]
    assert (root.start_ns, root.end_ns, root.parent, root.scan) == (0, 70,
                                                                    -1, 7)
    assert [(r.start_ns, r.end_ns) for r in by["a"]] == [(10, 40), (50, 60)]
    assert all(r.parent == root.id and r.scan == 7 for r in by["a"])
    assert (top.parent, top.scan) == (-1, -1)
    # totals, self times and counts cover every span, the dropped one too
    assert rec.totals == {"b": 10, "a": 40, "root": 70, "top": 10}
    assert rec.self_totals == {"b": 10, "a": 30, "root": 30, "top": 10}
    tab = rec.stage_table()
    assert {k: v["calls"] for k, v in tab.items()} == {
        "b": 1, "a": 2, "root": 1, "top": 1}
    assert tab["root"]["self_s"] == rec.self_totals["root"] * 1e-9
    snap = rec.snapshot()
    assert snap["counts"] == {"b": 1, "a": 2, "root": 1, "top": 1}
    with rec.span("a"):
        pass
    assert rec.delta(snap, rec.snapshot()) == {
        "a": {"calls": 1, "total_s": 0.0}}
    assert rec.table().splitlines()[1].split()[0] in ("a", "root")
    # a fresh recording starts empty
    rec.enable()
    assert rec.records() == [] and rec.stage_table() == {}


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        lambda name: entered.append(name))
    rec = SpanRecorder()
    assert not rec.on and not RECORDER.on
    for name in ("pipeline.scan", "odometry.gicp"):
        with rec.span(name, scan=3):
            pass
    rec.disable()
    assert rec.records() == [] and rec.stage_table() == {}
    assert entered == []


@pytest.mark.parametrize("on", [False, True])
def test_spans_are_profiler_ranges_on_its_clock(on):
    """Under torch.profiler each span is a range of its name; with the
    recorder on, its start and end are within 1 ms of the range's."""
    rec = SpanRecorder()
    if on:
        rec.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with rec.span("pipeline.scan", scan=i):
                with rec.span("odometry.gicp"):
                    torch.zeros(64).add_(1)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() in ("pipeline.scan", "odometry.gicp"))
    assert [n for *_, n in ranges].count("pipeline.scan") == 3
    assert [n for *_, n in ranges].count("odometry.gicp") == 3
    if not on:
        assert rec.records() == []
        return
    mine = sorted((r.start_ns, r.end_ns, r.name) for r in rec.records())
    assert [n for *_, n in mine] == [n for *_, n in ranges]
    for (s0, e0, _), (s1, e1, _) in zip(mine, ranges):
        assert abs(s0 - s1) < 1_000_000 and abs(e0 - e1) < 1_000_000


def _cfg():
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=16, max_submap_kf=4),
        keyframe=KeyframeConfig(thresh_dist=0.25, thresh_rot=45.0),
        adaptive=False,
        tsdf=TsdfConfig(voxel_size=0.2, truncation=0.6, max_blocks=4096,
                        space_carving=False))


def _sim():
    """The sequence and its scans (drawn once, in order)."""
    sim = synthetic.make_sim(duration=2.5, n_points=1024, calib_time=3.1,
                             seed=9)
    return sim, [sim.scan(s) for s in range(len(sim.scan_stamps))]


def _small_slam(sim, scans, recorder_on: bool):
    """A small ``SlamSystem`` run: ``warmup()``, then 25 scans one at a
    time, ``maybe_close_loop`` every sixth (whose verifications run GICP
    outside any scan). Returns the system and the odometry's host reads
    before the first scan."""
    if recorder_on:
        RECORDER.enable()
    try:
        slam = SlamSystem(_cfg(), device=CPU, loop_min_gap=5)
        slam.graph = pg.init_graph(8, 8, device=CPU)
        slam.warmup()
        syncs0 = slam.odometry.host_syncs
        imu_i = 0
        for s, (h, xyz, pt) in enumerate(scans):
            while (imu_i < len(sim.imu_stamps)
                   and sim.imu_stamps[imu_i] <= h + pt.max() + 0.02):
                slam.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                              sim.imu_acc[imu_i])
                imu_i += 1
            slam.process_scan(h, xyz, pt)
            if s % 6 == 5:
                slam.maybe_close_loop()
    finally:
        RECORDER.disable()
    return slam, syncs0


def _root_of(records):
    """id -> the record's ``pipeline.scan`` root (or None)."""
    by_id = {r.id: r for r in records}

    def root(r):
        while r is not None and r.name != "pipeline.scan":
            r = by_id.get(r.parent)
        return r
    return {r.id: root(r) for r in records}


def test_slam_run_bitwise_and_counts_agree():
    sim, scans = _sim()
    off, _ = _small_slam(sim, scans, False)
    on, syncs0 = _small_slam(sim, scans, True)
    records = RECORDER.records()
    np.testing.assert_array_equal(off.flush(), on.flush())
    for x, y, what in ((off.odometry.state, on.odometry.state, "state"),
                       (off.graph, on.graph, "graph"),
                       (off.tsdf, on.tsdf, "tsdf"),
                       (off.archive.volume, on.archive.volume, "archive")):
        for name in x._fields:
            assert torch.equal(getattr(x, name), getattr(y, name)), \
                f"{what}.{name}"

    n = len(on.odometry.headers)
    roots = [r for r in records if r.name == "pipeline.scan"]
    assert sorted(r.scan for r in roots) == list(range(n))
    assert all(r.parent == -1 for r in roots)
    root = _root_of(records)
    under = [r for r in records if root[r.id] is not None]
    assert all(r.scan == root[r.id].scan for r in under)
    names = {r.name for r in under}
    assert {"odometry.pack", "odometry.front", "odometry.intake_deskew",
            "odometry.gicp", "odometry.gicp.correspond",
            "odometry.gicp.linearize", "odometry.gicp.lm",
            "odometry.host_read", "odometry.keyframe_submap",
            "odometry.submap_gather", "tsdf.fuse"} <= names
    # the front's four spans nest in one odometry.front a scan, which
    # opens in the scan's root
    by_id = {r.id: r for r in records}
    nests = {f"{by_id[r.parent].name}>{r.name}" for r in under
             if r.parent in by_id}
    inner = ("odometry.intake_deskew", "odometry.voxel",
             "odometry.covariances", "odometry.propagate")
    assert ({"pipeline.scan>odometry.front"}
            | {f"odometry.front>{k}" for k in inner}) <= nests
    assert all(by_id[r.parent].name == "odometry.front" for r in under
               if r.name in inner)
    assert sum(r.name == "odometry.front" for r in under) == n
    # one correspond span per outer GICP iteration of each scan; one
    # host_read span per counted host read of the odometry
    traj = on.odometry.trajectory
    assert len(traj) == n
    iters = sum(e.gicp_iterations for e in traj)
    assert iters > n
    assert sum(r.name == "odometry.gicp.correspond" for r in under) == iters
    assert (sum(r.name == "odometry.host_read" for r in under)
            == on.odometry.host_syncs - syncs0)
    # set-up and the closure path: outside every scan
    warm = [r for r in records if r.name == "setup.warmup"]
    assert len(warm) == 1 and warm[0].scan == -1
    outside = {r.name for r in records if root[r.id] is None}
    assert {"setup.warmup", "closure_verify",
            "odometry.gicp.correspond"} <= outside


def _pipe_and_scans(duration):
    sim = synthetic.make_sim(duration=duration, n_points=1024,
                             calib_time=3.1, seed=5)
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    return sim, OdometryPipeline(_cfg(), device=CPU), scans


def _push_until(sim, pipe, i, stamp):
    """Push the IMU samples from ``i`` up to ``stamp``; the next index."""
    while i < len(sim.imu_stamps) and sim.imu_stamps[i] <= stamp:
        pipe.push_imu(sim.imu_stamps[i], sim.imu_ang[i], sim.imu_acc[i])
        i += 1
    return i


def test_held_back_scan_has_one_root(recording):
    """A scan refused during calibration, then held back for IMU, then
    taken leaves one ``pipeline.scan`` root and one ``odometry.pack``, with
    its index; the refusals leave no record."""
    sim, pipe, scans = _pipe_and_scans(0.4)
    h, xyz, pt = scans[0]
    with pytest.raises(NeedMoreImu):                # calibration
        pipe.process_scan(h, xyz, pt)
    i = _push_until(sim, pipe, 0, h + 0.5 * pt.max())
    with pytest.raises(NeedMoreImu):                # sweep not covered
        pipe.process_scan(h, xyz, pt)
    assert recording.records() == [] and recording.stage_table() == {}
    i = _push_until(sim, pipe, i, h + pt.max() + 0.02)
    pipe.process_scan(h, xyz, pt)
    h, xyz, pt = scans[1]
    with pytest.raises(NeedMoreImu):
        pipe.process_scan(h, xyz, pt)
    _push_until(sim, pipe, i, h + pt.max() + 0.02)
    pipe.process_scan(h, xyz, pt)
    records = recording.records()
    for name in ("pipeline.scan", "odometry.pack"):
        assert sorted(r.scan for r in records if r.name == name) == [0, 1]
    root = _root_of(records)
    assert all(root[r.id] is not None and r.scan == root[r.id].scan
               for r in records)


def test_process_scans_roots_and_pack_spans(recording):
    sim, pipe, scans = _pipe_and_scans(0.6)
    i = _push_until(sim, pipe, 0, scans[1][0] + scans[1][2].max() + 0.02)
    with pytest.raises(NeedMoreImu):      # the batch's third scan
        pipe.process_scans(scans[:3])
    assert recording.records() == []
    _push_until(sim, pipe, i, np.inf)
    pipe.process_scans(scans[:2])
    pipe.process_scans(scans[2:])
    records = recording.records()
    n = len(scans)
    roots = sorted(r.scan for r in records if r.name == "pipeline.scan")
    assert roots == list(range(n))
    # each batch's host packing, outside every scan, and each upload
    packs = sorted(r.scan for r in records if r.name == "odometry.pack")
    assert packs == [-1, -1] + list(range(n))
    root = _root_of(records)
    assert all(r.scan == root[r.id].scan for r in records
               if root[r.id] is not None)


def test_kernels_load_span(monkeypatch, tmp_path, recording):
    lib = tmp_path / "libnst_kernels_test.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "library_path", lambda: str(lib))
    monkeypatch.setattr(_build, "open_library", lambda path: ("lib", path))
    assert _build.load() == ("lib", str(lib))
    assert _build.load() == ("lib", str(lib))      # loaded: no second span
    assert [r.name for r in recording.records()] == ["setup.kernels_load"]
    assert not hasattr(_build, "build_seconds")
