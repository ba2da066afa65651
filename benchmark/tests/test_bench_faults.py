"""A run with the timed path broken underneath comes out not correct
(CPU, tiny sizes; the look for a card skipped): a step that returns its
state unchanged, half of each batch left out (replay), a pose altered
where it is produced, the registration's correction discarded (the pose
is the IMU prior), the map altered where it is produced. One card: no
exchange between chips to leave out. And the control, the reference
worked out in TF32 in the program's place, fails the cell's limits.

``default_nogate.live`` is the benchmark's cell. ``mulran.drive`` (the
MulRan deployment as the port ships it) is left out of ``BENCHMARK.json``
for the program's pose jumps; its replay path is held to the same faults
here, through ``LEFT_OUT``.

The program's own control, TF32 switched on, runs only on a card
(``test_tf32_control_on_the_card``)."""

import copy
import os
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from benchmark.harness import check, runner, spec  # noqa: E402

LIVE = "default_nogate.live"
DRIVE = "mulran.drive"
LEFT_OUT = {"workloads": [{"name": DRIVE, "config": "mulran_os1-64",
                           "traffic": "drive", "chips": 1}],
            "configs": [{"name": "mulran_os1-64",
                         "file": "benchmark/configs/mulran_os1-64.json"}]}
LONG = 20.0            # seconds of window with the registration skipped
# the step a fault is planted at: a scan of the window (warm-up and the
# set-up's 3 s of scans take 34-35 steps at the tiny sizes)
FAULT_AT = 37
# scans a tiny window holds at the least, however loaded the CPU: it
# closes at its seconds or at this count, whichever comes later
MIN_SCANS = 12


def find(cell_name):
    bench = spec.load_benchmark()
    for key, extra in LEFT_OUT.items():
        bench[key] = bench[key] + extra
    return spec.find_cell(cell_name, bench)


# (rows, columns) a CPU test holds: the replay at 2,048 points a scan;
# the deskewed walk at 8,192, where its map comes out within the cell's
# limit (at 2,048 the program's own in-sweep motion is too rough for it)
TINY = {"replay": (16, 128), "live": (32, 256)}


def tiny(cell_name):
    """The cell at a size a CPU test holds."""
    cell = find(cell_name)
    cfg = copy.deepcopy(cell.config)
    rows, cols = TINY[cell.traffic["mode"]]
    cfg["dlio"]["capacity"].update(max_points=rows * cols,
                                   max_ds_points=rows * cols // 2,
                                   max_keyframes=64, max_submap_kf=16,
                                   max_deskew_frames=512)
    cfg["dlio"]["tsdf"].update(max_blocks=8192, scan_block_cap=2048)
    cfg["sensor"].update(rows=rows, cols=cols)
    return cell, cfg


class AtLeast(runner.Window):
    """The harness's window, held open until it has ``MIN_SCANS`` scans."""

    def __init__(self, seconds, *args):
        super().__init__(seconds, *args)
        self.least = seconds

    def step(self, data_stamp, n_scans):
        if self.phase == "window":
            short = n_scans - self.n_open < MIN_SCANS
            self.seconds = float("inf") if short else self.least
        return super().step(data_stamp, n_scans)


def run_tiny(cell_name, hooks=None, seconds=4.0, seed=2 ** 31 + 21,
             edit=None):
    """The tiny cell's run and its numbers; ``edit(config)`` may change
    the configuration first."""
    torch.set_num_threads(2)
    cell, cfg = tiny(cell_name)
    if edit is not None:
        edit(cfg)
    with mock.patch.object(runner, "Window", AtLeast):
        rec = runner.run(cfg, cell.traffic, seed, seconds, False,
                         torch.device("cpu"), time.perf_counter(),
                         hooks=hooks)
    return cell, check.compare(rec, cell.traffic["checks"])[0], rec


def correct(cell, numbers):
    return check.judge(numbers, cell.limits)[1]


@pytest.fixture(scope="module", params=[LIVE, DRIVE])
def sound(request):
    return run_tiny(request.param)


def map_key(cell):
    return "map_gap" if "map" in cell.traffic["checks"] else "map_block_gap"


def _wrap_step(slam, after):
    """Wrap the fused step: ``after(carry, n)`` may alter what the n-th
    call produced."""
    step = slam.odometry._step
    calls = [0]

    def wrapped(carry, inp):
        carry, out = step(carry, inp)
        calls[0] += 1
        return after(carry, calls[0]) or carry, out

    slam.odometry._step = wrapped


# the walk's map at the tiny size: fewer points to a block, so the same
# millimetres of in-sweep motion move a larger share of its weight (the
# card's sound runs read 0.0015-0.0017 at the cell's size)
TINY_MAP_ALLOWANCE = 1.5


def test_sound_run_is_close(sound):
    cell, numbers, rec = sound
    assert rec.scans >= MIN_SCANS
    for k, limit in cell.limits.items():
        if k == "map_block_gap":
            limit = TINY_MAP_ALLOWANCE * limit
        assert numbers[k] <= limit, k


def test_state_left_unchanged(sound):
    frozen = {}

    def hooks(slam):
        def after(carry, n):
            if n == FAULT_AT:
                frozen["carry"] = carry
            return frozen.get("carry")
        _wrap_step(slam, after)

    cell, numbers, _ = run_tiny(sound[0].name, hooks)
    assert numbers["missing_poses"] > 0
    assert not correct(cell, numbers)


def test_half_of_each_batch_left_out():
    def hooks(slam):
        full = slam.process_scans
        slam.process_scans = lambda batch: full(batch[: len(batch) // 2])

    cell, numbers, _ = run_tiny(DRIVE, hooks)
    assert numbers["missing_poses"] > 0
    assert not correct(cell, numbers)


def test_pose_altered_where_produced(sound):
    def hooks(slam):
        def after(carry, n):
            if n == FAULT_AT:
                st = carry[0]
                k = int(st.num_scans) - 1
                st.traj[k, 2:5] += 5.0     # this scan's reported position
        _wrap_step(slam, after)

    cell, numbers, _ = run_tiny(sound[0].name, hooks)
    # the map, fused at the poses reported, no longer matches them; and
    # the scan's motion is 5 m off
    k = map_key(cell)
    assert numbers[k] > max(cell.limits[k], 3 * sound[1][k])
    assert numbers["pose_jumps"] > 0
    assert not correct(cell, numbers)


def test_map_altered_where_produced(sound):
    def hooks(slam):
        def after(carry, n):
            if n == FAULT_AT:
                carry[1].weight.mul_(1.5)  # the fused payload's weights
        _wrap_step(slam, after)

    cell, numbers, _ = run_tiny(sound[0].name, hooks)
    k = map_key(cell)
    assert numbers[k] > max(cell.limits[k], 3 * sound[1][k])
    assert not correct(cell, numbers)


def test_registration_skipped(monkeypatch, sound):
    """GICP's correction discarded on every scan: the poses follow the
    IMU prior and the map is fused at them; the motion scan by scan
    drifts from the path."""
    import noetic_slam_tpu_torch.ops.gicp as gicp

    align = gicp.gicp_align

    def prior_only(*a, **kw):
        r = align(*a, **kw)
        return r._replace(T=torch.eye(4, dtype=r.T.dtype))

    cell = sound[0]
    if "pose_err_m" not in cell.limits:
        pytest.skip(f"{cell.name} compares no pose error")
    monkeypatch.setattr(gicp, "gicp_align", prior_only)
    cell, numbers, _ = run_tiny(cell.name, seconds=LONG)
    assert sound[1]["pose_err_m"] < cell.limits["pose_err_m"]
    assert numbers["pose_err_m"] > cell.limits["pose_err_m"]
    assert not correct(cell, numbers)


def _mat_to_quat(R):
    """(n, 3, 3) -> (n, 4) wxyz, for rotations away from 180 degrees."""
    w = 0.5 * np.sqrt(np.clip(1.0 + np.trace(R, axis1=1, axis2=2), 0, None))
    return np.stack([w, (R[:, 2, 1] - R[:, 1, 2]) / (4 * w),
                     (R[:, 0, 2] - R[:, 2, 0]) / (4 * w),
                     (R[:, 1, 0] - R[:, 0, 1]) / (4 * w)], axis=-1)


def test_control_fails_the_limits():
    """The reference put in the program's place: scans 400-429 of the
    walk (45-60 m from the origin, as far as a window reaches), at the
    path's poses and fused in float64, pass the cell's limits; worked out
    in TF32, judged by the same limits, they come out not correct."""
    from benchmark.gen.producer import make_sensor

    cell = find(LIVE)
    sensor_cfg = dict(cell.config["sensor"], rows=16, cols=512)
    sensor = make_sensor(sensor_cfg, cell.traffic, 2 ** 31 + 23)
    idx = np.arange(400, 430)
    scans = {int(i): sensor.scan(int(i)) for i in idx}
    stamps = np.array([scans[int(i)][0] + 0.5 * sensor.period
                       for i in idx])
    R, p = sensor.truth(stamps)
    traj = np.c_[stamps, p, _mat_to_quat(R)]
    rec = runner.Record(traj=traj, sensor=sensor, dlio=cell.config["dlio"],
                        first_scan=400, end_scan=430, scans_by_index=scans,
                        ref_device=torch.device("cpu"))
    numbers = check.pose_numbers(rec)[0]
    numbers.update(lost_keyframes=0, map_block_gap=0.0)   # itself
    assert correct(cell, numbers)
    ctl = check.control(rec, cell.traffic["checks"])
    assert not correct(cell, {**numbers, **ctl})


# a map comparison for the occupancy backend, standing in for one in
# ``maps/``: it keeps the type of the state it is handed
STAND_IN = '''
def jump_m(dlio):
    return 2.0 * float(dlio["occupancy"]["voxel_size"])


def capture(slam, checks):
    st = slam.tsdf
    return {"state": type(st).__name__, "logodds": st.logodds.cpu()}


def numbers(rec, checks):
    return {"occupied_voxels": int((rec.payload["logodds"] > 0).sum())}


def control(rec, checks):
    return {}
'''


def test_map_backend_found_by_name(tmp_path, monkeypatch):
    """The walk on the occupancy backend runs to its end with a stand-in
    module as the only map comparison there is (no ``tsdf.py`` beside it):
    the runner and the comparison read the map only through it."""
    (tmp_path / "occupancy.py").write_text(STAND_IN)

    def occupancy(cfg):
        # after the cell is found: its own configuration's is in maps/
        monkeypatch.setattr(spec, "MAPS_DIR", str(tmp_path))
        cfg["dlio"]["map_backend"] = "occupancy"
        cfg["dlio"]["occupancy"].update(max_blocks=8192, scan_block_cap=2048)

    cell, numbers, rec = run_tiny(LIVE, edit=occupancy)
    assert rec.scans >= MIN_SCANS
    assert rec.payload["state"] == "OccupancyState"
    assert numbers["occupied_voxels"] > 0
    assert numbers["missing_poses"] == 0 == numbers["lost_keyframes"]
    # the cell's limits name the TSDF's number, which this map lacks
    assert "map_block_gap" not in numbers
    assert not correct(cell, numbers)


@pytest.mark.cuda
def test_tf32_control_on_the_card():
    """The program with TF32 switched on, at a small size on the card:
    its map fails the limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import noetic_slam_tpu_torch  # noqa: F401  (turns TF32 off at import)

    cell, cfg = tiny(DRIVE)
    cfg["dlio"]["capacity"].update(max_points=16384, max_ds_points=4096)
    cfg["sensor"].update(rows=16, cols=1024)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rec = runner.run(cfg, cell.traffic, 2 ** 31 + 41, 6.0, False,
                         torch.device("cuda"), time.perf_counter())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    numbers = check.compare(rec, cell.traffic["checks"])[0]
    assert numbers["map_gap"] > cell.limits["map_gap"]
