"""The odometry step's front (``models.odometry.step_front``): on the CPU it
runs eagerly and equals the step's earlier inline code bitwise, with both
graph counters at 0; on the card (tests marked ``cuda``) it is one CUDA
graph per input signature, held bitwise to the eager front over the
benchmark's walk at the cell's configuration, through two sequences
interleaved in one batched step, and over a second signature. This file
imports no JAX, so that the tests marked ``cuda`` also run on a machine
with a card and no JAX:

    python -m pytest -m cuda tests/test_torch_front_graph.py

Without a card those tests skip; the CPU tests run everywhere."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from noetic_slam_tpu_torch.config import (
    CapacityConfig,
    DlioConfig,
    KeyframeConfig,
    TsdfConfig,
)
from noetic_slam_tpu_torch.config.params import load_config
from noetic_slam_tpu_torch.models import odometry as to
from noetic_slam_tpu_torch.ops import gicp as gicp_ops
from noetic_slam_tpu_torch.ops import imu as imu_ops
from noetic_slam_tpu_torch.ops.deskew import deskew_points, transform_cloud
from noetic_slam_tpu_torch.ops.pointcloud import (
    SENTINEL,
    Scan,
    const,
    crop_box,
    prepare_scan,
    take,
    voxel_downsample,
)
from noetic_slam_tpu_torch.parallel.batch import make_batched_odometry_step
from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
from noetic_slam_tpu_torch.utils import synthetic
from noetic_slam_tpu_torch.utils.geometry import make_se3

torch.set_num_threads(1)
CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_SCANS = 64          # walk scans a card test steps
SEED = 3000002001        # the walk's draw (the benchmark's seeds are large)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graph test)")
    return torch.device("cuda")


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The tensor's bits: a float32 as int32, anything else as it is."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _differing(a, b) -> list:
    """Names of the fields of two ``Front``s that are not bitwise equal."""
    return [k for k, x, y in zip(to.Front._fields, a, b)
            if x.shape != y.shape or x.dtype != y.dtype
            or not torch.equal(_bits(x), _bits(y))]


# ---------------------------------------------------------------------------
# The step's earlier inline code, as the oracle of the extracted front
# ---------------------------------------------------------------------------

def _inline_front(cfg, state, inp) -> to.Front:
    """The step's code before the front was extracted, from the intake
    through the observer propagation, returning what the rest of the step
    used."""
    cap = cfg.capacity
    dev = state.q.device
    R_ext = np.asarray(cfg.extrinsics.baselink2lidar_R,
                       np.float32).reshape(3, 3)
    t_ext = np.asarray(cfg.extrinsics.baselink2lidar_t, np.float32)
    T_ext_np = np.eye(4, dtype=np.float32)
    T_ext_np[:3, :3], T_ext_np[:3, 3] = R_ext, t_ext
    ext_R = const(tuple(map(tuple, R_ext)), dev)
    ext_t = const(tuple(t_ext), dev)
    T_ext = const(tuple(map(tuple, T_ext_np)), dev)
    f32 = dict(dtype=torch.float32, device=dev)

    valid_in = inp.valid
    scan = Scan(inp.xyz, inp.t, valid_in, valid_in.sum().to(torch.int32))
    scan = crop_box(scan, cfg.preproc.crop_size)
    threshD, max_corr, sp_lpf, den_lpf = to.compute_adaptive(cfg, state,
                                                             scan)
    w_corr, a_corr = to.condition_imu(cfg, inp.imu_stamps, inp.imu_ang,
                                      inp.imu_acc, state.ba, state.bg)
    prep = prepare_scan(scan, cap.max_deskew_frames)
    scan_stamp = torch.where(inp.deskew, prep.scan_stamp,
                             torch.zeros((), **f32))
    sweep_end = torch.where(
        inp.deskew,
        take(prep.unique_t, torch.clamp(prep.unique_count - 1, 0,
                                        cap.max_deskew_frames - 1)),
        scan_stamp)
    sweep_end = torch.maximum(sweep_end, scan_stamp)
    prev_stamp = state.prev_stamp_off - inp.header_delta
    prop_start = state.prop_off - inp.header_delta
    window = imu_ops.slice_imu_window(
        inp.imu_stamps, w_corr, a_corr, inp.imu_count, prev_stamp,
        sweep_end, cap.max_imu_window)
    frames_q, frames_p, imu_ok = imu_ops.integrate_imu(
        window, prev_stamp, state.lidar_q, state.lidar_p, state.prev_vel,
        prep.unique_t, cfg.gravity)
    first_scan = state.kf_count == 0
    med = torch.clamp(prep.median_idx, 0, cap.max_deskew_frames - 1)
    T_imu = make_se3(take(frames_q, med), take(frames_p, med))
    use_imu = imu_ok & ~first_scan
    T_prior = torch.where(use_imu, T_imu, state.T)
    deskew_ok = inp.deskew & use_imu
    world_deskewed = deskew_points(prep, frames_q, frames_p, ext_R, ext_t)
    world_rigid = transform_cloud(prep.xyz, prep.valid, T_prior @ T_ext)
    world_pts = torch.where(deskew_ok, world_deskewed, world_rigid)
    world_pts = torch.where(prep.valid[:, None], world_pts, SENTINEL)

    if cfg.preproc.voxelize:
        ds_xyz, ds_valid, _ = voxel_downsample(
            world_pts, prep.valid, cfg.preproc.voxel_res, cap.max_ds_points)
    else:
        ds_xyz = world_pts[: cap.max_ds_points]
        ds_valid = prep.valid[: cap.max_ds_points]
    enough_points = ds_valid.sum() > cfg.gicp.min_num_points

    if cfg.gicp.cov_engine == "radius":
        src_cov, src_density = gicp_ops.radius_covariances(
            ds_xyz, ds_valid, cfg.gicp.cov_radius)
    else:
        src_cov, src_density = gicp_ops.plane_covariances(
            ds_xyz, ds_valid, cfg.gicp.k_correspondences,
            use_grid=cfg.gicp.nn_engine == "grid",
            cell=4.0 * cfg.preproc.voxel_res)

    prop_window = imu_ops.slice_imu_window(
        inp.imu_stamps, w_corr, a_corr, inp.imu_count, prop_start,
        sweep_end, cap.max_imu_window)
    q_prop, p_prop, v_prop = imu_ops.propagate_state_batch(
        state.q, state.p, state.v, prop_window, prop_window.count,
        cfg.gravity, start_exclusive=prop_start)
    if cfg.geo.max_velocity > 0:
        vn = torch.linalg.vector_norm(v_prop)
        v_prop = torch.where(
            vn > cfg.geo.max_velocity,
            v_prop * (cfg.geo.max_velocity / torch.clamp(vn, min=1e-9)),
            v_prop)
    last_idx = torch.clamp(prop_window.count - 1, 0, cap.max_imu_window - 1)
    prop_boundary = torch.where(
        prop_window.count > 0,
        torch.maximum(take(prop_window.stamps, last_idx), prop_start),
        torch.maximum(sweep_end, prop_start))
    fod = state.first_opt_done
    return to.Front(
        q=torch.where(fod, q_prop, state.q),
        p=torch.where(fod, p_prop, state.p),
        v=torch.where(fod, v_prop, state.v),
        ds_xyz=ds_xyz, ds_valid=ds_valid, src_cov=src_cov,
        src_density=src_density, threshD=threshD, max_corr=max_corr,
        sp_lpf=sp_lpf, den_lpf=den_lpf, T_prior=T_prior,
        scan_stamp=scan_stamp, prev_stamp=prev_stamp, sweep_end=sweep_end,
        deskew_ok=deskew_ok, world_pts=world_pts, world_valid=prep.valid,
        enough_points=enough_points, first_scan=first_scan,
        prop_boundary=prop_boundary)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def _small_cfg(**gicp):
    cfg = DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=16, max_submap_kf=4),
        keyframe=KeyframeConfig(thresh_dist=0.25, thresh_rot=45.0),
        tsdf=TsdfConfig(voxel_size=0.2, truncation=0.6, max_blocks=4096,
                        space_carving=False))
    return cfg.replace(gicp=dataclasses.replace(cfg.gicp, **gicp))


def _drive(pipe, sim, scans, times: bool = True):
    """Every scan through ``pipe``, the IMU pushed just past its sweep."""
    imu_i = 0
    for h, xyz, pt in scans:
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= h + pt.max() + 0.02):
            pipe.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1
        pipe.process_scan(h, xyz, pt if times else None)


@pytest.mark.parametrize("quantized, times, gicp", [
    (True, True, {}),
    (False, True, {}),
    (True, False, {}),
    (False, True, {"cov_engine": "knn", "nn_engine": "grid"}),
])
def test_front_equals_the_inline_code_on_the_cpu(quantized, times, gicp):
    """Along a small run, at every scan's state and input, the extracted
    front equals the step's earlier inline code bitwise: both wires, scans
    with and without point times, both covariance engines."""
    cfg = _small_cfg(**gicp)
    cfg = cfg.replace(preproc=dataclasses.replace(
        cfg.preproc, quantized_wire=quantized))
    sim = synthetic.make_sim(duration=1.6, n_points=1024, calib_time=3.1,
                             seed=11)
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    pipe = OdometryPipeline(cfg, device=CPU)
    step, seen = pipe._step, []

    def checking(state, inp):
        got = to.step_front(cfg, state, inp)
        seen.append(_differing(got, _inline_front(cfg, state, inp)))
        return step(state, inp)

    pipe._step = checking
    _drive(pipe, sim, scans, times)
    assert len(seen) == len(scans)
    assert seen == [[]] * len(scans)
    assert (step.front_captures, step.front_replays) == (0, 0)


def test_counters_stay_zero_on_the_cpu():
    """Off the card nothing is captured or replayed, on the odometry step
    and on the fused step, and the front is the eager one."""
    cfg = _small_cfg()
    sim = synthetic.make_sim(duration=1.0, n_points=1024, calib_time=3.1,
                             seed=5)
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    for with_tsdf in (False, True):
        pipe = OdometryPipeline(cfg, device=CPU, with_tsdf=with_tsdf)
        pipe.warmup()
        _drive(pipe, sim, scans)
        assert len(pipe.flush()) == len(scans)
        assert (pipe.front_captures, pipe.front_replays) == (0, 0)
        state = pipe.state
        inp = pipe._to_device(pipe._pack_scan(*scans[-1], 0.1))
        assert _differing(pipe._step.front(state, inp),
                          to.step_front(cfg, state, inp)) == []


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def _bench_json(*parts) -> dict:
    with open(os.path.join(REPO, "benchmark", *parts)) as f:
        return json.load(f)


def _generated(config: str, traffic: str, seed: int):
    """(DlioConfig, sensor) of a benchmark configuration and traffic."""
    from benchmark.gen.producer import make_sensor

    conf = _bench_json("configs", f"{config}.json")
    return (load_config(overrides=conf["dlio"]),
            make_sensor(conf["sensor"], _bench_json("traffic",
                                                    f"{traffic}.json"),
                        seed))


class _Feed:
    """A pipeline fed the generated sequence: the IMU from the sensor, and
    scan ``i`` on ``next()``, as the benchmark's live loop feeds it."""

    def __init__(self, pipe, sensor):
        self.pipe, self.sensor = pipe, sensor
        self._j, self._i = 0, 0
        self._push(-1e-9)                   # the static calibration

    def _push(self, t):
        while True:
            t_imu, g, a = self.sensor.imu(self._j, self._j + 64)
            k = int(np.searchsorted(t_imu, t, side="right"))
            for m in range(k):
                self.pipe.push_imu(float(t_imu[m]), g[m], a[m])
            self._j += k
            if k < len(t_imu):
                return

    def next(self):
        header, xyz, pt = self.sensor.scan(self._i)
        self._i += 1
        self._push(header + (float(pt.max()) if pt is not None else 0.0)
                   + 0.02)
        return self.pipe.process_scan(header, xyz, pt)


def _clone_state(state):
    return type(state)(*(x.clone() for x in state))


def _assert_states_equal(a, b, what):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(_bits(x), _bits(y)), f"{what}: {name}"


@pytest.mark.cuda
def test_graph_front_bitwise_the_eager_front_over_the_walk(cuda_device):
    """The cell's configuration (quantized wire, point times) over 64 scans
    of the walk: at every scan the graph front equals the eager front on
    the same state and input bitwise; one capture (at ``warmup``), and a
    replay at every front call."""
    cfg, sensor = _generated("dlio_default_os1-64_nogate", "walk", SEED)
    pipe = OdometryPipeline(cfg, device=cuda_device)
    pipe.warmup()
    assert (pipe.front_captures, pipe.front_replays) == (1, 3)
    step, seen = pipe._step, []

    def checking(state, inp):
        assert inp.pt is not None and inp.quantized
        seen.append(_differing(step.front(state, inp),
                               to.step_front(cfg, state, inp)))
        return step(state, inp)

    pipe._step = checking
    feed = _Feed(pipe, sensor)
    for _ in range(CARD_SCANS):
        feed.next()
    assert seen == [[]] * CARD_SCANS
    assert step.front_captures == 1
    assert step.front_replays == 3 + 2 * CARD_SCANS
    traj = pipe.flush()
    assert len(traj) == CARD_SCANS and np.isfinite(traj).all()


def _record(cfg, sensor, device, n: int):
    """``n`` scans of a pipeline on ``device``: its state before the first
    step, every input, every output (cloned) and its last state."""
    pipe = OdometryPipeline(cfg, device=device)
    step, rec = pipe._step, {"inputs": [], "outs": []}

    def keeping(state, inp):
        if "state0" not in rec:
            rec["state0"] = _clone_state(state)
        rec["inputs"].append(inp)
        state, out = step(state, inp)
        rec["outs"].append(type(out)(*(x.clone() for x in out)))
        return state, out

    pipe._step = keeping
    feed = _Feed(pipe, sensor)
    for _ in range(n):
        feed.next()
    rec["state"] = pipe.state
    return rec


@pytest.mark.cuda
def test_interleaved_sequences_keep_their_own_state(cuda_device):
    """Two walks, each stepped alone, then both interleaved through one
    ``make_batched_odometry_step`` (one front graph replayed for sequence
    0, then 1, every scan): every output and both last states bitwise the
    lone runs', so no graph buffer outlives its step."""
    n = CARD_SCANS
    alone = [_record(*_generated("dlio_default_os1-64_nogate", "walk",
                                 SEED + k), cuda_device, n)
             for k in range(2)]
    cfg = load_config(overrides=_bench_json(
        "configs", "dlio_default_os1-64_nogate.json")["dlio"])
    step = make_batched_odometry_step(cfg)
    states = [_clone_state(r["state0"]) for r in alone]
    for s in range(n):
        states, outs = step(states, [r["inputs"][s] for r in alone])
        for k, (out, r) in enumerate(zip(outs, alone)):
            for name, x, y in zip(out._fields, out, r["outs"][s]):
                assert torch.equal(_bits(x), _bits(y)), \
                    f"scan {s}, sequence {k}: {name}"
    for k, (st, r) in enumerate(zip(states, alone)):
        _assert_states_equal(st, r["state"], f"sequence {k}")


@pytest.mark.cuda
def test_second_signature_captures_a_second_graph(cuda_device):
    """One step at the cell's configuration takes the walk's inputs and
    the MulRan configuration's (65,536 points, no point times) from a
    drive, each sequence from its own state, in turns: two captures, one
    per signature, a replay at every front call, and every front bitwise
    the eager one."""
    cfg, walk = _generated("dlio_default_os1-64_nogate", "walk", SEED)
    mcfg, drive = _generated("mulran_os1-64", "drive", SEED)
    odo = to.make_odometry_step(cfg)
    feeds, states, seen = [], [], []
    for c, sensor in ((cfg, walk), (mcfg, drive)):
        pipe = OdometryPipeline(c, device=cuda_device)
        pipe._step = lambda state, inp: (state, inp)
        feeds.append(_Feed(pipe, sensor))
    n = CARD_SCANS // 2
    for s in range(n):
        for k, feed in enumerate(feeds):
            if s == 0:
                calib = feed.pipe.state
                states.append(to.init_state(
                    cfg, cuda_device, q0=calib.q.cpu(), ba0=calib.ba.cpu(),
                    bg0=calib.bg.cpu()))
            inp = feed.next()
            assert inp.points.shape[0] == (32768, 65536)[k]
            seen.append(_differing(odo.front(states[k], inp),
                                   to.step_front(cfg, states[k], inp)))
            states[k], _ = odo(states[k], inp)
    assert seen == [[]] * (2 * n)
    assert odo.front_captures == 2
    assert odo.front_replays == 2 * 2 * n
