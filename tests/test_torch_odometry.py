"""Parity of the port's odometry model (``models.odometry``) with the JAX
package: the keyframe and submap functions on a shared state, and one
``make_slam_step`` step of both implementations from the same mid-run
state (JAX steps to it, ``convert`` carries it across)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noetic_slam_tpu.models import odometry as jo
from noetic_slam_tpu.models import tsdf as jt
from noetic_slam_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline
from noetic_slam_tpu.utils import synthetic
from noetic_slam_tpu_torch import convert
from noetic_slam_tpu_torch.config import CapacityConfig, DlioConfig, TsdfConfig
from noetic_slam_tpu_torch.models import odometry as to
from noetic_slam_tpu_torch.ops.gicp import HostSyncs
from noetic_slam_tpu_torch.ops.pointcloud import Scan as TScan
from tests.torch_parity import close, jax_cfg, to_np, to_torch

torch.set_num_threads(1)

# One registration step: the reference itself moves its pose by up to
# ~1.1 cm when one input scalar changes by one ulp (measured on this
# sequence: the scan's quantisation scale + 1 ulp, JAX against JAX). Its
# plane covariances come from |q|^2 - 2 q.x + |x|^2 and S - mu mu^T on
# cloud-centred coordinates, two cancellations that turn f32 rounding into
# ~0.5% covariance noise, and GICP stops within its 1 cm convergence
# threshold. Two implementations whose rounding differs therefore agree to
# that level, not to 1e-4 m.
STEP_POS_TOL = 0.02      # [m]
STEP_ROT_TOL = 2e-3      # quaternion components
# Everything before registration (intake, IMU, deskew, voxel filter) is
# the same f32 arithmetic: ~1 ulp at |x| ~ 30 m.
PRE_ATOL = 1e-4


def small_cfg():
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=4096, max_ds_points=2048, max_deskew_frames=1024,
            max_imu_window=64, max_keyframes=32, max_submap_kf=8),
        tsdf=TsdfConfig(max_blocks=256))


@pytest.fixture(scope="module")
def replay():
    """A short synthetic sequence run through the JAX pipeline; yields the
    step inputs and the (host) JAX state before each scan."""
    cfg = small_cfg()
    sim = synthetic.make_sim(duration=0.8, n_points=2048, calib_time=3.1,
                             seed=1)
    pipe = JaxPipeline(jax_cfg(cfg), with_tsdf=True)
    imu_i, steps = 0, []
    for s in range(len(sim.scan_stamps)):
        h, xyz, pt = sim.scan(s)
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= h + pt.max() + 0.02):
            pipe.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1
        delta = 0.0 if pipe.prev_header is None else h - pipe.prev_header
        packed = pipe._pack_scan(h, xyz, pt, delta)
        steps.append((packed, jax.device_get(pipe.state),
                      jax.device_get(pipe.tsdf_state)))
        pipe.process_scan(h, xyz, pt)
    return cfg, steps


def _both_steps(cfg, packed, odom_np, tsdf_np):
    jstep = jax.jit(jo.make_slam_step(jax_cfg(cfg)))
    jin = jo.StepInput(*[None if a is None else jnp.asarray(a)
                         for a in packed])
    (js, jm), jout = jstep((jax.tree_util.tree_map(jnp.asarray, odom_np),
                            jax.tree_util.tree_map(jnp.asarray, tsdf_np)),
                           jin)
    syncs = HostSyncs()
    tstep = to.make_slam_step(cfg, syncs)
    tin = to.StepInput(*[None if a is None else to_torch(a) for a in packed])
    (ts, tm), tout = tstep((convert.odom_state_from_numpy(odom_np, "cpu"),
                            convert.tsdf_state_from_numpy(tsdf_np, "cpu")),
                           tin)
    return (js, jm, jout), (ts, tm, tout), syncs


def test_bootstrap_step_matches_jax(replay):
    """The first scan: intake, deskew, voxel filter, keyframe push, submap
    gather and TSDF fusion, no registration."""
    cfg, steps = replay
    (js, jm, jout), (ts, tm, tout), syncs = _both_steps(cfg, *steps[0])
    assert syncs.n == 1 and bool(tout.processed) and bool(tout.is_keyframe)
    close(tout.world_xyz, jout.world_xyz, rtol=0, atol=PRE_ATOL)
    for f in ("kf_count", "kf_total", "submap_count", "num_scans",
              "total_steps", "submap_overflow"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    np.testing.assert_array_equal(to_np(ts.kf_valid), np.asarray(js.kf_valid))
    close(ts.kf_xyz, js.kf_xyz, rtol=0, atol=PRE_ATOL)
    # plane covariances: f32 rounding noise (see STEP_POS_TOL) decides the
    # normal of a third of these points in both implementations (measured
    # against a float64 evaluation; test_torch_ops holds the port to the
    # reference's accuracy), so hold the bulk only
    dc = np.abs(to_np(ts.kf_cov) - np.asarray(js.kf_cov)).max(-1)[
        np.asarray(js.kf_valid)]
    assert np.median(dc) < 1e-2 and np.mean(dc < 5e-2) > 0.6
    # the submap is the one keyframe, Morton-sorted (ties in key: compare
    # the sorted point sets)
    n = int(js.submap_count)
    a = np.sort(to_np(ts.submap_xyz)[:n].view([("", np.float32)] * 3), 0)
    b = np.sort(np.asarray(js.submap_xyz)[:n].view([("", np.float32)] * 3), 0)
    close(a.view(np.float32), b.view(np.float32), rtol=0, atol=PRE_ATOL)
    close(ts.traj, js.traj, rtol=0, atol=PRE_ATOL)
    # TSDF: a world point one ulp across a voxel face may land in the
    # neighbouring voxel, so compare the map in aggregate
    assert abs(int(tm.num_blocks) - int(jm.num_blocks)) <= 2
    close(tm.weight.sum(), jnp.sum(jm.weight), rtol=1e-3)
    close(tm.wsum.sum(), jnp.sum(jm.wsum), rtol=1e-3, atol=1e-1)


@pytest.mark.parametrize("k", [3, 6])
def test_registration_step_matches_jax(replay, k):
    """One fused step (registration, observer, keyframing, TSDF) from the
    same mid-run JAX state."""
    cfg, steps = replay
    _check_registration_step(cfg, steps[k])


def test_registration_step_knn_covariances_matches_jax(replay):
    """The same step with ``cov_engine="knn"``: source covariances from
    each point's k nearest neighbours (``plane_covariances``) instead of
    the radius-weighted moments."""
    cfg, steps = replay
    gicp = dataclasses.replace(cfg.gicp, cov_engine="knn")
    _check_registration_step(cfg.replace(gicp=gicp), steps[3])


def test_grid_nn_engine_still_raises():
    gicp = dataclasses.replace(small_cfg().gicp, nn_engine="grid")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        to.make_odometry_step(small_cfg().replace(gicp=gicp))


def _check_registration_step(cfg, step):
    (js, jm, jout), (ts, tm, tout), syncs = _both_steps(cfg, *step)
    assert bool(tout.processed) and bool(jout.processed)
    # host reads: one for skip/bootstrap, one per GICP outer iteration,
    # one for the submap re-gather
    assert syncs.n == int(tout.gicp_iterations) + 2
    close(ts.T_prior, js.T_prior, rtol=0, atol=PRE_ATOL)
    close(ts.lidar_p, js.lidar_p, rtol=0, atol=STEP_POS_TOL)
    close(ts.lidar_q, js.lidar_q, rtol=0, atol=STEP_ROT_TOL)
    close(ts.p, js.p, rtol=0, atol=STEP_POS_TOL)
    assert abs(int(tout.num_corr) - int(jout.num_corr)) <= 20
    assert bool(tout.is_keyframe) == bool(jout.is_keyframe)
    assert int(ts.kf_count) == int(js.kf_count)
    # mm pose differences move samples across voxel faces; with the
    # 256-block directory full, a moved sample can land in an unallocated
    # block and drop (measured up to 2.7% of the total weight on this run)
    assert abs(int(tm.num_blocks) - int(jm.num_blocks)) <= 8
    close(tm.weight.sum(), jnp.sum(jm.weight), rtol=0.1)


def _keyframe_state(rng, n_kf=20, K=32):
    """A JAX state with ``n_kf`` keyframes on a loop (numpy fields)."""
    cfg = small_cfg()
    st = jax.device_get(jo.init_state(jax_cfg(cfg)))
    ang = np.linspace(0, 2 * np.pi, n_kf, endpoint=False)
    pos = np.zeros((K, 3), np.float32)
    pos[:n_kf] = np.stack([8 * np.cos(ang), 5 * np.sin(ang),
                           rng.normal(0, 0.1, n_kf)], -1)
    quat = np.zeros((K, 4), np.float32)
    quat[:n_kf, 0] = 1.0
    Nk = cfg.capacity.max_ds_points
    xyz = np.full((K, Nk, 3), 1e6, np.float32)
    valid = np.zeros((K, Nk), bool)
    for i in range(n_kf):
        m = rng.integers(100, 300)
        xyz[i, :m] = pos[i] + rng.normal(0, 3, (m, 3))
        valid[i, :m] = True
    seq = np.zeros(K, np.int32)
    seq[:n_kf] = np.arange(1, n_kf + 1)
    st = st._replace(kf_pos=pos, kf_quat=quat, kf_xyz=xyz, kf_valid=valid,
                     kf_cov=rng.normal(size=(K, Nk, 6)).astype(np.float32),
                     kf_count=np.int32(n_kf), kf_seq=seq,
                     kf_total=np.int32(n_kf),
                     p=np.array([7.5, 1.0, 0.0], np.float32),
                     lidar_p=np.array([7.4, 1.1, 0.0], np.float32),
                     lidar_q=np.array([0.99, 0.0, 0.1, 0.0], np.float32)
                     / np.linalg.norm([0.99, 0.0, 0.1, 0.0]))
    return cfg, st


@pytest.mark.parametrize("n_kf", [3, 20, 32])
def test_keyframe_and_submap_functions_match_jax(n_kf):
    rng = np.random.default_rng(n_kf)
    cfg, st = _keyframe_state(rng, n_kf=n_kf)
    js = jax.tree_util.tree_map(jnp.asarray, st)
    ts = convert.odom_state_from_numpy(st, "cpu")
    alpha = 1.0
    jcfg = jax_cfg(cfg)
    jmask = jo.select_submap_keyframes(jcfg, js, alpha=jnp.float32(alpha))
    tmask = to.select_submap_keyframes(cfg, ts, alpha=torch.tensor(alpha))
    np.testing.assert_array_equal(to_np(tmask), np.asarray(jmask))
    active = np.arange(32) < n_kf
    np.testing.assert_array_equal(
        to_np(to.convex_hull_mask(ts.kf_pos, to_torch(active))),
        np.asarray(jo.convex_hull_mask(js.kf_pos, jnp.asarray(active))))
    np.testing.assert_array_equal(
        to_np(to.alpha_boundary_mask(ts.kf_pos, to_torch(active),
                                     torch.tensor(2.0))),
        np.asarray(jo.alpha_boundary_mask(js.kf_pos, jnp.asarray(active),
                                          jnp.float32(2.0))))
    # gather: the same points in the submap (Morton ties -> compare sets)
    got = to.gather_submap(cfg, ts, tmask)
    want = jo.gather_submap(jcfg, js, jmask)
    for i in (3, 4):
        assert int(got[i]) == int(want[i])
    n = int(want[3])
    key = lambda x: np.lexsort(x[:n].T)          # noqa: E731
    gx, wx = to_np(got[0]), np.asarray(want[0])
    close(gx[:n][key(gx)], wx[:n][key(wx)], rtol=0, atol=0)
    assert bool(to.keyframe_decision(ts, torch.tensor(1.0), 45.0)) == bool(
        jo.keyframe_decision(js, jnp.float32(1.0), 45.0))
    if n_kf == 32:
        assert int(to.select_eviction_victim(ts)) == int(
            jo.select_eviction_victim(js))
    # push (append or evict) + outbox ring, in place on the port's side
    cloud = rng.normal(size=(cfg.capacity.max_ds_points, 3)).astype(np.float32)
    cv = rng.random(cfg.capacity.max_ds_points) > 0.3
    cov = rng.normal(size=(cfg.capacity.max_ds_points, 6)).astype(np.float32)
    jp = jo.push_keyframe(js, jnp.asarray(cloud), jnp.asarray(cv),
                          jnp.asarray(cov), jnp.array(True))
    tp = to.push_keyframe(ts, to_torch(cloud), to_torch(cv), to_torch(cov),
                          torch.tensor(True))
    for f in ("kf_pos", "kf_quat", "kf_xyz", "kf_valid", "kf_cov", "kf_seq",
              "kf_count", "kf_total", "ob_q", "ob_p", "ob_seq", "ob_slot",
              "ob_xyz"):
        np.testing.assert_array_equal(to_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)


def test_observer_and_adaptive_match_jax(rng):
    cfg, st = _keyframe_state(rng)
    cfg = cfg.replace(adaptive=True)
    st = st._replace(num_scans=np.int32(5), spaciousness=np.float32(4.0),
                     density=np.float32(0.3),
                     first_opt_done=np.bool_(True),
                     source_density=np.float32(0.4))
    js = jax.tree_util.tree_map(jnp.asarray, st)
    ts = convert.odom_state_from_numpy(st, "cpu")
    xyz = rng.uniform(-20, 20, (512, 3)).astype(np.float32)
    valid = rng.random(512) > 0.1
    jcfg = jax_cfg(cfg)
    want = jo.compute_adaptive(jcfg, js, jo.Scan(jnp.asarray(xyz), None,
                                                jnp.asarray(valid), None))
    got = to.compute_adaptive(cfg, ts, TScan(to_torch(xyz), None,
                                             to_torch(valid), None))
    for a, b in zip(got, want):
        close(a, b)
    jg = jo.geo_update(jcfg, js, jnp.float32(0.1))
    tg = to.geo_update(cfg, ts, torch.tensor(0.1))
    for f in ("q", "p", "v", "ba", "bg", "prev_vel"):
        close(getattr(tg, f), getattr(jg, f))
    stamps = np.cumsum(rng.uniform(0.008, 0.012, 64)).astype(np.float32)
    ang = rng.normal(size=(64, 3)).astype(np.float32)
    acc = rng.normal(size=(64, 3)).astype(np.float32) + [0, 0, 9.8]
    acc = acc.astype(np.float32)
    want = jo.condition_imu(jcfg, jnp.asarray(stamps), jnp.asarray(ang),
                            jnp.asarray(acc), js.ba, js.bg)
    got = to.condition_imu(cfg, to_torch(stamps), to_torch(ang),
                           to_torch(acc), ts.ba, ts.bg)
    for a, b in zip(got, want):
        close(a, b, atol=1e-5)


def test_convert_round_trip(rng):
    cfg, st = _keyframe_state(rng, n_kf=5)
    ts = convert.odom_state_from_numpy(st, "cpu")
    back = convert.odom_state_to_numpy(ts)
    assert set(back) == set(to.OdomState._fields)
    for f, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(st, f)),
                                      err_msg=f)
    tsdf_np = jax.device_get(jt.init_tsdf(jax_cfg(cfg.tsdf)))
    t = convert.tsdf_state_from_numpy(tsdf_np, "cpu")
    for f, v in convert.tsdf_state_to_numpy(t).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(tsdf_np, f)))


def test_occupancy_backend_not_ported():
    """Only the backends the port has build: "occupancy" does (its parity
    is in tests/test_torch_occupancy.py); an unknown one raises."""
    cfg = small_cfg().replace(map_backend="occupancy")
    assert callable(to.make_slam_step(cfg))
    assert callable(to.make_map_fuse(cfg))
    with pytest.raises(ValueError, match="map_backend"):
        to.make_slam_step(small_cfg().replace(map_backend="octree"))


@pytest.mark.parametrize("quantized", [True, False])
def test_step_input_wire_formats_match_jax(quantized):
    """Both wire formats decode to the same points, times and validity."""
    cfg = small_cfg()
    cfg = cfg.replace(preproc=cfg.preproc.__class__(quantized_wire=quantized))
    sim = synthetic.make_sim(duration=0.3, n_points=1500, calib_time=3.1,
                             seed=9)
    pipe = JaxPipeline(jax_cfg(cfg))
    for i in range(len(sim.imu_stamps)):
        pipe.push_imu(sim.imu_stamps[i], sim.imu_ang[i], sim.imu_acc[i])
    h, xyz, pt = sim.scan(0)
    xyz[::97] = np.nan                       # invalid rows
    packed = pipe._pack_scan(h, xyz, pt, 0.0)
    j = jo.StepInput(*[None if a is None else jnp.asarray(a) for a in packed])
    t = to.StepInput(*[None if a is None else to_torch(a) for a in packed])
    assert t.quantized == quantized
    np.testing.assert_array_equal(to_np(t.valid), np.asarray(j.valid))
    close(t.xyz, j.xyz, rtol=0, atol=0)
    close(t.t, j.t, rtol=0, atol=0)
    for f in ("imu_stamps", "imu_ang", "imu_acc", "header_delta", "deskew",
              "imu_count"):
        close(getattr(t, f), getattr(j, f), rtol=0, atol=0)
