"""Parity of the port's grid NN engine (``ops.gridnn``, the step's
``nn_engine="grid"``) with the JAX package: the four cases of
tests/test_gridnn.py on the port, each also held to JAX's functions on the
same numpy inputs; the grid covariances; one odometry step and a short
replay with the grid engine for both ``cov_engine``s; and a checkpoint
taken with the grid engine crossing between the packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noetic_slam_tpu.ops import gicp as jgicp
from noetic_slam_tpu.ops import gridnn as jgrid
from noetic_slam_tpu.runtime import checkpoint as jckpt
from noetic_slam_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline
from noetic_slam_tpu.utils import synthetic
from noetic_slam_tpu_torch import convert
from noetic_slam_tpu_torch.config import CapacityConfig, DlioConfig, TsdfConfig
from noetic_slam_tpu_torch.models import odometry as to
from noetic_slam_tpu_torch.ops import gicp as tgicp
from noetic_slam_tpu_torch.ops import gridnn as tgrid
from noetic_slam_tpu_torch.ops.gicp import HostSyncs
from noetic_slam_tpu_torch.ops.pointcloud import SENTINEL
from noetic_slam_tpu_torch.runtime import checkpoint as tckpt
from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
from tests.torch_parity import close, jax_cfg, to_np, to_torch

torch.set_num_threads(1)

STEP_POS_TOL = 0.02      # [m], one registration step (test_torch_odometry)
STEP_ROT_TOL = 2e-3      # quaternion components
REPLAY_POS_TOL = 0.05    # [m] per scan over a replay (test_torch_slice_*)


def _brute(query, target):
    d = ((query[:, None, :] - target[None, :, :]) ** 2).sum(-1)
    return d.argmin(1), d.min(1)


def _both_grids(tgt, valid, cell):
    jg = jgrid.build_grid(jnp.asarray(tgt), jnp.asarray(valid), cell)
    tg = tgrid.build_grid(to_torch(tgt), to_torch(valid), cell)
    return jg, tg


def _unique_nearest(q, tgt, valid):
    """Queries whose nearest valid target is strictly nearer than the
    second nearest (where both packages must pick the same index)."""
    d = ((q[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
    d = np.where(valid[None, :], d, np.inf)
    two = np.sort(d, axis=1)[:, :2]
    return two[:, 0] < two[:, 1]


def test_build_grid_matches_jax(rng):
    """Keys and order equal exactly, the sorted points bitwise; invalid
    rows and points beyond the 1024-cell reach key to INT32_MAX."""
    tgt = rng.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
    tgt[::7] = SENTINEL
    tgt[5] = [700.0, 0.0, 0.0]                  # beyond 1024 cells of 0.5
    valid = np.abs(tgt).max(1) < 1e5
    jg, tg = _both_grids(tgt, valid, 0.5)
    np.testing.assert_array_equal(to_np(tg.keys), np.asarray(jg.keys))
    np.testing.assert_array_equal(to_np(tg.order), np.asarray(jg.order))
    np.testing.assert_array_equal(to_np(tg.xyz), np.asarray(jg.xyz))
    np.testing.assert_array_equal(to_np(tg.origin), np.asarray(jg.origin))
    assert tg.keys.dtype == tg.order.dtype == torch.int32
    assert int((tg.keys == np.iinfo(np.int32).max).sum()) == int(
        (~valid).sum()) + 1


def test_grid_nn1_exact_within_radius(rng):
    tgt = rng.uniform(-10, 10, size=(2000, 3)).astype(np.float32)
    q = (tgt[rng.integers(0, 2000, 500)]
         + rng.normal(scale=0.1, size=(500, 3))).astype(np.float32)
    radius = 0.5
    valid = np.ones(2000, bool)
    jg, tg = _both_grids(tgt, valid, radius)
    idx, sqd = tgrid.grid_nn1(to_torch(q), tg, max_per_cell=64)
    jidx, jsqd = jgrid.grid_nn1(jnp.asarray(q), jg, max_per_cell=64)
    widx, wsqd = _brute(q, tgt)
    close_ = wsqd < radius ** 2
    np.testing.assert_array_equal(to_np(idx)[close_], widx[close_])
    np.testing.assert_allclose(to_np(sqd)[close_], wsqd[close_], rtol=1e-5)
    # against JAX: the same index where the nearest is unique, sqd 1e-6
    uniq = _unique_nearest(q, tgt, valid) & np.isfinite(np.asarray(jsqd))
    np.testing.assert_array_equal(to_np(idx)[uniq], np.asarray(jidx)[uniq])
    np.testing.assert_array_equal(np.isinf(to_np(sqd)),
                                  np.isinf(np.asarray(jsqd)))
    fin = np.isfinite(np.asarray(jsqd))
    np.testing.assert_allclose(to_np(sqd)[fin], np.asarray(jsqd)[fin],
                               rtol=1e-6)


def test_grid_nn1_far_queries_miss(rng):
    tgt = rng.uniform(0, 5, size=(500, 3)).astype(np.float32)
    q = np.full((10, 3), 100.0, np.float32)
    jg, tg = _both_grids(tgt, np.ones(500, bool), 0.5)
    _, sqd = tgrid.grid_nn1(to_torch(q), tg)
    _, jsqd = jgrid.grid_nn1(jnp.asarray(q), jg)
    assert np.isinf(to_np(sqd)).all() and np.isinf(np.asarray(jsqd)).all()


def test_grid_nn1_ignores_invalid_targets(rng):
    tgt = np.full((256, 3), SENTINEL, np.float32)
    tgt[:64] = rng.uniform(0, 4, size=(64, 3)).astype(np.float32)
    valid = np.zeros(256, bool)
    valid[:64] = True
    jg, tg = _both_grids(tgt, valid, 0.5)
    q = tgt[:8]
    idx, sqd = tgrid.grid_nn1(to_torch(q), tg)
    jidx, jsqd = jgrid.grid_nn1(jnp.asarray(q), jg)
    assert to_np(idx).max() < 64
    np.testing.assert_allclose(to_np(sqd), 0.0, atol=1e-7)
    np.testing.assert_array_equal(to_np(idx), np.asarray(jidx))
    np.testing.assert_array_equal(to_np(sqd), np.asarray(jsqd))


def test_grid_knn_matches_brute_on_dense_cloud(rng):
    """k-NN on a dense cloud (neighbours within one cell): against brute
    force as the JAX test has it, and against JAX's sorted distances."""
    tgt = rng.uniform(0, 6, size=(4000, 3)).astype(np.float32)
    jg, tg = _both_grids(tgt, np.ones(4000, bool), 1.0)
    q = tgt[:200]
    k = 8
    idx, sqd = tgrid.grid_knn(to_torch(q), tg, k, max_per_cell=128)
    _, jsqd = jgrid.grid_knn(jnp.asarray(q), jg, k, max_per_cell=128)
    d = ((q[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
    want = np.sort(d, axis=1)[:, :k]
    assert (want < 1.0).all()
    np.testing.assert_allclose(to_np(sqd), want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_np(sqd), np.asarray(jsqd), rtol=1e-5)
    # the indices name points at those distances (ties may swap)
    got_d = ((q[:, None, :] - tgt[to_np(idx)]) ** 2).sum(-1)
    np.testing.assert_allclose(got_d, to_np(sqd), rtol=1e-5, atol=1e-7)


def test_grid_chunking_does_not_change_the_result(rng):
    tgt = rng.uniform(0, 6, size=(1500, 3)).astype(np.float32)
    q = to_torch(rng.uniform(0, 6, size=(300, 3)).astype(np.float32))
    _, tg = _both_grids(tgt, np.ones(1500, bool), 1.0)
    for fn, kw in ((tgrid.grid_nn1, {}), (tgrid.grid_knn, {"k": 5})):
        a = fn(q, tg, max_per_cell=64, **kw)
        b = fn(q, tg, max_per_cell=64, query_chunk=37, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_plane_covariances_grid_matches_jax(rng):
    """``use_grid=True``: neighbours from a grid over the cloud, a missing
    neighbour replaced by the point itself."""
    xyz = np.c_[rng.uniform(-4, 4, (1500, 2)),
                rng.normal(0, 0.02, 1500)].astype(np.float32)
    xyz[-100:] = SENTINEL
    valid = np.abs(xyz).max(1) < 1e5
    jc, jd = jgicp.plane_covariances(jnp.asarray(xyz), jnp.asarray(valid),
                                     k=16, use_grid=True, cell=1.0)
    tc, td = tgicp.plane_covariances(to_torch(xyz), to_torch(valid), k=16,
                                     use_grid=True, cell=1.0)
    close(tc, jc, rtol=0, atol=1e-5)
    close(td, jd, rtol=1e-5, atol=1e-7)


def test_gicp_align_with_grid_launches_no_nn1(rng, monkeypatch):
    """With a target grid the correspondences come from the grid: the
    1-NN of kernel A (its plain version here) is never called, and the
    result equals JAX's grid alignment."""
    from noetic_slam_tpu_torch.ops import neighbors

    tgt = np.c_[rng.uniform(-5, 5, (2048, 2)),
                rng.normal(0, 0.01, 2048)].astype(np.float32)
    tgt[:700, 2] += 2.0 * tgt[:700, 0]           # a second, tilted plane
    src = (tgt[:1024] + [0.05, -0.03, 0.02]).astype(np.float32)
    sv, tv = np.ones(1024, bool), np.ones(2048, bool)
    cov_s = jgicp.plane_covariances(jnp.asarray(src), jnp.asarray(sv), 8)[0]
    cov_t = jgicp.plane_covariances(jnp.asarray(tgt), jnp.asarray(tv), 8)[0]
    cfg = jgicp.GicpConfig(max_corr_dist=0.5)
    jg, tg = _both_grids(tgt, tv, 1.0)
    want = jgicp.gicp_align(jnp.asarray(src), jnp.asarray(sv), cov_s,
                            jnp.asarray(tgt), cov_t, cfg, target_grid=jg)

    def refuse(*a, **k):
        raise AssertionError("kernel A's search reached with a grid")

    monkeypatch.setattr(neighbors, "nn1", refuse)
    from noetic_slam_tpu_torch.config import GicpConfig
    got = tgicp.gicp_align(to_torch(src), to_torch(sv), to_torch(cov_s),
                           to_torch(tgt), to_torch(cov_t),
                           GicpConfig(max_corr_dist=0.5), target_grid=tg)
    close(got.T, want.T, rtol=0, atol=2e-4)
    assert bool(got.converged) == bool(want.converged)


# ---------------------------------------------------------------------------
# The odometry step with the grid engine
# ---------------------------------------------------------------------------

N_SAVE, N_END = 5, 7      # the checkpoint is taken before scan N_SAVE


def _cfg(cov_engine="radius"):
    cfg = DlioConfig(
        capacity=CapacityConfig(
            max_points=4096, max_ds_points=2048, max_deskew_frames=1024,
            max_imu_window=64, max_keyframes=32, max_submap_kf=8),
        tsdf=TsdfConfig(max_blocks=256))
    return cfg.replace(gicp=dataclasses.replace(
        cfg.gicp, nn_engine="grid", cov_engine=cov_engine))


class _Feeder:
    """Pushes the IMU samples up to each scan's sweep."""

    def __init__(self, sim, i=0):
        self.sim, self.i = sim, i

    def imu(self, pipe, scan):
        h, _, pt = scan
        s = self.sim
        while (self.i < len(s.imu_stamps)
               and s.imu_stamps[self.i] <= h + pt.max() + 0.02):
            pipe.push_imu(s.imu_stamps[self.i], s.imu_ang[self.i],
                          s.imu_acc[self.i])
            self.i += 1

    def run(self, pipe, scans):
        for scan in scans:
            self.imu(pipe, scan)
            pipe.process_scan(*scan)
        return self


@pytest.fixture(scope="module")
def sim_scans():
    sim = synthetic.make_sim(duration=1.0, n_points=2048, calib_time=3.1,
                             seed=1)
    return sim, [sim.scan(s) for s in range(len(sim.scan_stamps))]


@pytest.fixture(scope="module")
def jax_runs(sim_scans, tmp_path_factory):
    """cov_engine -> the JAX pipeline's run over the scans with the grid
    engine (one compile each): each step's input and the state before
    it, the trajectory, a checkpoint taken before scan N_SAVE with the IMU
    cursor there, and the pipeline itself."""
    sim, scans = sim_scans
    runs = {}

    def get(cov_engine):
        if cov_engine not in runs:
            jpipe = JaxPipeline(jax_cfg(_cfg(cov_engine)))
            feeder = _Feeder(sim)
            path = str(tmp_path_factory.mktemp("grid") / "jax.nst.npz")
            steps, imu_at_save = [], None
            for i, (h, xyz, pt) in enumerate(scans):
                if i == N_SAVE:
                    jckpt.save_pipeline(path, jpipe)
                    imu_at_save = feeder.i
                feeder.imu(jpipe, (h, xyz, pt))
                delta = (0.0 if jpipe.prev_header is None
                         else h - jpipe.prev_header)
                steps.append((jpipe._pack_scan(h, xyz, pt, delta),
                              jax.device_get(jpipe.state)))
                jpipe.process_scan(h, xyz, pt)
            steps.append((None, jax.device_get(jpipe.state)))
            runs[cov_engine] = dict(steps=steps, traj=jpipe.flush(),
                                    path=path, imu_at_save=imu_at_save,
                                    pipe=jpipe)
        return runs[cov_engine]

    return get


@pytest.mark.parametrize("cov_engine", ["radius", "knn"])
def test_grid_registration_step_matches_jax(jax_runs, cov_engine):
    """One step from the same mid-run JAX state (the grid index carried
    across with it): the pose within the one-step tolerance of JAX's step
    from that state, and the grid the step rebuilds equal to JAX's."""
    run = jax_runs(cov_engine)
    k = 5
    packed, st = run["steps"][k]
    js = run["steps"][k + 1][1]
    assert int(st.grid_keys[0]) != np.iinfo(np.int32).max
    syncs = HostSyncs()
    ts, tout = to.make_odometry_step(_cfg(cov_engine), syncs)(
        convert.odom_state_from_numpy(st, "cpu"),
        to.StepInput(*[None if a is None else to_torch(a) for a in packed]))
    assert bool(tout.processed) and int(js.num_scans) == k + 1
    close(ts.lidar_p, js.lidar_p, rtol=0, atol=STEP_POS_TOL)
    close(ts.lidar_q, js.lidar_q, rtol=0, atol=STEP_ROT_TOL)
    # trajectory row k: ..., n_corr (10)
    assert abs(int(tout.num_corr) - int(js.traj[k, 10])) <= 20
    # the same keyframe selection: the same submap point set, so the same
    # sorted grid keys
    np.testing.assert_array_equal(ts.submap_mask.numpy(), js.submap_mask)
    np.testing.assert_array_equal(to_np(ts.grid_keys), js.grid_keys)


@pytest.mark.parametrize("cov_engine", ["radius", "knn"])
def test_grid_replay_matches_jax(sim_scans, jax_runs, cov_engine):
    sim, scans = sim_scans
    jt = jax_runs(cov_engine)["traj"]
    pipe = OdometryPipeline(_cfg(cov_engine), device="cpu")
    _Feeder(sim).run(pipe, scans)
    tt = pipe.flush()
    assert tt.shape == jt.shape == (len(scans), 8)
    np.testing.assert_array_equal(tt[:, 0], jt[:, 0])
    gap = np.linalg.norm(tt[:, 1:4] - jt[:, 1:4], axis=-1)
    assert gap.max() < REPLAY_POS_TOL, gap
    ate = synthetic.ate_rmse(tt[:, 0], tt[:, 1:4], sim.gt_stamps, sim.gt_pos)
    assert ate < 0.05, ate


def test_grid_checkpoint_crosses_both_ways(sim_scans, jax_runs, tmp_path):
    """A checkpoint taken with ``nn_engine="grid"`` carries the grid index:
    JAX's loads into the port with its grid fields bitwise, and the port
    goes on within the step tolerance of JAX's own continuation; the
    port's loads into JAX likewise; the port resumed from its own
    checkpoint repeats its uninterrupted run bitwise."""
    sim, scans = sim_scans
    cfg = _cfg()
    run = jax_runs("radius")
    cont = slice(N_SAVE, N_END)
    # JAX -> port
    pipe = OdometryPipeline(cfg, device="cpu")
    tckpt.load_pipeline(run["path"], pipe)
    with np.load(run["path"]) as data:
        for f in ("grid_xyz", "grid_keys", "grid_order", "grid_origin"):
            np.testing.assert_array_equal(getattr(pipe.state, f).numpy(),
                                          data[f"odom/{f}"], err_msg=f)
        assert data["odom/grid_keys"][0] != np.iinfo(np.int32).max
    _Feeder(sim, run["imu_at_save"]).run(pipe, scans[cont])
    t_cont = pipe.flush()[cont]     # the loaded ring holds the earlier scans
    j_cont = run["traj"][cont]
    np.testing.assert_array_equal(t_cont[:, 0], j_cont[:, 0])
    assert np.abs(t_cont[:, 1:4] - j_cont[:, 1:4]).max() < STEP_POS_TOL

    # port -> JAX (into the compiled pipeline of the JAX run), port -> port
    pipe = OdometryPipeline(cfg, device="cpu")
    feeder = _Feeder(sim).run(pipe, scans[:N_SAVE])
    tpath = str(tmp_path / "port.nst.npz")
    tckpt.save_pipeline(tpath, pipe)
    imu_at_save = feeder.i
    feeder.run(pipe, scans[cont])
    t_cont = pipe.flush()[cont]
    jpipe = run["pipe"]
    jckpt.load_pipeline(tpath, jpipe)
    np.testing.assert_array_equal(np.asarray(jpipe.state.grid_keys),
                                  np.load(tpath)["odom/grid_keys"])
    again = OdometryPipeline(cfg, device="cpu")
    tckpt.load_pipeline(tpath, again)
    for p in (jpipe, again):
        _Feeder(sim, imu_at_save).run(p, scans[cont])
    j_cont, t_again = jpipe.flush()[cont], again.flush()[cont]
    assert np.abs(j_cont[:, 1:4] - t_cont[:, 1:4]).max() < STEP_POS_TOL
    np.testing.assert_array_equal(t_again, t_cont)


def test_cli_slam_with_a_grid_config(tmp_path):
    """``cli slam --config`` with ``nn_engine: grid`` runs the grid engine
    through the command line on the CPU (it raised before the engine was
    ported)."""
    import contextlib
    import io
    import os

    from noetic_slam_tpu_torch import cli

    cfg = tmp_path / "grid.yaml"
    cfg.write_text("gicp:\n  nn_engine: grid\n"
                   "capacity:\n  max_ds_points: 2048\n  max_submap_kf: 8\n")
    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "mulran_mini")
    out = tmp_path / "out"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["slam", "--config", str(cfg), "--mulran", fixture,
                       "--max-scans", "8", "--out", str(out),
                       "--device", "cpu"])
    assert rc == 0
    traj = np.loadtxt(out / "trajectory.tum")
    assert traj.shape == (8, 8) and np.isfinite(traj).all()
