"""The port's sharded paths (``parallel/{mesh,registration,
bundle_adjustment,tsdf}``) on 2 and 4 gloo ranks on the CPU, held in the
parent process to the JAX package (tests/test_parallel.py's cases, on
conftest's 8-device CPU mesh where JAX runs sharded) and to the port's own
one-process functions.

One ``launch`` per world size runs every path (``torch_parallel_ranks``,
which imports no JAX); the parent imports JAX lazily."""

import numpy as np
import pytest
import torch

from noetic_slam_tpu_torch import convert
from noetic_slam_tpu_torch.config import (
    CapacityConfig,
    DlioConfig,
    GicpConfig,
    TsdfConfig,
)
from noetic_slam_tpu_torch.models import posegraph as tpg
from noetic_slam_tpu_torch.models import tsdf as ttsdf
from noetic_slam_tpu_torch.parallel import mesh as pmesh
from noetic_slam_tpu_torch.parallel.registration import (
    collective_traffic_per_align,
)
from noetic_slam_tpu_torch.utils import synthetic as tsyn
from tests import torch_parallel_ranks as ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
T_ATOL = 2e-4            # tests/test_parallel.py:36
BA_ATOL = 1e-3           # [m]
DOT_ATOL = 1e-5
STEP_POS_TOL = 0.02      # [m] per registration step (ROADMAP)
TSDF_CASES = {
    "tsdf": (dict(voxel_size=0.1, truncation=0.3, max_blocks=4096,
                  space_carving=False, max_range=30.0), 2),
    # 72 blocks in all: more than a shard's share of 256 at D = 4 (64),
    # where the reference's shards drop blocks
    "tsdf_small": (dict(voxel_size=0.1, truncation=0.3, max_blocks=256,
                        space_carving=False, max_range=30.0), 2),
}


def _odometry_cfg():
    return DlioConfig(capacity=CapacityConfig(
        max_points=2048, max_ds_points=1024, max_deskew_frames=512,
        max_imu_window=64, max_keyframes=16, max_submap_kf=4))


@pytest.fixture(scope="module")
def inputs():
    import jax
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from noetic_slam_tpu.models import posegraph as pg
    from noetic_slam_tpu.ops import gicp as jg
    from tests.test_gicp import _surface_cloud
    from tests.test_posegraph import _circle_graph

    rng = np.random.default_rng(0)
    # GICP (tests/test_parallel.py:20-43)
    tgt = _surface_cloud(rng, n=1536)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, :3] = Rotation.from_rotvec([0.015, -0.02, 0.03]).as_matrix()
    T_true[:3, 3] = [0.1, -0.07, 0.05]
    inv = np.linalg.inv(T_true)
    src = (tgt @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)[:1024]
    sv, tv = np.ones(1024, bool), np.ones(1536, bool)
    align = dict(
        src=src, sv=sv, tgt=tgt, tv=tv, T_true=T_true,
        src_cov=np.asarray(jg.plane_covariances(jnp.asarray(src),
                                                jnp.asarray(sv), k=8)[0]),
        tgt_cov=np.asarray(jg.plane_covariances(jnp.asarray(tgt),
                                                jnp.asarray(tv), k=8)[0]),
        gicp=dict(max_corr_dist=1.0))

    # pose graphs (:46-107)
    gt_q, gt_p, est_q, est_p, edges = _circle_graph(rng=rng)
    g = pg.init_graph(16, 32)
    for k in range(len(gt_q)):
        g = pg.add_node(g, jnp.asarray(est_q[k], jnp.float32),
                        jnp.asarray(est_p[k], jnp.float32))
    for (i, j, dq, dp) in edges:
        g = pg.add_edge(g, jnp.int32(i), jnp.int32(j),
                        jnp.asarray(dq, jnp.float32),
                        jnp.asarray(dp, jnp.float32))
    K, E = 1200, 2048
    th = np.linspace(0, 4 * np.pi, K).astype(np.float32)
    gt_p = np.stack([30 * np.cos(th), 30 * np.sin(th),
                     0.1 * th], -1).astype(np.float32)
    est_p = gt_p + rng.normal(scale=0.15, size=(K, 3)).astype(np.float32)
    qs = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (K, 1))
    big = pg.init_graph(K, E)
    big = pg.add_nodes_chain(big, qs, est_p, K)
    for (i, j) in [(0, 600), (100, 700), (200, 800), (50, 1150)]:
        dq, dp = pg.relative_pose(jnp.asarray(qs[i]), jnp.asarray(gt_p[i]),
                                  jnp.asarray(qs[j]), jnp.asarray(gt_p[j]))
        big = pg.add_edge(big, jnp.int32(i), jnp.int32(j), dq, dp,
                          w_rot=2.0, w_trans=2.0)

    # TSDF (:144-176)
    pts = np.c_[np.full(2000, 5.0), rng.uniform(-2, 2, 2000),
                rng.uniform(-2, 2, 2000)].astype(np.float32)

    # the odometry step (scripts/multihost_sim.py's step 1)
    sim = tsyn.make_sim(duration=0.4, n_points=2048, calib_time=3.1,
                        seed=3)
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    return dict(
        align=align,
        ba_dense=jax.device_get(g)._asdict(),
        ba_cg=jax.device_get(big)._asdict(),
        tsdf=TSDF_CASES, tsdf_pts=pts,
        odometry=dict(cfg=_odometry_cfg(), scans=scans,
                      imu=(sim.imu_stamps, sim.imu_ang, sim.imu_acc)))


@pytest.fixture(scope="module")
def launched(inputs):
    """world size -> every rank's results (one launch each)."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = pmesh.launch(ranks.rank_work, world, inputs,
                                        timeout=300)
        return cache[world]

    return get


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gicp_matches_jax(inputs, launched, world):
    """Every rank's transform is the same, within T_ATOL of JAX's sharded
    and one-device alignments, and recovers the true transform."""
    import jax.numpy as jnp

    from noetic_slam_tpu.config.params import GicpConfig as JGicpConfig
    from noetic_slam_tpu.ops import gicp as jg
    from noetic_slam_tpu.parallel.mesh import make_mesh
    from noetic_slam_tpu.parallel.registration import sharded_gicp_align

    a = inputs["align"]
    args = [jnp.asarray(a[k]) for k in ("src", "sv", "src_cov", "tgt",
                                        "tgt_cov")]
    cfg = JGicpConfig(**a["gicp"])
    one = np.asarray(jg.gicp_align(*args, cfg).T)
    sharded = np.asarray(sharded_gicp_align(make_mesh(world), *args, cfg).T)
    outs = launched(world)
    got = outs[0]["align"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["align"]["T"], got["T"])
    assert got["converged"]
    np.testing.assert_allclose(got["T"], one, atol=T_ATOL)
    np.testing.assert_allclose(got["T"], sharded, atol=T_ATOL)
    resid = np.linalg.inv(a["T_true"]) @ got["T"]
    assert np.abs(resid[:3, 3]).max() < 2e-2


@pytest.mark.parametrize("world", WORLDS)
def test_collective_bytes_match_the_traffic_model(inputs, launched, world):
    """The bytes each rank hands to ``all_reduce`` per align are the
    model's per-relinearize elements (4 B each) times the outer
    iterations: four all-reduces per iteration, none an all-gather."""
    a = inputs["align"]
    nq = a["src"].shape[0]
    for o in launched(world):
        r = o["align"]
        model = collective_traffic_per_align(GicpConfig(**a["gicp"]), nq,
                                             world, r["iters"])
        assert r["calls"] == 4 * r["iters"]
        assert r["bytes"] == (r["iters"]
                              * model["per_relinearize_reduce_elements"] * 4)
        ring = 2.0 * (world - 1) / world
        assert int(ring * r["bytes"]) <= model["per_align_recv_bytes_max"]


def _poses_close(got, g_ref):
    np.testing.assert_allclose(got["node_p"], np.asarray(g_ref.node_p),
                               atol=BA_ATOL)
    dots = np.abs(np.sum(got["node_q"] * np.asarray(g_ref.node_q), -1))
    np.testing.assert_allclose(dots, 1.0, atol=DOT_ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["ba_dense", "ba_cg"])
def test_sharded_posegraph_matches_single_device(inputs, launched, world,
                                                 case):
    """Dense on the 16-node circle, CG on the 1,200-node chain: against
    JAX's one-device solve and the port's, every rank the same graph, and
    the CG solve cuts the graph's cost."""
    import jax.numpy as jnp

    from noetic_slam_tpu.models import posegraph as pg

    kw = (dict(iters=10, method="dense") if case == "ba_dense"
          else dict(iters=3, method="cg", cg_iters=60))
    jgraph = pg.PoseGraph(**{k: jnp.asarray(v)
                             for k, v in inputs[case].items()})
    ref = pg.optimize(jgraph, **kw)
    g = convert.posegraph_from_numpy(inputs[case], "cpu")
    mine = tpg.optimize(g, **kw)
    outs = launched(world)
    for o in outs[1:]:
        for f in ("node_q", "node_p"):
            np.testing.assert_array_equal(o[case][f], outs[0][case][f])
    _poses_close(outs[0][case], ref)
    _poses_close(outs[0][case], mine)
    if case == "ba_cg":
        after = g._replace(node_q=torch.from_numpy(outs[0][case]["node_q"]),
                           node_p=torch.from_numpy(outs[0][case]["node_p"]))
        assert float(tpg.graph_cost(after)) < 0.5 * float(tpg.graph_cost(g))


def _surface_set(cfg, state):
    c, _, m = ttsdf.extract_surface(cfg, state)
    return {tuple(np.round(r, 4)) for r in c.numpy()[m.numpy()]}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(TSDF_CASES))
def test_sharded_tsdf_matches_single_device(inputs, launched, world, case):
    """The gathered map against JAX's sharded map on ``make_mesh(world)``:
    the same counters, directory keys and slots, and a surface voxel set
    that is a subset of JAX's; every rank gathers the same state and holds
    its share of the blocks. Where the capacity does not bind, also the
    one-device maps' block count, and the port's one-device surface set.

    Against JAX's surface: JAX's extra voxels form one layer in front of
    the plane. The plane x = 5 lies on a voxel face, where the sample
    0.1 m in front of a hit falls on either side of x = 4.9 by an ulp (the
    packages' sample arithmetic rounds differently), so JAX observes the
    voxels centred at x = 4.95 and the port does not.

    At 256 blocks on 4 ranks the capacity binds in both packages: a shard
    allocates from the global count, so once the map holds 64 blocks in
    all, the second fusion clamps every shard's count to its 64 slots and
    counts the difference as dropped, so the map counts fewer blocks than
    it holds."""
    import jax.numpy as jnp

    from noetic_slam_tpu.config.params import TsdfConfig as JTsdfConfig
    from noetic_slam_tpu.models import tsdf as jt
    from noetic_slam_tpu.parallel import tsdf as jpt
    from noetic_slam_tpu.parallel.mesh import make_mesh

    cfg_kw, n_int = TSDF_CASES[case]
    pts = inputs["tsdf_pts"]
    jcfg = JTsdfConfig(**cfg_kw)
    jpts, jvalid = jnp.asarray(pts), jnp.ones((len(pts),), bool)
    ref = jt.init_tsdf(jcfg)
    mesh = make_mesh(world)
    jst = jpt.init_sharded_tsdf(jcfg, mesh)
    integ = jpt.make_sharded_integrate(jcfg, mesh)
    for _ in range(n_int):
        ref = jt.integrate(jcfg, ref, jpts, jvalid, jnp.zeros(3))
        jst = integ(jst, jpts, jvalid, jnp.zeros(3))
    jm = jpt.gather_sharded_state(jcfg, jst, mesh)

    def jax_set(state):
        c, _, m = jt.extract_surface(jcfg, state)
        return {tuple(np.round(r, 4)) for r in np.asarray(c)[np.asarray(m)]}

    outs = launched(world)
    r0 = outs[0][case]
    for o in outs[1:]:
        for k, v in o[case]["merged"].items():
            np.testing.assert_array_equal(v, r0["merged"][k], err_msg=k)
        assert o[case]["counts"] == r0["counts"]
    merged = ttsdf.TsdfState(**{k: torch.from_numpy(np.asarray(v))
                                for k, v in r0["merged"].items()})
    assert r0["counts"] == (int(jm.num_blocks), int(jm.dropped))
    for f in ("dir_keys", "dir_slots"):
        np.testing.assert_array_equal(r0["merged"][f],
                                      np.asarray(getattr(jm, f)), err_msg=f)
    held = int((np.asarray(jm.dir_keys) != ttsdf.KEY_PAD).sum())
    assert sum(o[case]["held"] for o in outs) == held > 0
    got = _surface_set(TsdfConfig(**cfg_kw), merged)
    sharded_set = jax_set(jm)
    assert len(got) > 200 and got <= sharded_set
    assert len({v[0] for v in sharded_set - got}) <= 1      # one x layer
    if (case, world) == ("tsdf_small", 4):
        assert int(jm.dropped) > 0 and int(jm.num_blocks) < held
        return
    assert int(jm.dropped) == 0
    cfg = TsdfConfig(**cfg_kw)
    one = ttsdf.init_tsdf(cfg, "cpu")
    for _ in range(n_int):
        one = ttsdf.integrate(cfg, one, torch.from_numpy(pts),
                              torch.ones(len(pts), dtype=torch.bool),
                              torch.zeros(3))
    assert held == int(merged.num_blocks) == int(ref.num_blocks) == int(
        one.num_blocks)
    assert got == _surface_set(cfg, one) and len(got) > 500
    assert sharded_set == jax_set(ref)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_odometry_steps_agree(inputs, launched, world):
    """The pipeline with ``make_sharded_align`` (scripts/multihost_sim.py's
    step 1: bootstrap, then registration steps) on every rank: every
    rank's trajectory and host reads are rank 0's bitwise, and each step
    is within the step tolerance of the one-process step from the same
    state. (Free-running, this 1,024-point sequence is ill-conditioned:
    the one-process port and JAX end up to 1 cm apart on it.)"""
    odo = inputs["odometry"]
    outs = launched(world)
    got = outs[0]["odometry"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["odometry"]["traj"], got["traj"])
        assert o["odometry"]["syncs"] == got["syncs"]
        assert o["odometry"]["gaps"] == got["gaps"]
    assert got["traj"].shape == (len(odo["scans"]), 8)
    assert len(got["gaps"]) == len(odo["scans"]) >= 3
    assert max(got["gaps"]) < STEP_POS_TOL, got["gaps"]
    assert got["gaps"][0] == 0.0            # the bootstrap registers nothing
    # every registration reads its loop exit on the host at least once
    assert got["syncs"] >= 3 * (len(odo["scans"]) - 1)


def test_mesh_2d_sums_over_both_axes(launched):
    """A 2 x 2 ("batch", "map") mesh on 4 ranks, batch outer: a SUM over
    "map" then "batch" is the sum of every rank (scripts/multihost_sim.py's
    step 3)."""
    for o in launched(4):
        r = o["rank"]
        assert o["mesh2"]["index"] == (r // 2, r % 2)
        assert o["mesh2"]["both"] == 0 + 1 + 2 + 3
        assert o["mesh2"]["map"] == sum(range(2 * (r // 2),
                                              2 * (r // 2) + 2))


def test_launch_fails_when_a_rank_raises():
    """The launch raises at once: rank 1's error, or rank 0's collective
    broken by it (whichever the launch sees first), well inside the
    timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails|Connection"):
        pmesh.launch(ranks.raise_on_rank_one, 2, timeout=60)
    assert time.monotonic() - t0 < 30


def test_launch_times_out_a_hung_rank():
    """A collective one rank never joins ends the launch with an error
    within its timeout, and no rank is left running."""
    with pytest.raises(TimeoutError):
        pmesh.launch(ranks.hang_on_rank_zero, 2, timeout=8)
