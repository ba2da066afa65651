"""The pose graph and the neighbour search it needs: the JAX functions and
their ports on the same numpy inputs (``models/posegraph.py``,
``ops/neighbors.knn``, ``ops/gicp.plane_covariances``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from noetic_slam_tpu.config import params as jparams
from noetic_slam_tpu.models import posegraph as jpg
from noetic_slam_tpu.ops import gicp as jgicp
from noetic_slam_tpu.ops import neighbors as jnb
from noetic_slam_tpu_torch import convert
from noetic_slam_tpu_torch.config import GicpConfig
from noetic_slam_tpu_torch.models import posegraph as pg
from noetic_slam_tpu_torch.ops import gicp
from noetic_slam_tpu_torch.ops import neighbors
from tests import reference_math as ref
from tests.test_loop_verification import make_cloud
from tests.torch_parity import close, jax_cfg, to_np, to_torch

torch.set_num_threads(1)
CPU = "cpu"

# Solver tolerances against JAX (f32 on both sides, other LU / reduction
# orders): dense node poses within 1e-4 m / 1e-4 rad, CG within 1e-3.
DENSE_TOL, CG_TOL = 1e-4, 1e-3


def _quat(R):
    q = Rotation.from_matrix(R).as_quat()
    return np.array([q[3], q[0], q[1], q[2]])


def _noisy_chain(rng, n=30, per_lap=24, loops=((24, 0), (27, 3), (29, 5))):
    """30 nodes on a rising circle (24 a lap): odometry edges measured with
    noise, loop edges exact between nodes a lap apart (same heading, as a
    SLAM closure is), node estimates integrated from the noisy odometry
    (so they drift). Gauss-Newton converges on it in a few steps."""
    gt_q, gt_p = [], []
    for k in range(n):
        ang = 2 * np.pi * k / per_lap
        gt_q.append(_quat(Rotation.from_rotvec([0, 0, ang]).as_matrix()))
        gt_p.append(np.array([6 * np.cos(ang), 6 * np.sin(ang), 0.3 * k / n]))
    gt_q, gt_p = np.stack(gt_q), np.stack(gt_p)
    conj = np.array([1, -1, -1, -1])

    def rel(i, j):
        return (ref.quat_mul(gt_q[i] * conj, gt_q[j]),
                ref.quat_rotate(gt_q[i] * conj, gt_p[j] - gt_p[i]))

    edges, est_q, est_p = [], [gt_q[0]], [gt_p[0]]
    for k in range(n - 1):
        dq, dp = rel(k, k + 1)
        dq = ref.quat_mul(dq, _quat(Rotation.from_rotvec(
            rng.normal(scale=0.005, size=3)).as_matrix()))
        dp = dp + rng.normal(scale=0.03, size=3)
        edges.append((k, k + 1, dq, dp))
        q = ref.quat_mul(est_q[-1], dq)
        est_p.append(est_p[-1] + ref.quat_rotate(est_q[-1], dp))
        est_q.append(q / np.linalg.norm(q))
    for i, j in loops:
        edges.append((i, j) + rel(i, j))
    f = lambda a: np.asarray(a, np.float32)            # noqa: E731
    return f(est_q), f(est_p), [(i, j, f(dq), f(dp)) for i, j, dq, dp in edges]


def _graphs(est_q, est_p, edges, K=32, E=64):
    """The same graph built by add_node/add_edge in both packages."""
    jg, tg = jpg.init_graph(K, E), pg.init_graph(K, E, device=CPU)
    for q, p in zip(est_q, est_p):
        jg = jpg.add_node(jg, jnp.asarray(q), jnp.asarray(p))
        tg = pg.add_node(tg, to_torch(q), to_torch(p))
    for i, j, dq, dp in edges:
        jg = jpg.add_edge(jg, jnp.int32(i), jnp.int32(j), jnp.asarray(dq),
                          jnp.asarray(dp), w_rot=2.0 if j < i - 1 else 1.0)
        tg = pg.add_edge(tg, i, j, to_torch(dq), to_torch(dp),
                         w_rot=2.0 if j < i - 1 else 1.0)
    return jg, tg


def _graph_equal(tg, jg, atol=0.0):
    for f in pg.PoseGraph._fields:
        a, b = to_np(getattr(tg, f)), np.asarray(getattr(jg, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _pose_gap(tg, jg, n):
    """(largest position gap [m], largest rotation gap [rad]) of the first
    n nodes; the angle of q_t^-1 q_j in float64."""
    dp = np.abs(to_np(tg.node_p)[:n] - np.asarray(jg.node_p)[:n]).max()
    a = to_np(tg.node_q)[:n].astype(np.float64)
    b = np.asarray(jg.node_q)[:n].astype(np.float64)
    d = np.stack([ref.quat_mul(x * [1, -1, -1, -1], y) for x, y in zip(a, b)])
    ang = 2 * np.arctan2(np.linalg.norm(d[:, 1:], axis=-1), np.abs(d[:, 0]))
    return dp, float(ang.max())


# ---------------------------------------------------------------- neighbours

@pytest.mark.parametrize("n,k,sentinels", [(700, 16, 0), (1300, 8, 40)])
def test_knn_matches_jax(n, k, sentinels):
    """Distance sets equal to 1e-6 m^2 plus 1e-6 relative (a few f32 ulps
    of the recomputed sum of squares, which XLA and torch add in other
    orders); ties may pick other indices."""
    rng = np.random.default_rng(n)
    x = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    x[rng.choice(n, sentinels, replace=False)] = 1e6
    ji, jd = jnb.knn(jnp.asarray(x), jnp.asarray(x), k)
    ti, td = neighbors.knn(to_torch(x), to_torch(x), k, query_chunk=256,
                           target_chunk=512)
    ok = np.abs(x).max(-1) < 1e5
    np.testing.assert_allclose(to_np(td)[ok], np.asarray(jd)[ok], rtol=1e-6,
                               atol=1e-6)
    # idx sorted ascending and self first (distance 0)
    assert np.all(to_np(ti)[ok, 0] == np.flatnonzero(ok))
    assert np.all(np.diff(to_np(td)[ok], axis=-1) >= 0)


def test_plane_covariances_matches_jax():
    """Before registration, ~1e-4 (ROADMAP 'Parity tolerances')."""
    x = make_cloud("corner", seed=3)
    valid = np.ones(x.shape[0], bool)
    valid[::17] = False
    jc, jd = jgicp.plane_covariances(jnp.asarray(x), jnp.asarray(valid), 16)
    tc, td = gicp.plane_covariances(to_torch(x), to_torch(valid), 16)
    close(tc, jc, rtol=0, atol=1e-4)
    close(td, jd, rtol=1e-4, atol=1e-7)


def test_sym3_min_eig_matches_float64():
    """The closed-form smallest eigenvalue against LAPACK in float64, on
    random SPD matrices at GICP's scales, with repeated eigenvalues."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(200, 3, 3))
    m = A @ A.transpose(0, 2, 1) * rng.uniform(0.1, 100, (200, 1, 1))
    m[:20] = np.eye(3) * rng.uniform(1, 50, (20, 1, 1))      # isotropic
    m = m.astype(np.float32)
    want = np.linalg.eigvalsh(m.astype(np.float64))[:, 0]
    got = to_np(gicp.sym3_min_eig(to_torch(m))[0])
    scale = np.abs(np.linalg.eigvalsh(m.astype(np.float64))).max(-1)
    assert np.all(np.abs(got - want) <= 2e-5 * scale + 1e-6)


# ---------------------------------------------------------------- the graph

def test_graph_building_matches_jax():
    est_q, est_p, edges = _noisy_chain(np.random.default_rng(0))
    jg, tg = _graphs(est_q, est_p, edges)
    _graph_equal(tg, jg)
    close(pg.graph_cost(tg), jpg.graph_cost(jg), rtol=1e-5, atol=1e-6)
    g2 = convert.posegraph_from_numpy(jg, CPU)
    _graph_equal(g2, jg)
    assert convert.posegraph_to_numpy(tg).keys() == set(pg.PoseGraph._fields)


@pytest.mark.parametrize("method,iters,tol", [("dense", 6, DENSE_TOL),
                                              ("cg", 6, CG_TOL)])
def test_optimize_matches_jax(method, iters, tol):
    est_q, est_p, edges = _noisy_chain(np.random.default_rng(1))
    jg, tg = _graphs(est_q, est_p, edges)
    jo = jpg.optimize(jg, iters=iters, method=method, cg_iters=60)
    to = pg.optimize(tg, iters=iters, method=method, cg_iters=60)
    dp, dr = _pose_gap(to, jo, len(est_q))
    assert dp < tol and dr < tol, (dp, dr)
    # and it did optimise: the cost fell by orders of magnitude
    assert float(pg.graph_cost(to)) < 1e-1 * float(pg.graph_cost(tg))


def test_optimize_k_static_matches_jax():
    """A grown-capacity graph solved over its first k_static slots."""
    est_q, est_p, edges = _noisy_chain(np.random.default_rng(2))
    jg, tg = _graphs(est_q, est_p, edges, K=128, E=128)
    jo = jpg.optimize(jg, iters=3, method="dense", k_static=64)
    to = pg.optimize(tg, iters=3, method="dense", k_static=64)
    dp, dr = _pose_gap(to, jo, len(est_q))
    assert dp < DENSE_TOL and dr < DENSE_TOL, (dp, dr)
    np.testing.assert_array_equal(to_np(to.node_p)[64:],
                                  to_np(tg.node_p)[64:])


@pytest.mark.parametrize("have_prev,count", [(False, 1), (False, 5),
                                             (True, 3), (True, 5)])
def test_add_nodes_chain_matches_jax(have_prev, count):
    rng = np.random.default_rng(count)
    qs = Rotation.random(count, random_state=count).as_quat()[
        :, [3, 0, 1, 2]].astype(np.float32)
    ps = rng.normal(scale=3.0, size=(count, 3)).astype(np.float32)
    prev_q = np.asarray([0.9, 0.1, -0.3, 0.2], np.float32)
    prev_q /= np.linalg.norm(prev_q)
    prev_p = np.asarray([1.0, -2.0, 0.5], np.float32)
    jg, tg = jpg.init_graph(16, 16), pg.init_graph(16, 16, device=CPU)
    if have_prev:
        jg = jpg.add_node(jg, jnp.asarray(prev_q), jnp.asarray(prev_p))
        tg = pg.add_node(tg, to_torch(prev_q), to_torch(prev_p))
    kw = dict(prev_q=prev_q, prev_p=prev_p) if have_prev else {}
    eager = tg
    jg = jpg.add_nodes_chain(jg, qs, ps, count, **kw)
    tg = pg.add_nodes_chain(tg, qs, ps, count, **kw)
    _graph_equal(tg, jg, atol=1e-6)
    # and the port's chain equals its own eager node/edge adds
    last = (prev_q, prev_p) if have_prev else None
    for q, p in zip(qs, ps):
        if last is not None:
            dq, dp = pg.relative_pose(to_torch(last[0]), to_torch(last[1]),
                                      to_torch(q), to_torch(p))
            eager = pg.add_edge(eager, eager.n_nodes - 1, eager.n_nodes, dq,
                                dp)
        eager = pg.add_node(eager, to_torch(q), to_torch(p))
        last = (q, p)
    for f in pg.PoseGraph._fields:
        close(getattr(tg, f), getattr(eager, f), rtol=0, atol=1e-6)


def test_add_nodes_chain_saturates_like_jax():
    qs = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (6, 1))
    ps = np.arange(18, dtype=np.float32).reshape(6, 3)
    jg = jpg.add_nodes_chain(jpg.init_graph(4, 4), qs, ps, 6)
    tg = pg.add_nodes_chain(pg.init_graph(4, 4, device=CPU), qs, ps, 6)
    _graph_equal(tg, jg, atol=1e-6)
    assert int(tg.n_nodes) == 4 and int(tg.n_edges) <= 4


def test_grow_matches_jax():
    est_q, est_p, edges = _noisy_chain(np.random.default_rng(3))
    jg, tg = _graphs(est_q, est_p, edges)
    _graph_equal(pg.grow(tg, max_nodes=64, max_edges=200),
                 jpg.grow(jg, max_nodes=64, max_edges=200))
    assert pg.grow(tg, max_nodes=8) is tg


def test_detect_loop_candidate_matches_jax():
    rng = np.random.default_rng(4)
    for trial in range(10):
        K = int(rng.integers(4, 24))
        kf_pos = rng.normal(scale=8.0, size=(K, 3)).astype(np.float32)
        kf_count = int(rng.integers(1, K + 1))
        kf_seq = np.zeros((K,), np.int32)
        order = rng.permutation(K)[:kf_count]
        kf_seq[order] = np.arange(1, kf_count + 1)
        cur = int(order[-1])
        radius, gap = float(rng.uniform(1, 12)), int(rng.integers(1, 6))
        jb, jok = jpg.detect_loop_candidate(
            jnp.asarray(kf_pos), jnp.int32(kf_count), jnp.int32(cur),
            radius, gap, kf_seq=jnp.asarray(kf_seq))
        tb, tok = pg.detect_loop_candidate(
            to_torch(kf_pos), torch.tensor(kf_count), cur, radius, gap,
            kf_seq=to_torch(kf_seq))
        nb, nok = pg.detect_loop_candidate_np(kf_pos, kf_seq, kf_count, cur,
                                              radius, gap)
        assert bool(tok) == bool(jok) == nok, trial
        if nok:
            assert int(tb) == int(jb) == nb, trial
        jb, jok = jpg.detect_loop_candidate(
            jnp.asarray(kf_pos), jnp.int32(kf_count), jnp.int32(cur),
            radius, gap)
        tb, tok = pg.detect_loop_candidate(to_torch(kf_pos),
                                           torch.tensor(kf_count), cur,
                                           radius, gap)
        assert bool(tok) == bool(jok) and int(tb) == int(jb), trial


def test_apply_pose_update_matches_jax():
    rng = np.random.default_rng(6)
    K, N = 6, 40
    kf_q = Rotation.random(K, random_state=6).as_quat()[
        :, [3, 0, 1, 2]].astype(np.float32)
    kf_p = rng.normal(scale=20, size=(K, 3)).astype(np.float32)
    kf_xyz = (kf_p[:, None] + rng.normal(scale=5, size=(K, N, 3))
              ).astype(np.float32)
    kf_valid = rng.random((K, N)) > 0.2
    kf_cov = np.tile(np.array([1, 0.1, 0, 1, 0.2, 1e-3], np.float32),
                     (K, N, 1))
    new_q = Rotation.random(K, random_state=7).as_quat()[
        :, [3, 0, 1, 2]].astype(np.float32)
    new_p = (kf_p + rng.normal(scale=0.5, size=(K, 3))).astype(np.float32)
    args = (kf_q, kf_p, kf_xyz, kf_valid, kf_cov, new_q, new_p)
    jout = jpg.apply_pose_update(*map(jnp.asarray, args), jnp.int32(4))
    tout = pg.apply_pose_update(*map(to_torch, args), torch.tensor(4))
    for a, b in zip(tout, jout):
        close(a, b, rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(to_np(tout[2])[4:], kf_xyz[4:])


# ---------------------------------------------------------- loop verification

def _verify_both(src, tgt):
    vcfg = GicpConfig()
    sv = np.ones(src.shape[0], bool)
    tv = np.ones(tgt.shape[0], bool)
    jsc, _ = jgicp.plane_covariances(jnp.asarray(src), jnp.asarray(sv), 16)
    jtc, _ = jgicp.plane_covariances(jnp.asarray(tgt), jnp.asarray(tv), 16)
    jT, jok = jpg.verify_loop(jnp.asarray(src), jnp.asarray(sv), jsc,
                              jnp.asarray(tgt), jtc, jax_cfg(vcfg),
                              max_corr_dist=2 * vcfg.max_corr_dist)
    tsc, _ = gicp.plane_covariances(to_torch(src), to_torch(sv), 16)
    ttc, _ = gicp.plane_covariances(to_torch(tgt), to_torch(tv), 16)
    tT, tok = pg.verify_loop(to_torch(src), to_torch(sv), tsc, to_torch(tgt),
                             ttc, vcfg, max_corr_dist=2 * vcfg.max_corr_dist)
    return to_np(tT), bool(tok), np.asarray(jT), bool(jok)


@pytest.mark.parametrize("case,want", [
    (("corner", 2, "corner", 3, (0.15, -0.1, 0.05)), True),
    (("corridor", 4, "corridor", 5, (0.1, 0.05, 0.0)), False),
    (("corridor", 6, "corridor", 7, (4.0, 0.0, 0.0)), False),
    (("corner", 8, "clutter", 9, (1.0, 2.0, 0.0)), False),
])
def test_verify_loop_matches_jax(case, want):
    """tests/test_loop_verification.py's true match, corridor, alias and
    clutter: the same verdicts; T within 2 cm of JAX's."""
    ks, ss, kt, st, off = case
    src = make_cloud(ks, seed=ss)
    tgt = make_cloud(kt, offset=np.asarray(off), seed=st)
    tT, tok, jT, jok = _verify_both(src, tgt)
    assert tok == jok == want
    np.testing.assert_allclose(tT[:3, 3], jT[:3, 3], atol=0.02)
    np.testing.assert_allclose(tT[:3, :3], jT[:3, :3], atol=0.02)


def test_verify_loop_takes_a_guess():
    """A descriptor-seeded attempt: the guess moves the source onto the
    target from outside the correspondence radius."""
    src = make_cloud("corner", seed=2)
    tgt = make_cloud("corner", offset=np.array([1.5, 0.0, 0.0]), seed=3)
    guess = np.eye(4, dtype=np.float32)
    guess[0, 3] = 1.4
    vcfg = GicpConfig()
    sv = to_torch(np.ones(src.shape[0], bool))
    sc, _ = gicp.plane_covariances(to_torch(src), sv, 16)
    tc, _ = gicp.plane_covariances(to_torch(tgt), sv, 16)
    T, ok = pg.verify_loop(to_torch(src), sv, sc, to_torch(tgt), tc, vcfg,
                           max_corr_dist=2 * vcfg.max_corr_dist, guess=guess)
    assert bool(ok)
    np.testing.assert_allclose(to_np(T)[:3, 3], [1.5, 0, 0], atol=0.03)
    assert jparams.GicpConfig().max_corr_dist == vcfg.max_corr_dist
