"""Parity of the port's op modules with the JAX package, on the CPU:
``utils.geometry``, ``ops.pointcloud``, ``ops.deskew``, ``ops.imu`` and
``ops.gicp``. Inputs come from a numpy seed and go through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noetic_slam_tpu.ops import deskew as jdk
from noetic_slam_tpu.ops import gicp as jg
from noetic_slam_tpu.ops import imu as jimu
from noetic_slam_tpu.ops import pointcloud as jpc
from noetic_slam_tpu.utils import geometry as jgeo
from noetic_slam_tpu_torch.config import GicpConfig
from noetic_slam_tpu_torch.ops import deskew as tdk
from noetic_slam_tpu_torch.ops import gicp as tg
from noetic_slam_tpu_torch.ops import imu as timu
from noetic_slam_tpu_torch.ops import pointcloud as tpc
from noetic_slam_tpu_torch.utils import geometry as tgeo
from tests.torch_parity import close, jax_cfg, to_np, to_torch

torch.set_num_threads(1)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rot(rng):
    return np.asarray(jgeo.quat_to_mat(jnp.asarray(_quats(rng, 1)[0])))


# ---------------------------------------------------------------- geometry

GEOMETRY_CASES = {
    "quat_mul": lambda m, a, b, v, w: m.quat_mul(a, b),
    "quat_conj": lambda m, a, b, v, w: m.quat_conj(a),
    "quat_rotate": lambda m, a, b, v, w: m.quat_rotate(a, v),
    "quat_step": lambda m, a, b, v, w: m.quat_step(a, w, 0.01),
    "quat_to_mat": lambda m, a, b, v, w: m.quat_to_mat(a),
    "mat_to_quat": lambda m, a, b, v, w: m.mat_to_quat(m.quat_to_mat(a)),
    "so3_exp_quat": lambda m, a, b, v, w: m.so3_exp_quat(w),
    "so3_exp_quat_small": lambda m, a, b, v, w: m.so3_exp_quat(w * 1e-6),
    "so3_log_quat": lambda m, a, b, v, w: m.so3_log_quat(a),
    "skew": lambda m, a, b, v, w: m.skew(v),
    "make_se3": lambda m, a, b, v, w: m.make_se3(a, v),
    "se3_q_p": lambda m, a, b, v, w: m.se3_q_p(m.make_se3(a, v))[0],
    "transform_points": lambda m, a, b, v, w: m.transform_points(
        m.make_se3(a[0], v[0]), v),
    "quat_angle_deg": lambda m, a, b, v, w: m.quat_angle_deg(a, b),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY_CASES))
def test_geometry_matches_jax(name, rng):
    a, b = _quats(rng, 64), _quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32) * 5
    w = rng.normal(size=(64, 3)).astype(np.float32)
    fn = GEOMETRY_CASES[name]
    want = fn(jgeo, *(jnp.asarray(x) for x in (a, b, v, w)))
    got = fn(tgeo, *(to_torch(x) for x in (a, b, v, w)))
    # angles near 0 / 180 deg: atan2 near its branch point, looser atol
    close(got, want, atol=1e-4 if name == "quat_angle_deg" else 1e-6)


# -------------------------------------------------------------- pointcloud

def _cloud(rng, n=3000, n_bad=200):
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    xyz[rng.choice(n, n_bad, replace=False)] = 0.3      # inside the crop box
    t = (rng.integers(0, 97, n) * 1e-3).astype(np.float32)
    valid = rng.random(n) > 0.05
    return xyz, t, valid


def test_crop_and_prepare_scan_match_jax(rng):
    xyz, t, valid = _cloud(rng)
    js0 = jpc.make_scan(jnp.asarray(xyz), jnp.asarray(t), jnp.asarray(valid))
    js = jpc.crop_box(js0, 1.0)
    ts = tpc.crop_box(tpc.Scan(to_torch(np.asarray(js0.xyz)), to_torch(t),
                               to_torch(np.asarray(js0.valid)), None), 1.0)
    close(ts.xyz, js.xyz, rtol=0, atol=0)
    assert int(ts.count) == int(js.count)
    jp = jpc.prepare_scan(js, 64)          # fewer frames than unique times
    tp = tpc.prepare_scan(ts, 64)
    for f in ("xyz", "t", "valid", "frame_idx", "unique_t"):
        np.testing.assert_array_equal(to_np(getattr(tp, f)),
                                      to_np(getattr(jp, f)), err_msg=f)
    for f in ("count", "unique_count", "median_idx", "scan_stamp"):
        assert float(getattr(tp, f)) == float(getattr(jp, f)), f


def test_morton_keys_match_jax(rng):
    xyz, _, valid = _cloud(rng)
    v = rng.integers(0, 1024, (500, 3)).astype(np.int32)
    np.testing.assert_array_equal(to_np(tpc.morton30(to_torch(v))),
                                  np.asarray(jpc.morton30(jnp.asarray(v))))
    np.testing.assert_array_equal(
        to_np(tpc.morton_sort_key(to_torch(xyz), to_torch(valid), 1.0)),
        np.asarray(jpc.morton_sort_key(jnp.asarray(xyz), jnp.asarray(valid),
                                       1.0)))


@pytest.mark.parametrize("capacity", [4096, 300])
def test_voxel_downsample_matches_jax(rng, capacity):
    xyz, _, valid = _cloud(rng)
    want = jpc.voxel_downsample(jnp.asarray(xyz), jnp.asarray(valid), 0.25,
                                capacity)
    got = tpc.voxel_downsample(to_torch(xyz), to_torch(valid), 0.25, capacity)
    assert int(got[2]) == int(want[2])
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
    # segment means: summation order differs (scatter-add vs index_add_)
    close(got[0], want[0], atol=1e-5)


def test_voxel_downsample_is_repeatable(rng):
    """Each voxel's points are summed in one fixed order (a run of the
    sorted keys, ``segment_reduce``): repeated calls return the same bits,
    and the sums are those of a sequential scatter-add in index order."""
    xyz, _, valid = _cloud(rng)
    x, v = to_torch(xyz), to_torch(valid)
    a = tpc.voxel_downsample(x, v, 0.25, 300)
    for _ in range(3):
        b = tpc.voxel_downsample(x, v, 0.25, 300)
        for p, q in zip(a, b):
            assert torch.equal(p, q)
    # the segment sums against index_add_ (in index order on the CPU)
    key = torch.where(v, tpc.morton30(torch.clamp(
        (torch.floor(x / 0.25) - torch.floor(tpc._masked_min(x, v) / 0.25)
         ).to(torch.int32), 0, 1023)), tpc.INT32_MAX)
    ks, order = torch.sort(key, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool), ks[1:] != ks[:-1]])
    seg = torch.cumsum(first & v[order], 0) - 1
    seg = torch.where(v[order] & (seg < 300), seg, 300)
    sums = torch.zeros(301, 3).index_add_(0, seg, x[order] * v[order, None])
    cnts = torch.zeros(301).index_add_(0, seg, v[order].float())
    want = sums[:300] / torch.clamp(cnts[:300], min=1.0)[:, None]
    assert torch.equal(a[0][a[1]], want[a[1]])


def test_deskew_and_transform_match_jax(rng):
    xyz, t, valid = _cloud(rng)
    js0 = jpc.make_scan(jnp.asarray(xyz), jnp.asarray(t), jnp.asarray(valid))
    js = jpc.prepare_scan(js0, 128)
    ts = tpc.prepare_scan(tpc.Scan(to_torch(np.asarray(js0.xyz)), to_torch(t),
                                   to_torch(np.asarray(js0.valid)), None), 128)
    fq = _quats(rng, 128)
    fp = rng.normal(size=(128, 3)).astype(np.float32)
    R, tx = _rot(rng), np.array([0.1, -0.2, 0.3], np.float32)
    want = jdk.deskew_points(js, jnp.asarray(fq), jnp.asarray(fp),
                             jnp.asarray(R), jnp.asarray(tx))
    got = tdk.deskew_points(ts, to_torch(fq), to_torch(fp), to_torch(R),
                            to_torch(tx))
    close(got, want, atol=1e-5)                  # |x| ~ 35 m
    T = np.asarray(jgeo.make_se3(jnp.asarray(fq[0]), jnp.asarray(fp[0])))
    close(tdk.transform_cloud(to_torch(xyz), to_torch(valid), to_torch(T)),
          jdk.transform_cloud(jnp.asarray(xyz), jnp.asarray(valid),
                              jnp.asarray(T)), atol=1e-5)


# --------------------------------------------------------------------- imu

def _imu_window(rng, m=64, count=50):
    stamps = np.cumsum(rng.uniform(0.008, 0.012, m)).astype(np.float32) - 0.1
    ang = rng.normal(scale=0.3, size=(m, 3)).astype(np.float32)
    acc = (rng.normal(scale=0.5, size=(m, 3))
           + [0, 0, 9.8]).astype(np.float32)
    return stamps, ang, acc, count


@pytest.mark.parametrize("start,end", [(0.0, 0.1), (-0.2, 0.05), (0.3, 0.9)])
def test_slice_imu_window_matches_jax(rng, start, end):
    stamps, ang, acc, count = _imu_window(rng, m=100, count=90)
    args = (stamps, ang, acc)
    want = jimu.slice_imu_window(*(jnp.asarray(a) for a in args),
                                 jnp.int32(count), jnp.float32(start),
                                 jnp.float32(end), 32)
    got = timu.slice_imu_window(*(to_torch(a) for a in args),
                                torch.tensor(count),
                                torch.tensor(start), torch.tensor(end), 32)
    for a, b in zip(got, want):
        close(a, b, rtol=0, atol=0)


def test_quat_prefix_matches_jax(rng):
    q0 = _quats(rng, 1)[0]
    om = rng.normal(size=(127, 3)).astype(np.float32)
    dts = rng.uniform(0.005, 0.01, 127).astype(np.float32)
    close(timu.quat_prefix(to_torch(q0), to_torch(om), to_torch(dts)),
          jimu.quat_prefix(jnp.asarray(q0), jnp.asarray(om),
                           jnp.asarray(dts)))


def test_integrate_and_propagate_match_jax(rng):
    stamps, ang, acc, count = _imu_window(rng)
    jw = jimu.ImuWindow(jnp.asarray(stamps), jnp.asarray(ang),
                        jnp.asarray(acc), jnp.int32(count))
    tw = timu.ImuWindow(to_torch(stamps), to_torch(ang), to_torch(acc),
                        torch.tensor(count))
    q0 = _quats(rng, 1)[0]
    p0 = np.array([1.0, 2.0, 0.5], np.float32)
    v0 = np.array([1.2, 0.3, 0.0], np.float32)
    qt = np.sort(rng.uniform(-0.05, 0.3, 200)).astype(np.float32)
    want = jimu.integrate_imu(jw, jnp.float32(-0.05), jnp.asarray(q0),
                              jnp.asarray(p0), jnp.asarray(v0),
                              jnp.asarray(qt))
    got = timu.integrate_imu(tw, torch.tensor(-0.05), to_torch(q0),
                             to_torch(p0), to_torch(v0), to_torch(qt))
    close(got[0], want[0])
    # positions: cumulative sums over ~50 intervals, summed in another order
    close(got[1], want[1], atol=1e-5)
    assert bool(got[2]) == bool(want[2])
    want = jimu.propagate_state_batch(
        jnp.asarray(q0), jnp.asarray(p0), jnp.asarray(v0), jw,
        jnp.int32(count), start_exclusive=jnp.float32(0.0))
    got = timu.propagate_state_batch(to_torch(q0), to_torch(p0),
                                     to_torch(v0), tw, torch.tensor(count),
                                     start_exclusive=torch.tensor(0.0))
    for a, b in zip(got, want):
        close(a, b, atol=1e-5)          # the same cumulative sums


# -------------------------------------------------------------------- gicp

def _planes(rng, n):
    """Points on three orthogonal planes (a well-constrained target)."""
    pts = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    pts[np.arange(n), axis] = -4.0
    return pts


def test_small_gicp_helpers_match_jax(rng):
    A = rng.normal(size=(200, 3, 3)).astype(np.float32)
    S = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    # adjugate / determinant of matrices with condition numbers up to ~1e2:
    # rounding of the 3x3 cofactors is amplified by the condition number
    close(tg._inv3_sym(to_torch(S)), jg._inv3_sym(jnp.asarray(S)),
          rtol=1e-4, atol=1e-5)
    # the sign of an eigenvector is arbitrary; arccos/cos near the
    # eigenvalue gap amplify rounding -> 1e-4
    close(tg._smallest_eigvec_sym3(to_torch(S)).abs(),
          jnp.abs(jg._smallest_eigvec_sym3(jnp.asarray(S))), rtol=1e-4,
          atol=1e-4)
    c6 = np.asarray(jg.mat_to_sym6(jnp.asarray(S)))
    R = _rot(rng)
    close(tg.rotate_sym6(to_torch(c6), to_torch(R)),          # |C| ~ 10
          jg.rotate_sym6(jnp.asarray(c6), jnp.asarray(R)), atol=1e-5)


def test_radius_covariances_match_jax(rng):
    xyz = _planes(rng, 1024)
    valid = rng.random(1024) > 0.05
    want_c, want_d = jg.radius_covariances(jnp.asarray(xyz),
                                           jnp.asarray(valid), 0.5)
    got_c, got_d = tg.radius_covariances(to_torch(xyz), to_torch(valid), 0.5)
    # The moments are formed from the |q|^2 - 2 q.x + |x|^2 expansion and
    # S - mu mu^T, both cancellations: f32 rounding that differs between
    # XLA's fused kernels and torch moves the (plane-regularised) result by
    # up to ~1e-3 on a cloud of this extent (8 m box).
    close(got_c, want_c, rtol=0, atol=2e-3)
    close(got_d, want_d, rtol=1e-4)


def test_radius_covariances_as_accurate_as_jax_at_scan_scale(rng):
    """At scan scale (+-30 m) the two cancellations of the formula leave
    many f32 normals off by > 0.05 in the reference itself (a third of the
    points of a synthetic scan; over half of this sparser cloud). Both
    implementations are held against the same formula in float64: the
    port's error must match the reference's (measured medians 0.227 vs
    0.229, within-0.05 shares 0.432 vs 0.440; the slack covers another
    CPU's rounding)."""
    xyz = _planes(rng, 2048) * 7.5              # +-30 m
    valid = np.ones(2048, bool)
    exact = to_np(tg.radius_covariances(to_torch(xyz).double(),
                                        to_torch(valid), 0.5)[0])
    err_j = np.abs(np.asarray(jg.radius_covariances(
        jnp.asarray(xyz), jnp.asarray(valid), 0.5)[0]) - exact).max(-1)
    err_t = np.abs(to_np(tg.radius_covariances(
        to_torch(xyz), to_torch(valid), 0.5)[0]) - exact).max(-1)
    assert np.median(err_t) < 1.5 * np.median(err_j) + 1e-4
    assert np.mean(err_t < 0.05) > np.mean(err_j < 0.05) - 0.1


def _gicp_problem(rng, n_src=512, n_tgt=2048):
    tgt = _planes(rng, n_tgt)
    src = tgt[rng.choice(n_tgt, n_src, replace=False)].copy()
    src += rng.normal(0, 0.005, src.shape).astype(np.float32)
    R = np.asarray(jgeo.quat_to_mat(jgeo.so3_exp_quat(
        jnp.asarray([0.0, 0.0, 0.03], jnp.float32))))
    src = (src @ R.T + np.array([0.08, -0.05, 0.02])).astype(np.float32)
    sv = np.ones(n_src, bool)
    tv = np.ones(n_tgt, bool)
    src_cov = np.asarray(jg.radius_covariances(jnp.asarray(src),
                                               jnp.asarray(sv), 0.5)[0])
    tgt_cov = np.asarray(jg.radius_covariances(jnp.asarray(tgt),
                                               jnp.asarray(tv), 0.5)[0])
    return src, sv, src_cov, tgt, tgt_cov


def test_correspondences_and_linearize_match_jax(rng):
    src, sv, sc, tgt, tc = _gicp_problem(rng)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [-0.05, 0.03, -0.01]
    jc = jg.update_correspondences(jnp.asarray(src), jnp.asarray(sv),
                                   jnp.asarray(sc), jnp.asarray(tgt),
                                   jnp.asarray(tc), jnp.asarray(T),
                                   jnp.float32(0.5))
    tcorr = tg.update_correspondences(to_torch(src), to_torch(sv),
                                      to_torch(sc), to_torch(tgt),
                                      to_torch(tc), to_torch(T),
                                      torch.tensor(0.5))
    np.testing.assert_array_equal(to_np(tcorr.weight), np.asarray(jc.weight))
    acc = np.asarray(jc.weight) > 0
    # NN: the port's exact search vs JAX's |q|^2-2q.t+|t|^2 expansion; the
    # winners agree wherever the two nearest targets do not (nearly) tie
    same = to_np(tcorr.tgt_idx)[acc] == np.asarray(jc.tgt_idx)[acc]
    assert same.mean() > 0.99
    # (C_B + R C_A R^T)^-1 of plane-regularised covariances: eigenvalues
    # down to 1e-3, so inverse entries up to ~1e3 carry ~1e-4 relative noise
    close(tcorr.maha[acc][same], np.asarray(jc.maha)[acc][same], rtol=1e-4,
          atol=1e-3)
    # linearize on identical correspondences
    jidx = to_torch(np.asarray(jc.tgt_idx)).long()
    jc_t = tg.Correspondences(jidx, to_torch(tgt)[jidx],
                              to_torch(np.asarray(jc.maha)),
                              to_torch(np.asarray(jc.weight)),
                              torch.tensor(int(jc.count)))
    H, b, e = tg.linearize(to_torch(src), jc_t, to_torch(T))
    Hj, bj, ej = jg.linearize(jnp.asarray(src), jnp.asarray(tgt), jc,
                              jnp.asarray(T))
    # sums over 512 pairs of terms up to ~1e4 (Mahalanobis weights ~1e3
    # times lever arms ~4 m) in another order
    close(H, Hj, rtol=1e-4, atol=1e-2)
    close(b, bj, rtol=1e-4, atol=1e-3)
    close(e, ej, rtol=1e-4)
    close(tg.compute_error(to_torch(src), jc_t, to_torch(T)),
          jg.compute_error(jnp.asarray(src), jnp.asarray(tgt), jc,
                           jnp.asarray(T)), rtol=1e-4)


def test_gicp_align_matches_jax(rng):
    src, sv, sc, tgt, tc = _gicp_problem(rng)
    cfg = GicpConfig()
    want = jg.gicp_align(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(sc),
                         jnp.asarray(tgt), jnp.asarray(tc), jax_cfg(cfg))
    syncs = tg.HostSyncs()
    got = tg.gicp_align(to_torch(src), to_torch(sv), to_torch(sc),
                        to_torch(tgt), to_torch(tc), cfg, syncs=syncs)
    assert bool(got.converged) and bool(want.converged)
    assert int(got.iterations) == int(want.iterations) == syncs.n
    # well-constrained target: both land on the same optimum to ~10 um
    close(got.T, want.T, rtol=0, atol=1e-5)
    assert int(got.num_corr) == int(want.num_corr)
