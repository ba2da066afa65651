"""Parity of the port's occupancy backend (``models.occupancy``, kernel C's
plain version on the CPU) with JAX's ``models.occupancy`` on both of its
routes: the Pallas log-odds kernel in interpret mode and the XLA scatter
path, mirroring tests/test_occupancy.py. Kernel C itself runs only on the
card: tests/test_torch_kernels.py compares it with its plain version
there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noetic_slam_tpu.models import occupancy as jo
from noetic_slam_tpu.models import odometry as jodo
from noetic_slam_tpu.ops.pallas import tsdf_kernel as jk
from noetic_slam_tpu_torch import convert
from noetic_slam_tpu_torch.config import CapacityConfig, DlioConfig, OccupancyConfig
from noetic_slam_tpu_torch.models import occupancy as to
from noetic_slam_tpu_torch.models import odometry as todo
from noetic_slam_tpu_torch.ops.cuda import logodds_kernel as lk
from tests.torch_parity import close, jax_cfg, to_np, to_torch

torch.set_num_threads(1)

# Log-odds: per-voxel sums of the same deltas in another order (the port:
# stream order per entry; JAX: one-hot matmul or per-sample scatter-add),
# as tests/test_occupancy.py holds JAX's two routes to each other.
L_TOL = 1e-5


def _cfg(**kw):
    base = dict(voxel_size=0.1, max_blocks=256, miss_samples=16,
                max_range=30.0, scan_block_cap=64)
    base.update(kw)
    return OccupancyConfig(**base)


def _ring(rng, n=96, shift=0.0):
    ang = rng.uniform(0, 2 * np.pi, n)
    r = 4.0 + rng.normal(scale=0.05, size=n)
    z = rng.uniform(-0.5, 1.0, n)
    return (np.stack([r * np.cos(ang), r * np.sin(ang), z], -1)
            + shift).astype(np.float32)


def _assert_states(t_state, j_state):
    np.testing.assert_array_equal(to_np(t_state.dir_keys),
                                  np.asarray(j_state.dir_keys))
    np.testing.assert_array_equal(to_np(t_state.dir_slots),
                                  np.asarray(j_state.dir_slots))
    assert int(t_state.num_blocks) == int(j_state.num_blocks)
    assert int(t_state.dropped) == int(j_state.dropped)
    close(t_state.logodds, j_state.logodds, rtol=L_TOL, atol=L_TOL)


def _fuse_all(cfg, clouds, route, origin=(0.0, 0.0, 0.0)):
    """Fuse ``clouds`` through the port and one JAX route, from JAX's beam
    samples (so both see identical samples)."""
    jcfg = jax_cfg(cfg)
    st_t = to.init_occupancy(cfg, "cpu")
    st_j = jo.init_occupancy(jcfg)
    o = jnp.asarray(origin, jnp.float32)
    for pts in clouds:
        valid = jnp.ones((pts.shape[0],), bool)
        pos, delta = jo._beam_samples(jcfg, jnp.asarray(pts), valid, o)
        st_j = jo._integrate_deltas(
            jcfg, st_j, pos, delta, use_kernel=route == "kernel_interpret",
            interpret=True)
        st_t = to._integrate_deltas(cfg, st_t, to_torch(pos),
                                    to_torch(delta))
    return st_t, st_j


@pytest.mark.parametrize("route", ["kernel_interpret", "xla"])
def test_integrate_deltas_matches_jax(route):
    """Three ring scans, then six more passes of the last one so that the
    clamp engages at l_max."""
    cfg = _cfg()
    rng = np.random.default_rng(7)
    clouds = [_ring(rng, shift=0.01 * i) for i in range(3)]
    st_t, st_j = _fuse_all(cfg, clouds + [clouds[-1]] * 6, route)
    _assert_states(st_t, st_j)
    assert int(st_t.num_blocks) > 4
    L = to_np(st_t.logodds)
    assert L.max() >= cfg.l_max - 1e-5 and L.min() >= cfg.l_min - 1e-5


@pytest.mark.parametrize("route", ["kernel_interpret", "xla"])
@pytest.mark.parametrize("case", ["block_cap", "directory"])
def test_capacity_overflow_matches_jax(route, case):
    """More blocks than ``scan_block_cap`` in one scan, or than the
    directory holds: both drop the same blocks and count them alike."""
    cfg = (_cfg(max_blocks=64, scan_block_cap=8, miss_samples=2)
           if case == "block_cap" else
           _cfg(max_blocks=8, scan_block_cap=64, miss_samples=2))
    pts = np.random.default_rng(11).uniform(-12, 12, (128, 3))
    st_t, st_j = _fuse_all(cfg, [pts.astype(np.float32)], route)
    _assert_states(st_t, st_j)
    assert int(st_t.dropped) > 0


def test_beam_samples_match_jax(rng):
    cfg = _cfg(miss_samples=24)
    pts = _ring(rng, n=200)
    valid = rng.random(200) > 0.1
    origin = np.array([0.2, -0.1, 0.3], np.float32)
    want = jo._beam_samples(jax_cfg(cfg), jnp.asarray(pts),
                            jnp.asarray(valid), jnp.asarray(origin))
    got = to._beam_samples(cfg, to_torch(pts), to_torch(valid),
                           to_torch(origin))
    close(got[0], want[0], rtol=0, atol=1e-5)         # positions ~4 m
    close(got[1], want[1], rtol=0, atol=0)


def _jax_stream(rng, C=64, A=24):
    """A stream in the Pallas kernel's ordering contract: padding entries
    (cnt 0) first carrying the first real row, real rows ascending and
    unique, the stream padded to a multiple of 512."""
    n_pad = 5
    rows = np.sort(rng.choice(C, A - n_pad, replace=False))
    cnt = rng.integers(1, 300, A - n_pad)
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    S = -(-int(cnt.sum()) // 512) * 512
    ivox = rng.integers(0, 512, S)
    delta = rng.choice([0.85, -0.4], S) * (rng.random(S) + 0.5)
    i32 = lambda a: np.asarray(a, np.int32)          # noqa: E731
    return (i32(np.r_[[rows[0]] * n_pad, rows]), i32(np.r_[[0] * n_pad,
                                                           starts]),
            i32(np.r_[[0] * n_pad, cnt]), i32(ivox),
            delta.astype(np.float32))


@pytest.mark.parametrize("clamp", ["clamped", "signed"])
def test_logodds_accumulate_plain_matches_jax_kernel(rng, clamp):
    """The plain version against JAX's Pallas kernel (interpret mode) on one
    stream: the clamped update at the OccupancyConfig defaults, and the
    unclamped signed one (l_min/l_max at -/+1e30, deltas negated)."""
    l_min, l_max = ((-2.0, 3.5) if clamp == "clamped"
                    else (-lk.UNCLAMPED, lk.UNCLAMPED))
    sign = 1.0 if clamp == "clamped" else -1.0
    L = rng.uniform(-2.0, 3.5, (64, 512)).astype(np.float32)
    rows, starts, cnts, ivox, delta = _jax_stream(rng)
    delta = delta * np.float32(sign)
    want = jk.logodds_accumulate(
        jnp.asarray(L), jnp.asarray(rows), jnp.asarray(starts),
        jnp.asarray(cnts), jnp.asarray(ivox), jnp.asarray(delta), l_min,
        l_max, interpret=True)
    got = to_torch(L)
    lk.logodds_accumulate_plain(got, *(to_torch(a) for a in
                                       (rows, starts, cnts, ivox, delta)),
                                l_min, l_max)
    close(got, want, rtol=L_TOL, atol=L_TOL)
    touched = np.zeros(64, bool)
    touched[rows[cnts > 0]] = True
    np.testing.assert_array_equal(to_np(got)[~touched], L[~touched])
    if clamp == "clamped":
        assert to_np(got).min() >= l_min and to_np(got).max() <= l_max
    else:       # the +-1e30 clip is the identity: some rows leave the range
        assert to_np(got).min() < -2.0


def test_signed_defusion_returns_to_zero(rng):
    """Unclamped: sign = -1 subtracts what sign = +1 added."""
    cfg = _cfg(l_min=-lk.UNCLAMPED, l_max=lk.UNCLAMPED)
    pts = to_torch(_ring(rng))
    valid = torch.ones(pts.shape[0], dtype=torch.bool)
    origin = torch.zeros(3)
    st = to.init_occupancy(cfg, "cpu")
    st = to.integrate_signed(cfg, st, pts, valid, origin, 1.0)
    assert float(st.logodds.abs().max()) > 1.0
    st = to.integrate_signed(cfg, st, pts, valid, origin, -1.0)
    assert float(st.logodds.abs().max()) < 1e-5


def _keyframes(K=3, Nk=300, n=2):
    rng = np.random.default_rng(4)
    kf_xyz = np.full((K, Nk, 3), 1e6, np.float32)
    kf_valid = np.zeros((K, Nk), bool)
    kf_pos = np.zeros((K, 3), np.float32)
    for k in range(n):
        kf_pos[k] = [0.3 * k, 0.1, 0.0]
        kf_xyz[k] = _ring(rng, n=Nk, shift=0.02 * k)
        kf_valid[k] = True
    return kf_xyz, kf_valid, kf_pos


def test_rebuild_from_keyframes_matches_jax_and_incremental():
    cfg = _cfg()
    kf_xyz, kf_valid, kf_pos = _keyframes()
    st_rb = to.rebuild_from_keyframes(cfg, to_torch(kf_xyz),
                                      to_torch(kf_valid), to_torch(kf_pos),
                                      torch.tensor(2, dtype=torch.int32))
    want = jo.rebuild_from_keyframes(
        jax_cfg(cfg), jnp.asarray(kf_xyz), jnp.asarray(kf_valid),
        jnp.asarray(kf_pos), jnp.int32(2))
    _assert_states(st_rb, want)
    st_inc = to.init_occupancy(cfg, "cpu")
    for k in range(2):
        st_inc = to.integrate(cfg, st_inc, to_torch(kf_xyz[k]),
                              to_torch(kf_valid[k]), to_torch(kf_pos[k]))
    for f in ("dir_keys", "dir_slots", "num_blocks", "dropped", "logodds"):
        assert torch.equal(getattr(st_rb, f), getattr(st_inc, f)), f


def test_extract_occupied_and_prob_match_jax():
    cfg = _cfg()
    rng = np.random.default_rng(2)
    st_t, st_j = _fuse_all(cfg, [_ring(rng), _ring(rng)], "xla")
    centers, L, mask = to.extract_occupied(cfg, st_t)
    jc, jL, jm = jo.extract_occupied(jax_cfg(cfg), st_j)
    np.testing.assert_array_equal(to_np(mask), np.asarray(jm))
    assert int(mask.sum()) > 50
    m = to_np(mask)
    close(to_np(centers)[m], np.asarray(jc)[m], rtol=0, atol=0)
    close(L, jL, rtol=L_TOL, atol=L_TOL)
    close(to.occupancy_prob(st_t), jo.occupancy_prob(st_j), rtol=1e-5,
          atol=1e-6)


@pytest.mark.parametrize("processed", [True, False])
def test_slam_step_fuse_matches_jax(processed):
    """The occupancy branch of the fused step on one JAX ``StepOutput``
    carried across (a skipped scan fuses nothing), from a carried-across
    mid-run map."""
    ocfg = _cfg(max_blocks=512, scan_block_cap=256)
    cfg = DlioConfig(capacity=CapacityConfig(max_points=256),
                     map_backend="occupancy", occupancy=ocfg)
    jcfg = jax_cfg(ocfg)
    rng = np.random.default_rng(8)
    _, st_j = _fuse_all(ocfg, [_ring(rng)], "xla")
    st_t = convert.occupancy_state_from_numpy(st_j, "cpu")

    xyz = np.full((256, 3), 1e6, np.float32)
    xyz[:200] = _ring(rng, n=200, shift=0.05)
    valid = np.arange(256) < 200
    lidar_p = np.array([0.1, -0.2, 0.05], np.float32)
    zero = np.float32(0.0)
    out = dict(pose_q=np.array([1, 0, 0, 0], np.float32), pose_p=lidar_p,
               lidar_q=np.array([1, 0, 0, 0], np.float32), lidar_p=lidar_p,
               world_xyz=xyz, world_valid=valid, scan_stamp=zero,
               sweep_end=zero, is_keyframe=np.bool_(False),
               processed=np.bool_(processed), deskew_ok=np.bool_(True),
               gicp_iterations=np.int32(3), gicp_error=zero,
               num_corr=np.int32(100))
    jout = jodo.StepOutput(**{k: jnp.asarray(v) for k, v in out.items()})
    tout = todo.StepOutput(**{k: to_torch(v) for k, v in out.items()})

    # JAX's make_slam_step fuse (noetic_slam_tpu/models/odometry.py)
    pos, delta = jo._beam_samples(jcfg, jout.world_xyz, jout.world_valid,
                                  jout.lidar_p)
    delta = delta * jout.processed.astype(delta.dtype)
    want = jo._integrate_deltas(jcfg, st_j, pos, delta)
    before = to_np(st_t.logodds).copy()
    got = todo.make_map_fuse(cfg)(st_t, tout)
    _assert_states(got, want)
    if not processed:
        np.testing.assert_array_equal(to_np(got.logodds), before)


def test_convert_round_trip():
    cfg = _cfg()
    rng = np.random.default_rng(1)
    _, st_j = _fuse_all(cfg, [_ring(rng)], "xla")
    back = convert.occupancy_state_to_numpy(
        convert.occupancy_state_from_numpy(st_j, "cpu"))
    assert set(back) == set(to.OccupancyState._fields)
    for f, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(st_j, f)))
