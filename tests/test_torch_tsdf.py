"""Parity of the port's TSDF backend (``models.tsdf``, kernel B's plain
version on the CPU) with JAX's ``_integrate_samples`` on both of its
routes: the Pallas kernel in interpret mode and the XLA scatter path,
mirroring tests/test_tsdf_kernel.py. Kernel B itself runs only on the
card: tests/test_torch_kernels.py compares it with its plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noetic_slam_tpu.models import tsdf as jt
from noetic_slam_tpu.ops.pallas import tsdf_kernel as jk
from noetic_slam_tpu_torch.config import TsdfConfig
from noetic_slam_tpu_torch.models import tsdf as tt
from noetic_slam_tpu_torch.ops.cuda import tsdf_kernel as tk
from tests.torch_parity import (
    close,
    jax_cfg,
    pallas_entries,
    to_np,
    to_torch,
)

torch.set_num_threads(1)

# Payload: per-voxel sums in another order (kernel B: stream order per voxel;
# JAX: one-hot matmul / scatter-add), as tests/test_tsdf_kernel.py.
P_TOL = 1e-5


def _cfg(**kw):
    base = dict(voxel_size=0.1, truncation=0.3, max_blocks=256,
                space_carving=True, carving_samples=4, max_range=30.0,
                scan_block_cap=64)
    base.update(kw)
    return TsdfConfig(**base)


def _assert_states(t_state, j_state):
    np.testing.assert_array_equal(to_np(t_state.dir_keys),
                                  np.asarray(j_state.dir_keys))
    np.testing.assert_array_equal(to_np(t_state.dir_slots),
                                  np.asarray(j_state.dir_slots))
    assert int(t_state.num_blocks) == int(j_state.num_blocks)
    assert int(t_state.dropped) == int(j_state.dropped)
    close(t_state.weight, j_state.weight, rtol=P_TOL, atol=P_TOL)
    close(t_state.wsum, j_state.wsum, rtol=P_TOL, atol=P_TOL)


def _run(cfg, clouds, sign=1.0, origin=(0.0, 0.0, 0.0)):
    """Fuse ``clouds`` through the port and both JAX routes, from JAX's
    ray samples (so the three see identical samples)."""
    jcfg = jax_cfg(cfg)
    st_t = tt.init_tsdf(cfg, "cpu")
    st_k = jt.init_tsdf(jcfg)
    st_x = jt.init_tsdf(jcfg)
    o = jnp.asarray(origin, jnp.float32)
    for pts in clouds:
        valid = jnp.ones((pts.shape[0],), bool)
        pos, sdf, w = jt._ray_samples(jcfg, jnp.asarray(pts), valid, o)
        w = w * sign
        st_k = jt._integrate_samples(jcfg, st_k, pos, sdf, w, use_kernel=True,
                                     interpret=True)
        st_x = jt._integrate_samples(jcfg, st_x, pos, sdf, w,
                                     use_kernel=False)
        st_t = tt._integrate_samples(cfg, st_t, to_torch(pos), to_torch(sdf),
                                     to_torch(w))
    return st_t, st_k, st_x


def _cylinder(rng, n=128, shift=0.0):
    ang = rng.uniform(0, 2 * np.pi, n)
    r = 5.0 + rng.normal(scale=0.05, size=n)
    z = rng.uniform(-0.5, 1.5, n)
    return (np.stack([r * np.cos(ang), r * np.sin(ang), z], -1)
            + shift).astype(np.float32)


def _line(n):
    return (np.arange(n, dtype=np.float32)[:, None]
            * np.array([[1.0, 0, 0]], np.float32))


CASES = {
    # name: (cfg overrides, clouds from rng)
    "surface": ({}, lambda rng: [_cylinder(rng, shift=0.01 * i)
                                 for i in range(3)]),
    "max_weight_clamp": (dict(max_weight=3.0, space_carving=False),
                         lambda rng: [np.tile(np.array([[2.0, 0.05, 0.05]],
                                                       np.float32),
                                              (64, 1))] * 3),
    "block_cap_overflow": (dict(scan_block_cap=8, space_carving=False,
                                max_blocks=64), lambda rng: [_line(40)]),
    "directory_capacity": (dict(space_carving=False, max_blocks=8),
                           lambda rng: [_line(30)]),
    "empty_scan": ({}, lambda rng: [np.zeros((16, 3), np.float32)]),
}


@pytest.mark.parametrize("route", ["kernel_interpret", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_integrate_samples_matches_jax(case, route):
    overrides, clouds = CASES[case]
    cfg = _cfg(**overrides)
    st_t, st_k, st_x = _run(cfg, clouds(np.random.default_rng(3)))
    _assert_states(st_t, st_k if route == "kernel_interpret" else st_x)
    if case == "max_weight_clamp":
        assert float(st_t.weight.max()) <= 3.0 + 1e-6
    if case in ("block_cap_overflow", "directory_capacity"):
        assert int(st_t.dropped) > 0
    if case == "empty_scan":
        assert int(st_t.num_blocks) == 0


def test_signed_defusion_matches_jax_and_cancels():
    """NO_CLAMP (the archive volume): sign = -1 subtracts exactly what
    sign = +1 added, in both implementations."""
    cfg = _cfg(max_weight=tt.NO_CLAMP)
    rng = np.random.default_rng(5)
    cloud = _cylinder(rng)
    st_t, st_k, st_x = _run(cfg, [cloud])
    _assert_states(st_t, st_x)
    pos, sdf, w = tt._ray_samples(cfg, to_torch(cloud),
                                  torch.ones(len(cloud), dtype=torch.bool),
                                  torch.zeros(3))
    st_t = tt._integrate_samples(cfg, st_t, pos, sdf, -w)
    assert float(st_t.weight.abs().max()) < 1e-5
    assert float(st_t.wsum.abs().max()) < 1e-5


@pytest.mark.parametrize("clamp", ["clamped", "no_clamp"])
def test_block_accumulate_plain_matches_jax_kernel(rng, clamp):
    """The plain version against JAX's Pallas kernel (interpret mode) on one
    stream and a payload a map can reach (weights in [0, max_weight], wsum
    0 where the weight is 0): clamped at max_weight = 3.0, and NO_CLAMP
    with the weights negated (signed de-fusion)."""
    max_weight, sign = (3.0, 1.0) if clamp == "clamped" else (tk.NO_CLAMP,
                                                               -1.0)
    W = rng.uniform(0, 3.0, (64, 512)).astype(np.float32)
    W[rng.random(W.shape) < 0.25] = 0.0
    WS = (W * rng.uniform(-0.3, 0.3, W.shape)).astype(np.float32)
    rows, starts, cnts, ivox = pallas_entries(rng)
    w = (rng.uniform(0.05, 1.0, ivox.shape[0]) * sign).astype(np.float32)
    wd = (w * rng.uniform(-0.3, 0.3, w.shape)).astype(np.float32)
    want = jk.block_accumulate(
        *(jnp.asarray(a) for a in (W, WS, rows, starts, cnts, ivox, w, wd)),
        max_weight, interpret=True)
    got = (to_torch(W), to_torch(WS))
    tk.block_accumulate_plain(*got, *(to_torch(a) for a in
                                      (rows, starts, cnts, ivox, w, wd)),
                              max_weight)
    touched = np.zeros(64, bool)
    touched[rows[cnts > 0]] = True
    for g, j, x in zip(got, want, (W, WS)):
        close(g, j, rtol=P_TOL, atol=P_TOL)
        np.testing.assert_array_equal(to_np(g)[~touched], x[~touched])
    if clamp == "clamped":
        assert to_np(got[0]).max() <= max_weight
    else:       # negated weights, no clamp: touched voxels go below 0
        assert to_np(got[0]).min() < 0.0


def test_block_key_wraps_like_int32_jax():
    """Blocks with z >= 0 wrap negative in JAX's int32 shift; the port
    gives the same bits, so the directory sorts the same way."""
    b = np.array([[0, 0, 0], [5, -3, 1], [-1024, 1023, 511], [1023, -1024, -512],
                  [7, 7, -1], [0, 0, 512], [2000, 0, 0]], np.int32)
    got = to_np(tt._block_key(to_torch(b)))
    want = np.asarray(jt._block_key(jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got[:3] < 0).all()
    assert (got[-2:] == np.iinfo(np.int32).max).all()


def test_lookup_join_matches_jax(rng):
    keys = np.sort(rng.choice(10_000, 50, replace=False)).astype(np.int32)
    ref = np.full(64, np.iinfo(np.int32).max, np.int32)
    ref[:50] = keys
    vals = rng.integers(0, 64, 64).astype(np.int32)
    q = np.concatenate([keys[::3], rng.integers(0, 10_000, 40)]
                       ).astype(np.int32)
    np.testing.assert_array_equal(
        to_np(tt._lookup_join(to_torch(ref), to_torch(vals), to_torch(q))),
        np.asarray(jt._lookup_join(jnp.asarray(ref), jnp.asarray(vals),
                                   jnp.asarray(q))))


def test_ray_samples_and_distance_match_jax(rng):
    cfg = _cfg(carving_samples=16)
    pts = _cylinder(rng, n=256)
    valid = rng.random(256) > 0.1
    origin = np.array([0.2, -0.1, 0.3], np.float32)
    jcfg = jax_cfg(cfg)
    want = jt._ray_samples(jcfg, jnp.asarray(pts), jnp.asarray(valid),
                           jnp.asarray(origin))
    got = tt._ray_samples(cfg, to_torch(pts), to_torch(valid),
                          to_torch(origin))
    for a, b in zip(got, want):
        close(a, b, atol=1e-5)           # positions ~5 m
    st_t, st_k, _ = _run(cfg, [pts])
    close(tt.tsdf_distance(cfg, st_t), jt.tsdf_distance(jcfg, st_k),
          rtol=P_TOL, atol=P_TOL)


def test_allocate_blocks_matches_jax(rng):
    """Duplicates, padding, keys already present and capacity overflow."""
    cfg = _cfg(max_blocks=16)
    st_t = tt.init_tsdf(cfg, "cpu")
    st_j = jt.init_tsdf(jax_cfg(cfg))
    pad = np.iinfo(np.int32).max
    for n in (6, 9, 24):
        keys = rng.integers(0, 60, n).astype(np.int32)
        keys[::4] = pad
        st_t = tt.allocate_blocks(st_t, to_torch(keys))
        st_j = jt.allocate_blocks(st_j, jnp.asarray(keys))
        _assert_states(st_t, st_j)
    assert int(st_t.dropped) > 0 and int(st_t.num_blocks) == 16


def test_integrate_signed_cancels_no_clamp():
    """The public signed entry point, NO_CLAMP: +1 then -1 returns the
    payload to ~0, and each step matches JAX's integrate_signed."""
    cfg = _cfg(max_weight=tt.NO_CLAMP)
    cloud = _cylinder(np.random.default_rng(6))
    valid = np.ones(len(cloud), bool)
    origin = np.array([0.1, 0.0, 0.2], np.float32)
    st_t = tt.init_tsdf(cfg, "cpu")
    st_j = jt.init_tsdf(jax_cfg(cfg))
    for sign in (1.0, -1.0):
        st_t = tt.integrate_signed(cfg, st_t, to_torch(cloud),
                                   to_torch(valid), to_torch(origin), sign)
        st_j = jt.integrate_signed(jax_cfg(cfg), st_j, jnp.asarray(cloud),
                                   jnp.asarray(valid), jnp.asarray(origin),
                                   jnp.float32(sign))
        _assert_states(st_t, st_j)
    assert float(st_t.weight.abs().max()) < 1e-5
    assert float(st_t.wsum.abs().max()) < 1e-5


def _keyframe_clouds(K=3, Nk=128, n=2):
    rng = np.random.default_rng(9)
    kf_xyz = np.full((K, Nk, 3), 1e6, np.float32)
    kf_valid = np.zeros((K, Nk), bool)
    kf_pos = np.zeros((K, 3), np.float32)
    for k in range(n):
        kf_pos[k] = [0.2 * k, 0.0, 0.1]
        kf_xyz[k] = _cylinder(rng, n=Nk, shift=0.03 * k)
        kf_valid[k] = True
    return kf_xyz, kf_valid, kf_pos


def test_rebuild_from_keyframes_matches_jax():
    cfg = _cfg()
    kf_xyz, kf_valid, kf_pos = _keyframe_clouds()
    got = tt.rebuild_from_keyframes(cfg, to_torch(kf_xyz),
                                    to_torch(kf_valid), to_torch(kf_pos),
                                    torch.tensor(2, dtype=torch.int32))
    want = jt.rebuild_from_keyframes(
        jax_cfg(cfg), jnp.asarray(kf_xyz), jnp.asarray(kf_valid),
        jnp.asarray(kf_pos), jnp.int32(2))
    _assert_states(got, want)
    assert int(got.num_blocks) > 0


def test_voxel_centers_and_extract_surface_match_jax():
    cfg = _cfg()
    rng = np.random.default_rng(3)
    st_t, st_k, _ = _run(cfg, [_cylinder(rng, shift=0.01 * i)
                               for i in range(3)])
    jcfg = jax_cfg(cfg)
    used = np.zeros(cfg.max_blocks, bool)
    nb = int(st_t.num_blocks)
    used[to_np(st_t.dir_slots)[:nb]] = True
    # allocated slots bitwise; the rest is zero in the port (JAX writes
    # slot C-1 from its padding keys)
    ct = to_np(tt.voxel_centers(cfg, st_t))
    np.testing.assert_array_equal(ct[used],
                                  np.asarray(jt.voxel_centers(jcfg,
                                                              st_k))[used])
    assert not ct[~used].any()
    pts, d, mask = tt.extract_surface(cfg, st_t)
    jp, jd, jm = jt.extract_surface(jcfg, st_k)
    np.testing.assert_array_equal(to_np(mask), np.asarray(jm))
    assert int(mask.sum()) > 20
    m = to_np(mask)
    np.testing.assert_array_equal(to_np(pts)[m], np.asarray(jp)[m])
    close(to_np(d)[m], np.asarray(jd)[m], rtol=P_TOL, atol=P_TOL)
