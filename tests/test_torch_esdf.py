"""Parity of the port's ESDF (``models.esdf``) with the JAX module: the
min-plus distance transform against JAX and scipy, and the region and
point queries over TSDF and occupancy maps fused by JAX and carried across
with ``convert``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noetic_slam_tpu.models import esdf as je
from noetic_slam_tpu.models import occupancy as jocc
from noetic_slam_tpu.models import tsdf as jt
from noetic_slam_tpu_torch import convert
from noetic_slam_tpu_torch.config import OccupancyConfig, TsdfConfig
from noetic_slam_tpu_torch.models import esdf as te
from tests.torch_parity import close, jax_cfg, to_np, to_torch

torch.set_num_threads(1)

# The transforms are min-reductions of the same f32 sums (bitwise in
# practice); the square roots and the trilinear blend are f32 elementwise
# formulas in the same order -> 1e-5.
E_TOL = 1e-5


def _tsdf_cfg():
    return TsdfConfig(voxel_size=0.1, truncation=0.3, max_blocks=1024,
                      space_carving=True, carving_samples=24, max_range=30.0,
                      scan_block_cap=512)


def _wall(n=1500, x=2.0, seed=0):
    rng = np.random.default_rng(seed)
    return np.c_[np.full(n, x), rng.uniform(-1.5, 1.5, n),
                 rng.uniform(-0.8, 0.8, n)].astype(np.float32)


@pytest.fixture(scope="module")
def tsdf_states():
    cfg = _tsdf_cfg()
    jcfg = jax_cfg(cfg)
    pts = jnp.asarray(_wall())
    st = jt.init_tsdf(jcfg)
    for _ in range(2):
        st = jt.integrate(jcfg, st, pts, jnp.ones((pts.shape[0],), bool),
                          jnp.zeros(3))
    return cfg, st, convert.tsdf_state_from_numpy(st, "cpu")


@pytest.fixture(scope="module")
def occ_states():
    cfg = OccupancyConfig(voxel_size=0.1, max_blocks=1024, miss_samples=16,
                          max_range=30.0, scan_block_cap=512)
    jcfg = jax_cfg(cfg)
    pts = jnp.asarray(_wall())
    st = jocc.init_occupancy(jcfg)
    for _ in range(2):
        st = jocc.integrate(jcfg, st, pts, jnp.ones((pts.shape[0],), bool),
                            jnp.zeros(3))
    return cfg, st, convert.occupancy_state_from_numpy(st, "cpu")


def test_edt_sq_matches_jax_and_scipy():
    from scipy.ndimage import distance_transform_edt

    rng = np.random.default_rng(3)
    obstacles = rng.random((20, 16, 12)) < 0.03
    obstacles[5, 7, 9] = True
    v = 0.25
    seed = np.where(obstacles, 0.0, 1e9).astype(np.float32)
    got = to_np(te._edt_sq(to_torch(seed), v))
    close(got, je._edt_sq(jnp.asarray(seed), v), rtol=0, atol=0)
    np.testing.assert_allclose(np.sqrt(got),
                               distance_transform_edt(~obstacles,
                                                      sampling=v),
                               atol=1e-4)


# corners: one across the wall, one whose float64 base voxel would differ
# from float32's (x/v lands just below an integer in f32)
ORIGINS = [(1.0, -1.0, -0.5), (1.3, -0.7, -0.3)]


@pytest.mark.parametrize("origin", ORIGINS)
def test_esdf_region_matches_jax(tsdf_states, origin):
    cfg, st_j, st_t = tsdf_states
    o = np.asarray(origin, np.float32)
    want = je.esdf_region(jax_cfg(cfg), st_j, jnp.asarray(o),
                          shape=(16, 20, 12), max_dist=2.0)
    got = te.esdf_region(cfg, st_t, o, shape=(16, 20, 12), max_dist=2.0)
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
    close(got[0], want[0], rtol=E_TOL, atol=E_TOL)
    close(got[2], want[2], rtol=0, atol=0)
    assert to_np(got[1]).mean() > 0.3
    assert (to_np(got[0]) < 0).any() and (to_np(got[0]) > 0.5).any()


@pytest.mark.parametrize("origin", ORIGINS)
def test_esdf_region_occupancy_matches_jax(occ_states, origin):
    cfg, st_j, st_t = occ_states
    o = np.asarray(origin, np.float32)
    want = je.esdf_region_occupancy(jax_cfg(cfg), st_j, jnp.asarray(o),
                                    shape=(16, 20, 12), max_dist=2.0)
    got = te.esdf_region_occupancy(cfg, st_t, o, shape=(16, 20, 12),
                                   max_dist=2.0)
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
    close(got[0], want[0], rtol=E_TOL, atol=E_TOL)
    assert to_np(got[1]).mean() > 0.1


def test_esdf_at_matches_jax(tsdf_states):
    cfg, st_j, st_t = tsdf_states
    rng = np.random.default_rng(5)
    q = np.c_[rng.uniform(1.2, 2.3, 64), rng.uniform(-0.6, 0.6, 64),
              rng.uniform(-0.3, 0.3, 64)].astype(np.float32)
    want = je.esdf_at(jax_cfg(cfg), st_j, jnp.asarray(q), shape=(16, 16, 10),
                      max_dist=2.0)
    got = te.esdf_at(cfg, st_t, to_torch(q), shape=(16, 16, 10),
                     max_dist=2.0)
    close(got, want, rtol=E_TOL, atol=E_TOL)
    assert (to_np(got) < 2.0).mean() > 0.5
