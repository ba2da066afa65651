"""Parity of the port's ``ops.neighbors.nn1`` (kernel A's plain version on
the CPU) with JAX's ``_nn1_xla`` and with the Pallas kernel ``nn1_fused``
run in interpret mode, mirroring tests/test_neighbors.py. The kernel
itself runs only on the card: tests/test_torch_kernels.py compares it with
the plain version there."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import noetic_slam_tpu.ops.pallas.nn_kernel as jnk
from noetic_slam_tpu.ops import neighbors as jn
from noetic_slam_tpu.ops import pointcloud as jpc
from noetic_slam_tpu_torch.ops import neighbors as tn
from noetic_slam_tpu_torch.ops.cuda import nn_kernel as tnk
from tests.torch_parity import to_np, to_torch

torch.set_num_threads(1)

# Distances: both sides recompute |q - t|^2 at the winner from the original
# coordinates; JAX sums the three squares in another order -> rtol 1e-5.
D_RTOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    """Run JAX's Pallas kernels in interpret mode (no TPU here)."""
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))


def _clouds(rng, nq=512, nt=2048, scale=10.0, offset=0.0):
    q = rng.normal(size=(nq, 3)).astype(np.float32) * scale + offset
    t = rng.normal(size=(nt, 3)).astype(np.float32) * scale + offset
    return q.astype(np.float32), t.astype(np.float32)


def _exact(q, t):
    d = ((q[:, None, :].astype(np.float64) - t[None]) ** 2).sum(-1)
    return d.argmin(1), d.min(1)


def _assert_nn(idx, sqd, q, t, mask=None):
    """idx is an exact nearest neighbour (ties allowed) and sqd its
    distance."""
    widx, wd = _exact(q, t)
    mask = np.ones(len(q), bool) if mask is None else mask
    idx, sqd = to_np(idx)[mask], to_np(sqd)[mask]
    np.testing.assert_allclose(sqd, wd[mask], rtol=D_RTOL, atol=1e-7)
    d_at = ((q[mask] - t[idx]) ** 2).sum(-1)
    np.testing.assert_allclose(d_at, wd[mask], rtol=D_RTOL, atol=1e-7)


@pytest.mark.parametrize("offset", [0.0, 3000.0])
def test_nn1_matches_xla(rng, offset):
    q, t = _clouds(rng, offset=offset)
    i_t, d_t = tn.nn1(to_torch(q), to_torch(t))
    i_j, d_j = jn._nn1_xla(jnp.asarray(q), jnp.asarray(t), query_chunk=256,
                           target_chunk=512)
    _assert_nn(i_t, d_t, q, t)
    if offset == 0.0:
        # untied winners agree with XLA's (expansion-based) search
        np.testing.assert_array_equal(to_np(i_t), np.asarray(i_j))
        np.testing.assert_allclose(to_np(d_t), np.asarray(d_j), rtol=D_RTOL)


def test_nn1_matches_fused_interpret(rng, interpret):
    q, t = _clouds(rng)
    i_j, d_j = jnk.nn1_fused(jnp.asarray(q), jnp.asarray(t))
    i_t, d_t = tn.nn1(to_torch(q), to_torch(t))
    np.testing.assert_array_equal(to_np(i_t), np.asarray(i_j))
    np.testing.assert_allclose(to_np(d_t), np.asarray(d_j), rtol=D_RTOL)


def test_nn1_capped_matches_fused_interpret(rng, interpret):
    q, t = _clouds(rng)
    cap = 0.8
    i_j, d_j = jnk.nn1_fused(jnp.asarray(q), jnp.asarray(t),
                             max_dist=jnp.float32(cap))
    i_t, d_t = tn.nn1(to_torch(q), to_torch(t), max_dist=cap)
    d_j, d_t, i_t = np.asarray(d_j), to_np(d_t), to_np(i_t)
    found_j, found_t = d_j < cap * cap, d_t < cap * cap
    assert found_j.any() and (~found_j).any()
    np.testing.assert_array_equal(found_t, found_j)
    np.testing.assert_array_equal(i_t[found_t], np.asarray(i_j)[found_j])
    np.testing.assert_allclose(d_t[found_t], d_j[found_j], rtol=D_RTOL)
    # not found: idx 0 and sqd = cap^2 (the kernel's contract)
    assert (i_t[~found_t] == 0).all()
    np.testing.assert_allclose(d_t[~found_t], np.float32(cap) ** 2)


def test_nn1_morton_padded_t_count_matches_fused_interpret(rng, interpret):
    tn_live = 1500
    t = np.full((2048, 3), jpc.SENTINEL, np.float32)
    t[:tn_live] = rng.uniform(-20, 20, (tn_live, 3)).astype(np.float32)
    tv = np.arange(2048) < tn_live
    key = jpc.morton_sort_key(jnp.asarray(t), jnp.asarray(tv), 1.0)
    t = t[np.argsort(np.asarray(key), kind="stable")]
    # a far live row beyond t_count must never be returned
    t[tn_live] = t[0] + 1e-3
    q = (t[:512] + rng.normal(0, 0.05, (512, 3))).astype(np.float32)
    i_j, d_j = jnk.nn1_fused(jnp.asarray(q), jnp.asarray(t),
                             t_count=jnp.int32(tn_live),
                             max_dist=jnp.float32(1.0))
    i_t, d_t = tn.nn1(to_torch(q), to_torch(t), torch.tensor(tn_live),
                      max_dist=1.0)
    d_j, d_t, i_t = np.asarray(d_j), to_np(d_t), to_np(i_t)
    found = d_j < 1.0
    assert found.mean() > 0.95
    np.testing.assert_array_equal(d_t < 1.0, found)
    assert i_t.max() < tn_live
    np.testing.assert_array_equal(i_t[found], np.asarray(i_j)[found])
    np.testing.assert_allclose(d_t[found], d_j[found], rtol=D_RTOL)


def test_nn1_empty_target_count(rng):
    q, t = _clouds(rng, nq=64, nt=128)
    i_t, d_t = tn.nn1(to_torch(q), to_torch(t), torch.tensor(0),
                      max_dist=0.5)
    assert (to_np(i_t) == 0).all()
    np.testing.assert_allclose(to_np(d_t), 0.25)


def test_visit_lists_cover_every_candidate_tile(rng):
    """The wrapper's plain visit lists: sorted ascending, candidates only,
    and every tile holding a true neighbour of a query is listed."""
    q, t = _clouds(rng, nq=200, nt=1000, scale=5.0)
    count = torch.tensor([900], dtype=torch.int32)
    cap2 = torch.tensor([4.0])
    vlist, vlb, vcnt = tnk.visit_lists(to_torch(q), to_torch(t), count, cap2,
                                       q_tile=64, t_tile=256)
    vlist, vlb, vcnt = to_np(vlist), to_np(vlb), to_np(vcnt)
    assert vlist.shape == (4, 4) and vcnt.max() <= 4
    for r in range(4):
        assert np.all(np.diff(vlb[r, :vcnt[r]]) >= 0)
        assert np.isinf(vlb[r, vcnt[r]:]).all()
        widx, wd = _exact(q[r * 64:(r + 1) * 64], t[:900])
        need = {int(i) // 256 for i, d in zip(widx, wd) if d < 4.0}
        assert need <= set(vlist[r, :vcnt[r]].tolist())
