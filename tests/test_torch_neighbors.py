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


# ----------------------------------------------- the kernel's plain models

def _morton_problem(seed, nq=300, nt=2048, live=1500, sentinels=True):
    """A padded, Morton-sorted target (live rows first, sentinels after)
    with a dynamic ``t_count``, and queries near it, one in eight ~1 m off
    and some sentinel rows among them."""
    rng = np.random.default_rng(seed)
    t = np.full((nt, 3), jpc.SENTINEL, np.float32)
    t[:live] = rng.uniform(-8, 8, (live, 3)).astype(np.float32)
    key = jpc.morton_sort_key(jnp.asarray(t), jnp.asarray(np.arange(nt) < live),
                              1.0)
    t = t[np.argsort(np.asarray(key), kind="stable")]
    noise = rng.normal(0, 0.05, (nq, 3))
    noise[::8] = rng.normal(0, 1.0, (len(noise[::8]), 3))
    q = (t[rng.choice(live, nq)] + noise).astype(np.float32)
    q = q[np.lexsort(q.T)]
    if sentinels:
        q[rng.choice(nq, 7, replace=False)] = jpc.SENTINEL
    return q, t, live


@pytest.mark.parametrize("cap", [None, 0.5])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_visit_lists_hold_the_true_neighbours_tile(seed, cap):
    """At the kernel's tile sizes: for every query, the tile of its true
    neighbour is on its group's list, with a bound <= its distance."""
    q, t, live = _morton_problem(seed)
    cap2 = np.inf if cap is None else np.float32(cap) ** 2
    vlist, vlb, vcnt = tnk.visit_lists(
        to_torch(q), to_torch(t), torch.tensor([live], dtype=torch.int32),
        torch.tensor([cap2], dtype=torch.float32))
    vlist, vlb, vcnt = to_np(vlist), to_np(vlb), to_np(vcnt)
    assert vlist.shape == (-(-len(q) // tnk.Q_GROUP), len(t) // tnk.T_TILE)
    widx, wd = _exact(q, t[:live])
    real = np.abs(q).max(axis=1) < 1e5
    checked = 0
    for i in np.flatnonzero(real & (wd < cap2)):
        g = i // tnk.Q_GROUP
        listed = vlist[g, :vcnt[g]].tolist()
        tile = int(widx[i]) // tnk.T_TILE
        assert tile in listed
        assert vlb[g, listed.index(tile)] <= wd[i] * (1 + 1e-6)
        checked += 1
    assert checked > 200
    for g in range(len(vcnt)):
        assert np.all(np.diff(vlb[g, :vcnt[g]]) >= 0)
        assert vlist[g, :vcnt[g]].max(initial=0) * tnk.T_TILE < live


@pytest.mark.parametrize("order", ["bound", "tile", "reverse"])
@pytest.mark.parametrize("cap", [None, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_walk_model_equals_plain(seed, cap, order):
    """Box lists + per-query point-to-box rejection + smallest packed
    (d^2, index): exactly ``nn1_plain``'s result, in any visiting order,
    at small tiles so that every list has many entries."""
    q, t, live = _morton_problem(seed, sentinels=cap is not None)
    args = (to_torch(q), to_torch(t), torch.tensor(live), cap)
    i_p, d_p = tnk.nn1_plain(*args, query_chunk=128, target_chunk=512)
    i_w, d_w, rows = tnk.nn1_walk_plain(*args, group=32, t_tile=64,
                                        order=order)
    np.testing.assert_array_equal(to_np(i_w), to_np(i_p))
    np.testing.assert_array_equal(to_np(d_w), to_np(d_p))
    assert int(rows.sum()) > 0
    if order == "bound" and cap is not None:
        # best-first under a cap: far fewer rows than brute force
        assert int(rows.sum()) < 0.5 * live * len(rows)


@pytest.mark.parametrize("order", ["bound", "reverse"])
def test_walk_model_ties_take_the_smallest_index(rng, order):
    """Duplicate target rows in different tiles: the smallest index wins,
    whichever tile is scanned first, as in ``nn1_plain`` and JAX's argmin."""
    t = rng.uniform(-5, 5, (512, 3)).astype(np.float32)
    t[300:364] = t[10:74]            # copies, three tiles later
    t[140] = t[500]                  # a copy before its original
    q = np.concatenate([t[10:74], t[500:501], t[200:230] + 0.01]
                       ).astype(np.float32)
    args = (to_torch(q), to_torch(t), None, 0.5)
    i_p, d_p = tnk.nn1_plain(*args)
    i_w, d_w, _ = tnk.nn1_walk_plain(*args, group=32, t_tile=64, order=order)
    np.testing.assert_array_equal(to_np(i_w), to_np(i_p))
    np.testing.assert_array_equal(to_np(d_w), to_np(d_p))
    assert to_np(i_w)[:64].tolist() == list(range(10, 74))
    assert to_np(i_w)[64] == 140


def test_walk_model_matches_xla_and_fused_interpret(rng, interpret):
    """The same seeded clouds as ``test_nn1_matches_fused_interpret`` and
    its capped twin, through the walk model, JAX's kernel in interpret mode
    and ``_nn1_xla``."""
    q, t = _clouds(rng)
    for cap in (0.8, None):
        md = None if cap is None else jnp.float32(cap)
        i_j, d_j = jnk.nn1_fused(jnp.asarray(q), jnp.asarray(t), max_dist=md)
        i_w, d_w, _ = tnk.nn1_walk_plain(to_torch(q), to_torch(t), None, cap)
        i_j, d_j, i_w, d_w = np.asarray(i_j), np.asarray(d_j), to_np(i_w), \
            to_np(d_w)
        c2 = np.inf if cap is None else cap * cap
        found = d_j < c2
        np.testing.assert_array_equal(d_w < c2, found)
        np.testing.assert_allclose(d_w[found], d_j[found], rtol=D_RTOL)
        tie = i_w != i_j
        np.testing.assert_allclose(d_w[tie & found], d_j[tie & found],
                                   rtol=D_RTOL)
        assert (i_w[~found] == 0).all()
    # the uncapped result against XLA's (expansion-based) search
    i_x, d_x = jn._nn1_xla(jnp.asarray(q), jnp.asarray(t), query_chunk=256,
                           target_chunk=512)
    np.testing.assert_array_equal(i_w, np.asarray(i_x))
    np.testing.assert_allclose(d_w, np.asarray(d_x), rtol=D_RTOL)


def test_walk_model_morton_padded_matches_fused_interpret(rng, interpret):
    """The padded Morton target with a dynamic ``t_count`` of
    ``test_nn1_morton_padded_t_count_matches_fused_interpret``."""
    q, t, live = _morton_problem(5, nq=512, sentinels=False)
    i_j, d_j = jnk.nn1_fused(jnp.asarray(q), jnp.asarray(t),
                             t_count=jnp.int32(live),
                             max_dist=jnp.float32(1.0))
    i_w, d_w, _ = tnk.nn1_walk_plain(to_torch(q), to_torch(t),
                                     torch.tensor(live), 1.0)
    i_j, d_j, i_w, d_w = np.asarray(i_j), np.asarray(d_j), to_np(i_w), \
        to_np(d_w)
    found = d_j < 1.0
    assert 0.8 < found.mean() < 1.0
    np.testing.assert_array_equal(d_w < 1.0, found)
    assert i_w.max() < live
    np.testing.assert_allclose(d_w[found], d_j[found], rtol=D_RTOL)
    tie = (i_w != i_j) & found
    np.testing.assert_allclose(d_w[tie], d_j[tie], rtol=D_RTOL)


@pytest.mark.parametrize("cap", [None, 0.5])
def test_needed_pairs_matches_brute_force(cap):
    q, t, live = _morton_problem(4)
    args = (to_torch(q), to_torch(t), torch.tensor(live), cap)
    _, sqd = tnk.nn1_plain(*args)
    got = tnk.needed_pairs(*args, sqd, t_tile=64, query_chunk=100)
    final = to_np(sqd).astype(np.float64)
    want = 0
    for t0 in range(0, live, 64):
        rows = t[t0:min(t0 + 64, live)]
        rows = rows[np.abs(rows).max(axis=1) < 1e5]
        if not len(rows):
            continue
        lo, hi = rows.min(axis=0), rows.max(axis=0)
        gap = np.maximum(np.maximum(lo - q, q - hi), 0).astype(np.float32)
        pb2 = gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1] \
            + gap[:, 2] * gap[:, 2]
        want += int((pb2 < final).sum()) * min(64, live - t0)
    assert got == want
    assert 0 < got < 0.2 * len(q) * live
