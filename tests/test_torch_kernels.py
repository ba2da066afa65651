"""Kernels A, B and C of the port against their plain versions, and the
plain versions against numpy loops. This file imports no JAX, so that the tests
marked ``cuda`` also run on a machine with a card and no JAX:

    python -m pytest -m cuda tests/test_torch_kernels.py

Without a card those tests skip; the plain-version tests run everywhere."""

import numpy as np
import pytest
import torch

from noetic_slam_tpu_torch.ops.cuda import logodds_kernel as lk
from noetic_slam_tpu_torch.ops.cuda import nn_kernel as nk
from noetic_slam_tpu_torch.ops.cuda import tsdf_kernel as tk

torch.set_num_threads(1)


# local helpers (not tests.torch_parity): this file must import on a machine
# where another installed package may own the name ``tests``
def to_torch(x, device="cpu"):
    return torch.from_numpy(np.array(x)).to(device)


def to_np(x):
    return x.detach().cpu().numpy()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel test)")
    return torch.device("cuda")


# Kernel vs plain: the same f32 formulas; the kernel sums a voxel's samples
# per part of an entry, tile by tile (a fixed tree over the tile's lanes of
# that voxel), then the parts' partials in part order, the plain version
# through index_add_ (another order on the card) -> rtol/atol 1e-5 as
# tests/test_tsdf_kernel.py. NN distances
# are bitwise equal by construction (no FMA contraction, same order), and
# the kernel returns the smallest index among equally near rows; 1e-5 and
# "idx equal or tied" leave room for the plain version's argmin on the
# card, which may take another of the tied rows.
TOL = 1e-5


def _nn_problem(rng, nq, nt, scale=5.0):
    t = (rng.normal(size=(nt, 3)) * scale).astype(np.float32)
    q = (t[rng.choice(nt, nq)] + rng.normal(0, 0.3, (nq, 3))
         ).astype(np.float32)
    return q, t


def _numpy_nn(q, t, count, cap):
    d = ((q[:, None, :].astype(np.float64) - t[None, :count]) ** 2).sum(-1)
    i = d.argmin(1)
    dmin = d[np.arange(len(q)), i]
    if cap is not None:
        miss = dmin >= cap * cap
        i = np.where(miss, 0, i)
        dmin = np.where(miss, np.float32(cap) ** 2, dmin)
    return i, dmin


def _stream(rng, C=64, A=24):
    """A block-sorted sample stream: A entries with disjoint ranges, some
    empty, rows unique."""
    cnt = rng.integers(0, 250, A)
    cnt[::5] = 0
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    S = int(cnt.sum()) + 7
    rows = rng.choice(C, A, replace=False)
    ivox = rng.integers(0, 512, S)
    w = rng.uniform(0.05, 1.0, S)
    wd = w * rng.uniform(-0.3, 0.3, S)
    i32 = lambda a: a.astype(np.int32)       # noqa: E731
    f32 = lambda a: a.astype(np.float32)     # noqa: E731
    return (i32(rows), i32(starts), i32(cnt), i32(ivox), f32(w), f32(wd))


def _numpy_accumulate(W, WS, rows, starts, cnts, ivox, w, wd, max_weight):
    """Kernel B in float64 numpy, on the voxels the samples hit only."""
    W, WS = W.astype(np.float64).copy(), WS.astype(np.float64).copy()
    for r, s0, c in zip(rows, starts, cnts):
        if c <= 0:
            continue
        aw = np.zeros(512)
        awd = np.zeros(512)
        np.add.at(aw, ivox[s0:s0 + c], w[s0:s0 + c])
        np.add.at(awd, ivox[s0:s0 + c], wd[s0:s0 + c])
        h = np.unique(ivox[s0:s0 + c])
        nw = W[r, h] + aw[h]
        nwd = WS[r, h] + awd[h]
        if max_weight >= tk.NO_CLAMP:
            W[r, h], WS[r, h] = nw, nwd
        else:
            cl = np.minimum(nw, max_weight)
            W[r, h], WS[r, h] = cl, nwd * cl / np.maximum(nw, 1e-12)
    return W, WS


def _numpy_logodds(L, rows, starts, cnts, ivox, delta, l_min, l_max):
    """Kernel C in float64 numpy, on the voxels the samples hit only."""
    L = L.astype(np.float64).copy()
    for r, s0, c in zip(rows, starts, cnts):
        if c <= 0:
            continue
        acc = np.zeros(512)
        np.add.at(acc, ivox[s0:s0 + c], delta[s0:s0 + c])
        h = np.unique(ivox[s0:s0 + c])
        L[r, h] = np.clip(L[r, h] + acc[h], l_min, l_max)
    return L


def _delta_stream(rng, sign, C=64, A=24):
    """``_stream``'s entries with occupancy deltas (hits and misses)."""
    rows, starts, cnts, ivox, w, _ = _stream(rng, C, A)
    delta = np.where(w > 0.5, 0.85, -0.4).astype(np.float32) * sign
    return rows, starts, cnts, ivox, delta


# (l_min, l_max, sign): the clamped update at the OccupancyConfig defaults,
# and the unclamped signed one (the +-1e30 clip is the identity)
LOGODDS_CASES = [(-2.0, 3.5, 1.0), (-lk.UNCLAMPED, lk.UNCLAMPED, -1.0)]


def _payload(rng, C=64, max_weight=3.0):
    """A TSDF payload a map can reach: weights in [0, max_weight], a quarter
    of them 0, and wsum 0 where the weight is 0."""
    W = rng.uniform(0, max_weight, (C, 512)).astype(np.float32)
    W[rng.random((C, 512)) < 0.25] = 0.0
    WS = (W * rng.uniform(-0.3, 0.3, (C, 512))).astype(np.float32)
    return W, WS


def _layout(rng, name, C=64):
    """(rows, starts, cnts, ivox) of one entry layout of kernels B and C:

    - random: ``_stream``'s entries (0-249 samples, every fifth empty);
    - long: entries of 4,203 samples (the largest block of an occupancy
      scan, around the sensor) and 20,000 among short ones, their voxels
      drawn from 64 so that most tiles merge lanes;
    - whole: one entry that holds the whole stream;
    - one_voxel: entries whose 32-sample tiles share one voxel, and one
      whose samples alternate between two;
    - edges: cnt 1, 31, 32 and 33, with empty entries (0 and negative)
      between them;
    - medium: 40 entries of up to 700 samples, a few empty, so that many
      long ones share a CTA and its rounds.

    Every layout but ``whole`` ends the stream with 7 samples no entry
    owns."""
    if name == "random":
        return _stream(rng, C)[:4]
    if name == "medium":
        cnts = rng.integers(200, 700, 40)
        cnts[::7] = 0
    else:
        cnts = {"long": [5, 4203, 0, 20000, 17, 250],
                "whole": [50000],
                "one_voxel": [96, 0, 32, 64, 40],
                "edges": [1, 0, 31, -3, 32, 0, 33, 0]}[name]
    cnts = np.asarray(cnts)
    real = np.maximum(cnts, 0)
    starts = np.concatenate([[0], np.cumsum(real)[:-1]])
    S = int(real.sum()) + (0 if name == "whole" else 7)
    rows = rng.choice(C, len(cnts), replace=False)
    ivox = rng.integers(0, 64 if name == "long" else 512, S)
    if name == "one_voxel":
        for s0, c in zip(starts[:-1], real[:-1]):
            ivox[s0:s0 + c] = rng.integers(512)
        ivox[starts[-1]:starts[-1] + real[-1]] = np.resize(
            rng.choice(512, 2, replace=False), real[-1])
    i32 = lambda a: a.astype(np.int32)       # noqa: E731
    return i32(rows), i32(starts), i32(cnts), i32(ivox)


LAYOUTS = ["random", "long", "whole", "one_voxel", "edges", "medium"]

# The four ways the maps call kernels B and C: (kernel, limits, sign). B
# clamped at 3.0, and at NO_CLAMP with sign -1 (the archive volume); C
# clamped at the OccupancyConfig defaults, and at +-1e30 with sign -1.
MODES = {
    "B_clamped": ("B", (3.0,), 1.0),
    "B_no_clamp": ("B", (tk.NO_CLAMP,), -1.0),
    "C_clamped": ("C", (-2.0, 3.5), 1.0),
    "C_signed": ("C", (-lk.UNCLAMPED, lk.UNCLAMPED), -1.0),
}
KERNELS = {"B": (tk.block_accumulate, tk.block_accumulate_plain),
           "C": (lk.logodds_accumulate, lk.logodds_accumulate_plain)}


def _problem(rng, kind, layout, sign, C=64):
    """(payload, stream) of kernel ``kind`` on one layout, as numpy: a
    payload a map can reach, and the stream's channels times ``sign``.
    The channels are multiples of 2^-12, so that a voxel's sum of a few
    hundred samples is exact in f32 in any order: the long layouts then
    test the kernel's bookkeeping, not the rounding of its order."""
    rows, starts, cnts, ivox = _layout(rng, layout, C)
    S = ivox.shape[0]
    if kind == "B":
        w = rng.uniform(0.05, 1.0, S)
        vals = (w * sign, w * rng.uniform(-0.3, 0.3, S) * sign)
        pay = _payload(rng, C)
    else:
        vals = (np.where(rng.random(S) < 0.3, 0.85, -0.4) * sign,)
        pay = (rng.uniform(-2.0, 3.5, (C, 512)),)
    f32 = lambda a: a.astype(np.float32)     # noqa: E731
    vals = [np.round(v * 4096) / 4096 for v in vals]
    return (tuple(map(f32, pay)),
            (rows, starts, cnts, ivox, *map(f32, vals)))


def _numpy_reference(kind, pay, stream, limits):
    if kind == "B":
        return list(_numpy_accumulate(*pay, *stream, *limits))
    return [_numpy_logodds(*pay, *stream, *limits)]


def _call(fn, pay, stream, limits):
    """``fn`` (a kernel or a plain version) on copies of the torch payload
    ``pay``; returns the updated payload as numpy."""
    out = [x.clone() for x in pay]
    fn(*out, *stream, *limits)
    return [to_np(x) for x in out]


def _hit_mask(stream, shape):
    """The payload voxels that some sample of a real entry hits."""
    rows, starts, cnts, ivox = stream[:4]
    hit = np.zeros(shape, bool)
    for r, s0, c in zip(rows, starts, cnts):
        if c > 0:
            hit[r, ivox[s0:s0 + c]] = True
    return hit


# ---------------------------------------------------------- plain versions

@pytest.mark.parametrize("cap,count", [(None, 700), (0.4, 700), (0.4, 0)])
def test_nn1_plain_matches_numpy(rng, cap, count):
    q, t = _nn_problem(rng, 150, 800)
    idx, sqd = nk.nn1_plain(to_torch(q), to_torch(t), torch.tensor(count),
                            cap, query_chunk=64, target_chunk=256)
    if count == 0:
        assert (to_np(idx) == 0).all()
        np.testing.assert_allclose(to_np(sqd), np.float32(cap) ** 2)
        return
    wi, wd = _numpy_nn(q, t, count, cap)
    np.testing.assert_allclose(to_np(sqd), wd, rtol=TOL, atol=1e-7)
    tie = to_np(idx) != wi
    d_at = ((q[tie] - t[to_np(idx)[tie]]) ** 2).sum(-1)
    np.testing.assert_allclose(d_at, wd[tie], rtol=TOL)


@pytest.mark.parametrize("max_weight", [3.0, tk.NO_CLAMP])
def test_block_accumulate_plain_matches_numpy(rng, max_weight):
    W, WS = _payload(rng)
    s = _stream(rng)
    sign = -1.0 if max_weight >= tk.NO_CLAMP else 1.0
    s = s[:4] + (s[4] * sign, s[5] * sign)
    want = _numpy_accumulate(W, WS, *s, max_weight)
    Wt, WSt = to_torch(W), to_torch(WS)
    tk.block_accumulate_plain(Wt, WSt, *(to_torch(a) for a in s), max_weight)
    np.testing.assert_allclose(to_np(Wt), want[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(WSt), want[1], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("l_min,l_max,sign", LOGODDS_CASES)
def test_logodds_accumulate_plain_matches_numpy(rng, l_min, l_max, sign):
    L = rng.uniform(-2.0, 3.5, (64, 512)).astype(np.float32)
    s = _delta_stream(rng, sign)
    want = _numpy_logodds(L, *s, l_min, l_max)
    Lt = to_torch(L)
    lk.logodds_accumulate_plain(Lt, *(to_torch(a) for a in s), l_min, l_max)
    np.testing.assert_allclose(to_np(Lt), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_block_plain_matches_numpy_on_layouts(rng, mode, layout):
    kind, limits, sign = MODES[mode]
    pay, s = _problem(rng, kind, layout, sign)
    want = _numpy_reference(kind, pay, s, limits)
    got = _call(KERNELS[kind][1], [to_torch(p) for p in pay],
                [to_torch(a) for a in s], limits)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["plain",
                                  pytest.param("kernel",
                                               marks=pytest.mark.cuda)])
@pytest.mark.parametrize("kind", ["B", "C"])
def test_unhit_voxels_keep_their_value(request, rng, kind, impl):
    """The hit-voxel contract: a voxel of a touched row that no sample hits
    keeps its value bitwise, even where it lies outside what a map can
    reach (a weight above max_weight, wsum where the weight is 0, log-odds
    outside [l_min, l_max]) and the epilogue would move it."""
    dev = request.getfixturevalue("cuda_device") if impl == "kernel" else "cpu"
    _, limits, sign = MODES[f"{kind}_clamped"]
    pay, s = _problem(rng, kind, "random", sign)
    pay = tuple(np.where(rng.random(p.shape) < 0.5, 9.0, -7.0)
                .astype(np.float32) for p in pay)
    fn = KERNELS[kind][0 if impl == "kernel" else 1]
    out = _call(fn, [to_torch(p, dev) for p in pay],
                [to_torch(a, dev) for a in s], limits)
    hit = _hit_mask(s, pay[0].shape)
    assert 0 < hit.sum() < hit.size
    for o, p in zip(out, pay):
        np.testing.assert_array_equal(o[~hit], p[~hit])
        assert not np.array_equal(o[hit], p[hit])       # the clamp moved them


def test_wrappers_reject_cpu_tensors(rng):
    q, t = _nn_problem(rng, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        nk.nn1_fused(to_torch(q), to_torch(t))
    W, WS = _payload(rng, C=8)
    s = _stream(rng, C=8, A=4)
    with pytest.raises(ValueError, match="CUDA"):
        tk.block_accumulate(to_torch(W), to_torch(WS),
                            *(to_torch(a) for a in s), 3.0)
    with pytest.raises(ValueError, match="CUDA"):
        lk.logodds_accumulate(to_torch(W), *(to_torch(a) for a in
                                             _delta_stream(rng, 1.0, C=8,
                                                           A=4)), -2.0, 3.5)


# ------------------------------------------------------- kernels, on card

@pytest.mark.cuda
@pytest.mark.parametrize("nq,nt,count,cap", [
    (1000, 5000, 4500, None), (1000, 5000, 4500, 0.3), (4096, 20000, 20000, 0.5),
    (37, 300, 0, 0.5), (1, 1, 1, None)])
def test_nn1_kernel_matches_plain(rng, cuda_device, nq, nt, count, cap):
    q, t = _nn_problem(rng, nq, nt)
    qd, td = to_torch(q, cuda_device), to_torch(t, cuda_device)
    cnt = torch.tensor(count, device=cuda_device)
    before = nk.nn1_fused.launches
    i_k, d_k = nk.nn1_fused(qd, td, cnt, cap)
    assert nk.nn1_fused.launches == before + 1
    i_p, d_p = nk.nn1_plain(qd, td, cnt, cap)
    torch.cuda.synchronize()
    i_k, d_k, i_p, d_p = map(to_np, (i_k, d_k, i_p, d_p))
    c2 = np.inf if cap is None else np.float32(cap) ** 2
    np.testing.assert_array_equal(d_k < c2, d_p < c2)
    np.testing.assert_allclose(d_k, d_p, rtol=TOL)
    tie = i_k != i_p
    np.testing.assert_allclose(d_k[tie], d_p[tie], rtol=TOL)
    if count:
        assert i_k.max() < count


def _morton(x):
    from noetic_slam_tpu_torch.ops.pointcloud import morton_sort_key

    xt = to_torch(x)
    key = morton_sort_key(xt, torch.ones(len(x), dtype=torch.bool), 1.0)
    return x[to_np(torch.sort(key, stable=True).indices)]


def _nn_layout(rng, name):
    """(query, target, t_count, cap) of one layout chosen to break kernel
    A's design:

    - spanning_group: Morton-sorted clouds, but one 32-query group drawn
      from all over the target, so that its box touches every tile and
      only the per-query test prunes;
    - none_found: every query ~10 m from every target, under a cap;
    - ragged: sizes that are multiples of no tile, ``t_count`` inside a
      tile;
    - outlier: uncapped, one query 500 m away (its walk visits all);
    - sentinels: sentinel rows among the queries and behind ``t_count``;
    - offset: both clouds 3,000 m from the origin."""
    if name == "spanning_group":
        t = _morton((rng.uniform(-30, 30, (40000, 3))).astype(np.float32))
        q = _morton(t[rng.choice(40000, 2048)]
                    + rng.normal(0, 0.05, (2048, 3)).astype(np.float32))
        q[96:128] = t[rng.choice(40000, 32)] + np.float32(0.01)
        return q, t, 40000, 0.5
    if name == "none_found":
        q, t = _nn_problem(rng, 700, 3000)
        return q + np.float32(100.0), t, 3000, 0.5
    if name == "ragged":
        q, t = _nn_problem(rng, 1237, 7001)
        return q, t, 6999, 0.6
    if name == "outlier":
        q, t = _nn_problem(rng, 500, 6000)
        q[123] = (500.0, -20.0, 3.0)
        return q, t, 6000, None
    if name == "sentinels":
        q, t = _nn_problem(rng, 900, 5000)
        q[rng.choice(900, 40, replace=False)] = 1.0e6
        t[4600:] = 1.0e6
        return q, t, 4600, 0.4
    if name == "offset":
        q, t = _nn_problem(rng, 800, 5000)
        return q + np.float32(3000.0), t + np.float32(3000.0), 5000, 0.6
    raise ValueError(name)


NN_LAYOUTS = ["spanning_group", "none_found", "ragged", "outlier",
              "sentinels", "offset"]


def _nn_kernel_vs_plain(q, t, count, cap, dev, count_as_tensor=True):
    """Kernel A twice and ``nn1_plain`` once: one counted call each, the
    two runs bitwise equal, found sets equal, not-found idx 0 with
    sqd = cap^2, sqd within TOL, idx equal or tied. Returns the kernel's
    (idx, sqd) as numpy."""
    qd, td = to_torch(q, dev), to_torch(t, dev)
    cnt = (torch.tensor(count, dtype=torch.int32, device=dev)
           if count_as_tensor else count)
    runs = []
    for _ in range(2):
        before = nk.nn1_fused.launches
        runs.append(nk.nn1_fused(qd, td, cnt, cap))
        assert nk.nn1_fused.launches == before + 1
    i_p, d_p = nk.nn1_plain(qd, td, cnt, cap)
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    i_k, d_k, i_p, d_p = map(to_np, (*runs[0], i_p, d_p))
    assert i_k.dtype == np.int32 and d_k.dtype == np.float32
    c2 = np.inf if cap is None else np.float32(float(cap)) ** 2
    np.testing.assert_array_equal(d_k < c2, d_p < c2)
    np.testing.assert_allclose(d_k, d_p, rtol=TOL)
    tie = i_k != i_p
    np.testing.assert_allclose(d_k[tie], d_p[tie], rtol=TOL)
    if cap is not None:
        miss = ~(d_k < c2)
        assert (i_k[miss] == 0).all() and (d_k[miss] == c2).all()
    if count:
        assert i_k.max() < count
    return i_k, d_k


@pytest.mark.cuda
def test_nn1_kernel_shape_matches_the_plain_constants(cuda_device):
    shape = nk.kernel_shape()
    assert shape["tile"] == nk.T_TILE and shape["group"] == nk.Q_GROUP
    assert shape["warps"] >= 1 and shape["max_rows"] >= 262144


@pytest.mark.cuda
@pytest.mark.parametrize("layout", NN_LAYOUTS)
def test_nn1_kernel_matches_plain_on_layouts(rng, cuda_device, layout):
    q, t, count, cap = _nn_layout(rng, layout)
    i_k, d_k = _nn_kernel_vs_plain(q, t, count, cap, cuda_device)
    c2 = np.inf if cap is None else np.float32(cap) ** 2
    if layout == "none_found":
        assert not (d_k < c2).any()
    elif layout == "spanning_group":
        assert (d_k[96:128] < c2).all()
    elif layout == "sentinels":
        assert not (d_k[np.abs(q).max(axis=1) > 1e5] < c2).any()
        assert (d_k < c2).sum() > 400
    elif layout == "outlier":
        assert d_k[123] > 400.0 ** 2
    else:
        assert (d_k < c2).mean() > 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("as_tensor", [True, False])
@pytest.mark.parametrize("count", [0, 1, 255, 256, 257])
def test_nn1_kernel_t_count_edges(rng, cuda_device, count, as_tensor):
    """``t_count`` at a tile's edges, as a device tensor and as a host
    integer; the cap as a device tensor."""
    q, t = _nn_problem(rng, 300, 600, scale=1.0)
    cap = torch.tensor(0.8, device=cuda_device)
    i_k, d_k = _nn_kernel_vs_plain(q, t, count, cap, cuda_device, as_tensor)
    if count == 0:
        assert (i_k == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 0.5])
def test_nn1_kernel_duplicate_rows_take_the_lowest_index(rng, cuda_device,
                                                         cap):
    """Copies of a row in other tiles, before and after the original: the
    smallest index wins whichever warp scans which tile first."""
    t = rng.uniform(-5, 5, (4096, 3)).astype(np.float32)
    t[3000:3064] = t[10:74]
    t[140] = t[4000]
    t[2000:2300] = t[700]                   # one point, 301 times
    q = np.concatenate([t[10:74], t[4000:4001], t[700:701],
                        t[200:230] + np.float32(0.01)])
    i_k, d_k = _nn_kernel_vs_plain(q, t, 4096, cap, cuda_device)
    assert i_k[:64].tolist() == list(range(10, 74))
    assert i_k[64] == 140 and i_k[65] == 700
    assert (d_k[:66] == 0).all()


@pytest.mark.cuda
def test_nn1_kernel_rejects_bad_input(rng, cuda_device):
    q, t = _nn_problem(rng, 16, 64)
    with pytest.raises(ValueError, match="float32"):
        nk.nn1_fused(to_torch(q, cuda_device).double(),
                     to_torch(t, cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        nk.nn1_fused(to_torch(np.repeat(q, 2, 0), cuda_device)[::2],
                     to_torch(t, cuda_device))


def _kernel_vs_plain(kind, pay, s, limits, dev):
    """Kernel ``kind`` twice and its plain version once, each on a copy of
    ``pay``: one launch per call, the two runs bitwise equal (the sums'
    order is fixed), the plain version within TOL, and every voxel no
    sample hits (untouched rows included) unchanged bitwise. Returns the
    kernel's payload."""
    kernel, plain = KERNELS[kind]
    pay_t = [to_torch(p, dev) for p in pay]
    s_t = [to_torch(a, dev) for a in s]
    runs = []
    for _ in range(2):
        before = kernel.launches
        runs.append(_call(kernel, pay_t, s_t, limits))
        assert kernel.launches == before + 1
    want = _call(plain, pay_t, s_t, limits)
    hit = _hit_mask(s, pay[0].shape)
    for a, b, p, x in zip(runs[0], runs[1], want, pay):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, p, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(a[~hit], x[~hit])
    return runs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("max_weight", [3.0, tk.NO_CLAMP])
def test_block_accumulate_kernel_matches_plain(rng, cuda_device, max_weight):
    W, WS = _payload(rng)
    s = _stream(rng)
    sign = -1.0 if max_weight >= tk.NO_CLAMP else 1.0
    s = s[:4] + (s[4] * sign, s[5] * sign)
    out = _kernel_vs_plain("B", (W, WS), s, (max_weight,), cuda_device)
    if max_weight < tk.NO_CLAMP:
        assert out[0].max() <= max_weight
    else:
        assert out[0].min() < 0.0           # signed weights, no clamp


@pytest.mark.cuda
@pytest.mark.parametrize("l_min,l_max,sign", LOGODDS_CASES)
def test_logodds_accumulate_kernel_matches_plain(rng, cuda_device, l_min,
                                                 l_max, sign):
    L = rng.uniform(-2.0, 3.5, (64, 512)).astype(np.float32)
    (out,) = _kernel_vs_plain("C", (L,), _delta_stream(rng, sign),
                              (l_min, l_max), cuda_device)
    if l_max < lk.UNCLAMPED:
        assert out.min() >= l_min and out.max() <= l_max
    else:
        assert out.min() < -2.0             # the clip was the identity


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_block_kernels_match_plain_on_layouts(rng, cuda_device, mode,
                                              layout):
    """Kernels B and C on the layouts that stress the warp cut (long and
    whole-stream entries), the in-warp merge (a tile of one voxel) and the
    tile edges (cnt 1, 31, 32, 33 among empty entries)."""
    kind, limits, sign = MODES[mode]
    pay, s = _problem(rng, kind, layout, sign)
    out = _kernel_vs_plain(kind, pay, s, limits, cuda_device)
    if mode == "B_clamped":
        assert out[0].max() <= limits[0]
    if mode == "C_clamped":
        assert out[0].min() >= limits[0] and out[0].max() <= limits[1]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["B", "C"])
def test_block_kernels_cancel_exactly(rng, cuda_device, kind, layout):
    """Unclamped (B at NO_CLAMP, C at +-1e30): a stream fused with sign +1
    and then -1 into a zero payload returns it to exactly 0.0, which the
    keyframe archive's de-fusion relies on."""
    mode = "B_no_clamp" if kind == "B" else "C_signed"
    _, limits, _ = MODES[mode]
    pay, s = _problem(rng, kind, layout, 1.0)
    kernel = KERNELS[kind][0]
    out = [torch.zeros(p.shape, device=cuda_device) for p in pay]
    s_t = [to_torch(a, cuda_device) for a in s]
    kernel(*out, *s_t, *limits)
    assert any(bool((x != 0).any()) for x in out)
    kernel(*out, *s_t[:4], *(-x for x in s_t[4:]), *limits)
    for x in out:
        assert bool((x == 0).all()), float(x.abs().max())


@pytest.mark.cuda
def test_logodds_accumulate_kernel_rejects_bad_input(rng, cuda_device):
    L = to_torch(np.zeros((8, 512), np.float32), cuda_device)
    s = [to_torch(a, cuda_device) for a in _delta_stream(rng, 1.0, C=8, A=4)]
    with pytest.raises(ValueError, match="int32"):
        lk.logodds_accumulate(L, s[0].long(), *s[1:], -2.0, 3.5)
    with pytest.raises(ValueError, match="lengths differ"):
        lk.logodds_accumulate(L, *s[:4], s[4][:-1], -2.0, 3.5)
