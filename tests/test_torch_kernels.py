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
# in stream order, the plain version through index_add_ (another order on
# the card) -> rtol/atol 1e-5 as tests/test_tsdf_kernel.py. NN distances
# are bitwise equal by construction (no FMA contraction, same order); 1e-5
# covers the recomputation at a tied winner.
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
    W, WS = W.astype(np.float64).copy(), WS.astype(np.float64).copy()
    for r, s0, c in zip(rows, starts, cnts):
        if c <= 0:
            continue
        aw = np.zeros(512)
        awd = np.zeros(512)
        np.add.at(aw, ivox[s0:s0 + c], w[s0:s0 + c])
        np.add.at(awd, ivox[s0:s0 + c], wd[s0:s0 + c])
        nw = W[r] + aw
        nwd = WS[r] + awd
        if max_weight >= tk.NO_CLAMP:
            W[r], WS[r] = nw, nwd
        else:
            cl = np.minimum(nw, max_weight)
            W[r], WS[r] = cl, nwd * cl / np.maximum(nw, 1e-12)
    return W, WS


def _numpy_logodds(L, rows, starts, cnts, ivox, delta, l_min, l_max):
    L = L.astype(np.float64).copy()
    for r, s0, c in zip(rows, starts, cnts):
        if c <= 0:
            continue
        acc = np.zeros(512)
        np.add.at(acc, ivox[s0:s0 + c], delta[s0:s0 + c])
        L[r] = np.clip(L[r] + acc, l_min, l_max)
    return L


def _delta_stream(rng, sign, C=64, A=24):
    """``_stream``'s entries with occupancy deltas (hits and misses)."""
    rows, starts, cnts, ivox, w, _ = _stream(rng, C, A)
    delta = np.where(w > 0.5, 0.85, -0.4).astype(np.float32) * sign
    return rows, starts, cnts, ivox, delta


# (l_min, l_max, sign): the clamped update at the OccupancyConfig defaults,
# and the unclamped signed one (the +-1e30 clip is the identity)
LOGODDS_CASES = [(-2.0, 3.5, 1.0), (-lk.UNCLAMPED, lk.UNCLAMPED, -1.0)]


def _payload(rng, C=64):
    W = rng.uniform(0, 4.0, (C, 512)).astype(np.float32)
    WS = (W * rng.uniform(-0.3, 0.3, (C, 512))).astype(np.float32)
    return W, WS


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


@pytest.mark.cuda
def test_nn1_kernel_rejects_bad_input(rng, cuda_device):
    q, t = _nn_problem(rng, 16, 64)
    with pytest.raises(ValueError, match="float32"):
        nk.nn1_fused(to_torch(q, cuda_device).double(),
                     to_torch(t, cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        nk.nn1_fused(to_torch(np.repeat(q, 2, 0), cuda_device)[::2],
                     to_torch(t, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("max_weight", [3.0, tk.NO_CLAMP])
def test_block_accumulate_kernel_matches_plain(rng, cuda_device, max_weight):
    W, WS = _payload(rng)
    s = _stream(rng)
    sign = -1.0 if max_weight >= tk.NO_CLAMP else 1.0
    s = tuple(to_torch(a, cuda_device) for a in s[:4] + (s[4] * sign,
                                                         s[5] * sign))
    out = []
    for fn in (tk.block_accumulate, tk.block_accumulate,
               tk.block_accumulate_plain):
        a, b = to_torch(W, cuda_device), to_torch(WS, cuda_device)
        fn(a, b, *s, max_weight)
        out.append((to_np(a), to_np(b)))
    # deterministic run to run (no atomics): bitwise equal
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    for x, y in zip(out[0], out[2]):
        np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL)
    # untouched rows are never written
    touched = np.zeros(W.shape[0], bool)
    touched[to_np(s[0])[to_np(s[2]) > 0]] = True
    np.testing.assert_array_equal(out[0][0][~touched], W[~touched])


@pytest.mark.cuda
@pytest.mark.parametrize("l_min,l_max,sign", LOGODDS_CASES)
def test_logodds_accumulate_kernel_matches_plain(rng, cuda_device, l_min,
                                                 l_max, sign):
    L = rng.uniform(-2.0, 3.5, (64, 512)).astype(np.float32)
    s = tuple(to_torch(a, cuda_device) for a in _delta_stream(rng, sign))
    out = []
    for fn in (lk.logodds_accumulate, lk.logodds_accumulate,
               lk.logodds_accumulate_plain):
        a = to_torch(L, cuda_device)
        before = lk.logodds_accumulate.launches
        fn(a, *s, l_min, l_max)
        if fn is lk.logodds_accumulate:
            assert lk.logodds_accumulate.launches == before + 1
        out.append(to_np(a))
    # deterministic run to run (no atomics): bitwise equal
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_allclose(out[0], out[2], rtol=TOL, atol=TOL)
    touched = np.zeros(L.shape[0], bool)
    touched[to_np(s[0])[to_np(s[2]) > 0]] = True
    np.testing.assert_array_equal(out[0][~touched], L[~touched])
    if l_max < lk.UNCLAMPED:
        assert out[0].min() >= l_min and out[0].max() <= l_max
    else:
        assert out[0].min() < -2.0          # the clip was the identity


@pytest.mark.cuda
def test_logodds_accumulate_kernel_rejects_bad_input(rng, cuda_device):
    L = to_torch(np.zeros((8, 512), np.float32), cuda_device)
    s = [to_torch(a, cuda_device) for a in _delta_stream(rng, 1.0, C=8, A=4)]
    with pytest.raises(ValueError, match="int32"):
        lk.logodds_accumulate(L, s[0].long(), *s[1:], -2.0, 3.5)
    with pytest.raises(ValueError, match="lengths differ"):
        lk.logodds_accumulate(L, *s[:4], s[4][:-1], -2.0, 3.5)
