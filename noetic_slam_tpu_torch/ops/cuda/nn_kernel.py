"""Kernel A: fused exact 1-NN (``csrc/nn1.cu``) and its plain version.

Replaces ``noetic_slam_tpu/ops/pallas/nn_kernel.py`` (``_nn_kernel``,
launched by ``nn1_fused``). The visit-list construction stays plain tensor
code here, as it was plain XLA in JAX: per-tile axis-aligned boxes of
queries and targets, the box-to-box squared lower bound for every (query
tile, target tile) pair, and per query tile the candidate target tiles
sorted by that bound. The kernel walks each list best-first and stops at
the first bound that cannot beat the tile's worst current best.

Dropped from the TPU version: the recentring (it conditioned the
``|q|^2 - 2 q.t + |t|^2`` expansion; the CUDA kernel takes plain
differences), the transposed ``(3, nt)`` target and the ``_FAR`` boxes
(VMEM lane padding), and the multiple-of-tile shape requirement (ragged
edges are masked in the kernel).

What bounds it on the card, and what the design does about it: see the
note at the top of ``csrc/nn1.cu``.

Contract, shared by ``nn1_fused`` and ``nn1_plain``:
- uncapped, the result is the exact nearest neighbour (ties aside);
- with ``max_dist``, a query with no target strictly inside the cap gets
  idx 0 and sqd = max_dist^2;
- target rows at or beyond ``t_count`` are never visited;
- sqd is recomputed at the winners from the original coordinates.
"""

from __future__ import annotations

import torch

from noetic_slam_tpu_torch.ops.cuda import _build

Tensor = torch.Tensor

Q_TILE = 64     # queries per CTA (one thread each)
T_TILE = 256    # target rows per visited tile; NN_T_TILE in csrc/nn1.cu
_OK = 1e5       # coordinates at or beyond this are sentinel rows


def sq_norm3(d: Tensor) -> Tensor:
    """x^2 + y^2 + z^2 of (..., 3) summed left to right: the order the
    kernel uses, so kernel, plain version and recomputation agree bitwise."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _cap2(max_dist, device) -> Tensor:
    if max_dist is None:
        return torch.full((1,), torch.inf, dtype=torch.float32, device=device)
    md = torch.as_tensor(max_dist, dtype=torch.float32, device=device)
    return (md * md).reshape(1)


def _count(t_count, nt: int, device) -> Tensor:
    if t_count is None:
        return torch.full((1,), nt, dtype=torch.int32, device=device)
    return torch.as_tensor(t_count, device=device).to(torch.int32).reshape(1)


def _tile_boxes(x: Tensor, ok: Tensor, tile: int) -> tuple[Tensor, Tensor]:
    """Per-tile (min, max) corners over rows with ``ok``; a tile without
    such rows gets the inverted box (+inf, -inf)."""
    n = x.shape[0]
    pad = (-n) % tile
    if pad:
        x = torch.cat([x, x.new_zeros(pad, 3)])
        ok = torch.cat([ok, ok.new_zeros(pad)])
    x = x.reshape(-1, tile, 3)
    ok = ok.reshape(-1, tile, 1)
    return (torch.where(ok, x, torch.inf).amin(dim=1),
            torch.where(ok, x, -torch.inf).amax(dim=1))


def visit_lists(query: Tensor, target: Tensor, count: Tensor, cap2: Tensor,
                q_tile: int = Q_TILE, t_tile: int = T_TILE):
    """(vlist (nqt, ntt) int32, vlb (nqt, ntt) f32, vcnt (nqt,) int32):
    per query tile, the candidate target tiles by ascending lower bound.
    A target tile is a candidate iff it holds in-range rows and its bound
    beats the cap."""
    nt = target.shape[0]
    rows = torch.arange(nt, device=target.device)
    tok = (torch.abs(target) < _OK).all(dim=-1) & (rows < count)
    qok = (torch.abs(query) < _OK).all(dim=-1)
    tmin, tmax = _tile_boxes(target, tok, t_tile)
    qmin, qmax = _tile_boxes(query, qok, q_tile)
    lb = torch.clamp(torch.maximum(tmin[None] - qmax[:, None],
                                   qmin[:, None] - tmax[None]), min=0.0)
    lb2 = sq_norm3(lb)                                     # (nqt, ntt)
    ntt = tmin.shape[0]
    t_in_range = torch.arange(ntt, device=target.device) * t_tile < count
    candidate = t_in_range[None] & (lb2 < torch.clamp(cap2, max=1e17))
    lb2 = torch.where(candidate, lb2, torch.inf)
    vlb, vlist = torch.sort(lb2, dim=1)
    return (vlist.to(torch.int32).contiguous(), vlb.contiguous(),
            candidate.sum(dim=1).to(torch.int32))


def _finish(query: Tensor, target: Tensor, idx: Tensor, d: Tensor,
            cap2: Tensor) -> tuple[Tensor, Tensor]:
    """Exact sqd at the winners; not-found queries keep d (= cap^2)."""
    exact = sq_norm3(query - target[idx.long()])
    sqd = torch.where(torch.isfinite(cap2) & (d >= cap2), d, exact)
    return idx, sqd


def nn1_fused(query: Tensor, target: Tensor, t_count=None, max_dist=None
              ) -> tuple[Tensor, Tensor]:
    """1-NN on the card through kernel A: (idx (Nq,) int32, sqd (Nq,) f32).

    Takes CUDA tensors only (float32, (N, 3), contiguous) and raises on
    anything else; there is no fallback."""
    for name, x in (("query", query), ("target", target)):
        if not x.is_cuda:
            raise ValueError(f"nn1_fused: {name} must be a CUDA tensor")
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"nn1_fused: {name} must be float32 (N, 3), "
                             f"got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"nn1_fused: {name} must be contiguous")
    if query.device != target.device:
        raise ValueError("nn1_fused: query and target on different devices")
    dev = query.device
    nq, nt = query.shape[0], target.shape[0]
    count = _count(t_count, nt, dev)
    cap2 = _cap2(max_dist, dev)
    vlist, vlb, vcnt = visit_lists(query, target, count, cap2)
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    d = torch.empty((nq,), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nst_nn1_launch(
            query.data_ptr(), nq, target.data_ptr(), nt, count.data_ptr(),
            cap2.data_ptr(), vlist.data_ptr(), vlb.data_ptr(),
            vcnt.data_ptr(), vlist.shape[1], Q_TILE, T_TILE,
            idx.data_ptr(), d.data_ptr(), stream)
    _build.check(err, "nn1_fused")
    nn1_fused.launches += 1
    return _finish(query, target, idx, d, cap2)


nn1_fused.launches = 0


def nn1_plain(query: Tensor, target: Tensor, t_count=None, max_dist=None, *,
              query_chunk: int = 512, target_chunk: int = 8192
              ) -> tuple[Tensor, Tensor]:
    """Plain torch version of kernel A: chunked brute force by direct
    differences (the chunking of JAX's ``_nn1_xla``), same contract.
    Reads ``t_count`` on the host."""
    dev = query.device
    nq, nt = query.shape[0], target.shape[0]
    limit = nt if t_count is None else max(0, min(int(t_count), nt))
    cap2 = _cap2(max_dist, dev)
    best_d = torch.full((nq,), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros((nq,), dtype=torch.int64, device=dev)
    for q0 in range(0, nq, query_chunk):
        qc = query[q0:q0 + query_chunk]
        bd = best_d[q0:q0 + query_chunk]
        bi = best_i[q0:q0 + query_chunk]
        for t0 in range(0, limit, target_chunk):
            tc = target[t0:min(t0 + target_chunk, limit)]
            dmin, a = sq_norm3(qc[:, None, :] - tc[None, :, :]).min(dim=1)
            better = dmin < bd
            bd.copy_(torch.where(better, dmin, bd))
            bi.copy_(torch.where(better, a + t0, bi))
    found = best_d < cap2
    idx = torch.where(found, best_i, 0).to(torch.int32)
    d = torch.where(found, best_d, cap2)
    return _finish(query, target, idx, d, cap2)
