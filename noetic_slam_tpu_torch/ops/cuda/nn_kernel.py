"""Kernel A: fused exact 1-NN (``csrc/nn1.cu``) and its plain versions.

Replaces ``noetic_slam_tpu/ops/pallas/nn_kernel.py`` (``_nn_kernel``,
launched by ``nn1_fused``) together with the plain XLA code that builds its
visit lists. On the card the whole call is hand-written: one launch takes
the boxes of the target tiles, a second one builds each query group's
visit list (box-to-box bounds, candidates, a sort in shared memory), walks
it with a per-query point-to-box test, and writes the exact distances.
Design and what bounds it: the note at the top of ``csrc/nn1.cu``.

The plain versions here are what the CPU tests and the card checks hold the
kernel against: ``nn1_plain`` (chunked brute force, the reference result),
``visit_lists`` (the list build), ``nn1_walk_plain`` (the kernel's walk:
box lists, per-query rejection, smallest packed (d^2, index) wins) and
``needed_pairs`` (the work a per-query best-first walk needs: the kernel's
operation bound).

Dropped from the TPU version: the recentring (it conditioned the
``|q|^2 - 2 q.t + |t|^2`` expansion; the CUDA kernel takes plain
differences), the transposed ``(3, nt)`` target and the ``_FAR`` boxes
(VMEM lane padding), and the multiple-of-tile shape requirement (ragged
edges are masked in the kernel).

Contract, shared by ``nn1_fused``, ``nn1_plain`` and ``nn1_walk_plain``:
- uncapped, the result is the exact nearest neighbour; among equally near
  rows the smallest index;
- with ``max_dist``, a query with no target strictly inside the cap gets
  idx 0 and sqd = max_dist^2;
- target rows at or beyond ``t_count`` are never visited; the kernel and
  its walk model also never return a sentinel row (a coordinate at or
  beyond 1e5) below it, which ``nn1_plain`` would return only to a
  sentinel query or when no other row exists;
- sqd is recomputed at the winners from the original coordinates.
"""

from __future__ import annotations

import numpy as np
import torch

from noetic_slam_tpu_torch.ops.cuda import _build

Tensor = torch.Tensor

Q_GROUP = 32    # queries per CTA (one per lane); 32 * QPL in csrc/nn1.cu
T_TILE = 128    # target rows per tile; T_TILE in csrc/nn1.cu
_OK = 1e5       # coordinates at or beyond this are sentinel rows
_FAR2 = 1e17    # a box bound at or beyond this is never a candidate


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


def _target_boxes(target: Tensor, count: Tensor, t_tile: int):
    """(min, max) corners of each target tile's rows below ``count`` that
    are no sentinels."""
    rows = torch.arange(target.shape[0], device=target.device)
    tok = (torch.abs(target) < _OK).all(dim=-1) & (rows < count)
    return _tile_boxes(target, tok, t_tile)


def _box_dist2(lo_a: Tensor, hi_a: Tensor, lo_b: Tensor, hi_b: Tensor
               ) -> Tensor:
    """Squared distance between boxes a and b (a point is a box with
    lo = hi): 0 where they overlap, inf to an inverted box."""
    return sq_norm3(torch.clamp(torch.maximum(lo_b - hi_a, lo_a - hi_b),
                                min=0.0))


def visit_lists(query: Tensor, target: Tensor, count: Tensor, cap2: Tensor,
                q_tile: int = Q_GROUP, t_tile: int = T_TILE, *,
                per_query: bool = True, tile_chunk: int = 64):
    """(vlist (nqt, ntt) int32, vlb (nqt, ntt) f32, vcnt (nqt,) int32):
    per query tile, the candidate target tiles by ascending box-to-box
    lower bound (equal bounds by tile index). A target tile is a candidate
    iff it holds in-range rows, its bound beats the cap and, with
    ``per_query``, some query of the tile lies within the cap of its box.
    The plain version of the kernel's list build."""
    qok = (torch.abs(query) < _OK).all(dim=-1)
    tmin, tmax = _target_boxes(target, count, t_tile)
    qmin, qmax = _tile_boxes(query, qok, q_tile)
    lb2 = _box_dist2(qmin[:, None], qmax[:, None], tmin[None], tmax[None])
    nqt, ntt = lb2.shape
    t_in_range = torch.arange(ntt, device=target.device) * t_tile < count
    cut = torch.clamp(cap2, max=_FAR2)
    candidate = t_in_range[None] & (lb2 < cut)
    if per_query:
        pad = nqt * q_tile - query.shape[0]
        qt = torch.cat([query, query.new_full((pad, 3), torch.inf)]
                       ).reshape(nqt, q_tile, 1, 3)
        for g0 in range(0, nqt, tile_chunk):
            qc = qt[g0:g0 + tile_chunk]
            near = _box_dist2(qc, qc, tmin[None, None], tmax[None, None])
            candidate[g0:g0 + tile_chunk] &= (near < cut).any(dim=1)
    lb2 = torch.where(candidate, lb2, torch.inf)
    vlb, vlist = torch.sort(lb2, dim=1, stable=True)
    return (vlist.to(torch.int32).contiguous(), vlb.contiguous(),
            candidate.sum(dim=1).to(torch.int32))


def _finish(query: Tensor, target: Tensor, idx: Tensor, d: Tensor,
            cap2: Tensor) -> tuple[Tensor, Tensor]:
    """Exact sqd at the winners; not-found queries keep d (= cap^2)."""
    exact = sq_norm3(query - target[idx.long()])
    sqd = torch.where(torch.isfinite(cap2) & (d >= cap2), d, exact)
    return idx, sqd


def _count_arg(t_count, nt: int, dev):
    """``t_count`` as the kernel takes it: (device int32 tensor or None,
    host count used when the tensor is None)."""
    if isinstance(t_count, Tensor) and t_count.is_cuda:
        if t_count.numel() != 1:
            raise ValueError("nn1_fused: t_count must hold one element")
        return t_count.to(device=dev, dtype=torch.int32), 0
    n = nt if t_count is None else int(t_count)
    return None, max(0, min(n, nt))


def _cap_arg(max_dist, dev):
    """``max_dist`` as the kernel takes it: (device f32 tensor or None,
    host cap^2 used when the tensor is None; inf when uncapped)."""
    if max_dist is None:
        return None, float("inf")
    if isinstance(max_dist, Tensor) and max_dist.is_cuda:
        if max_dist.numel() != 1:
            raise ValueError("nn1_fused: max_dist must hold one element")
        return max_dist.to(device=dev, dtype=torch.float32), 0.0
    md = np.float32(float(max_dist))
    return None, float(md * md)


def _ptr(x: Tensor | None):
    return None if x is None else x.data_ptr()


def kernel_shape() -> dict:
    """The built kernel's shape: target rows a tile, queries a group (one
    CTA), warps a CTA, and the most target rows a call takes."""
    lib = _build.load()
    return {"tile": lib.nst_nn1_tile(), "group": lib.nst_nn1_group(),
            "warps": lib.nst_nn1_warps(), "max_rows": lib.nst_nn1_max_rows()}


def target_boxes(target: Tensor, t_count=None, *, lib=None) -> Tensor:
    """Launch 1 of a call: (ntt, 6) f32, min xyz and max xyz of each
    target tile's live rows. ``nn1_fused`` calls it; public so that a
    timing can take the two launches apart, and with ``lib`` so that a
    sweep can run another build of ``csrc/nn1.cu``."""
    lib = lib or _build.load()
    nt = target.shape[0]
    count, count_host = _count_arg(t_count, nt, target.device)
    tbox = torch.empty((-(-nt // lib.nst_nn1_tile()), 6),
                       dtype=torch.float32, device=target.device)
    with torch.cuda.device(target.device):
        err = lib.nst_nn1_boxes_launch(
            target.data_ptr(), nt, _ptr(count), count_host, tbox.data_ptr(),
            torch.cuda.current_stream(target.device).cuda_stream)
    _build.check(err, "nn1_fused (boxes)")
    return tbox


def walk(query: Tensor, target: Tensor, tbox: Tensor, t_count=None,
         max_dist=None, *, lib=None) -> tuple[Tensor, Tensor]:
    """Launch 2 of a call: list build, walk and exact distances, given the
    target boxes of ``target_boxes``."""
    lib = lib or _build.load()
    dev = query.device
    nq, nt = query.shape[0], target.shape[0]
    count, count_host = _count_arg(t_count, nt, dev)
    cap, cap2_host = _cap_arg(max_dist, dev)
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    sqd = torch.empty((nq,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.nst_nn1_walk_launch(
            query.data_ptr(), nq, target.data_ptr(), nt, _ptr(count),
            count_host, _ptr(cap), cap2_host, tbox.data_ptr(),
            idx.data_ptr(), sqd.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "nn1_fused (walk)")
    return idx, sqd


def nn1_fused(query: Tensor, target: Tensor, t_count=None, max_dist=None
              ) -> tuple[Tensor, Tensor]:
    """1-NN on the card through kernel A: (idx (Nq,) int32, sqd (Nq,) f32).

    Takes CUDA tensors only (float32, (N, 3), contiguous) and raises on
    anything else; there is no fallback. One call is two device launches
    (target boxes; list build + walk + exact distances) and two
    allocations; ``t_count`` (int32) and ``max_dist`` (float32) given as
    CUDA tensors are read on the device, with no launch of their own.
    ``launches`` counts calls."""
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
    max_rows = _build.load().nst_nn1_max_rows()
    if target.shape[0] > max_rows:
        raise ValueError(f"nn1_fused: target has {target.shape[0]} rows, "
                         f"the kernel takes at most {max_rows}")
    tbox = target_boxes(target, t_count)
    out = walk(query, target, tbox, t_count, max_dist)
    nn1_fused.launches += 1
    return out


nn1_fused.launches = 0


def nn1_plain(query: Tensor, target: Tensor, t_count=None, max_dist=None, *,
              query_chunk: int | None = None, target_chunk: int | None = None
              ) -> tuple[Tensor, Tensor]:
    """Plain torch version of kernel A: chunked brute force by direct
    differences, same contract. Each chunk's squared distances are built
    per coordinate, (dx*dx + dy*dy) + dz*dz (``sq_norm3``'s order). The
    chunks default to (256, 1024) on the CPU, where they stay in cache,
    and to (512, 8192) on the card, where each is a few launches.
    Reads ``t_count`` on the host."""
    dev = query.device
    if query_chunk is None:
        query_chunk = 512 if query.is_cuda else 256
    if target_chunk is None:
        target_chunk = 8192 if query.is_cuda else 1024
    nq, nt = query.shape[0], target.shape[0]
    limit = nt if t_count is None else max(0, min(int(t_count), nt))
    cap2 = _cap2(max_dist, dev)
    best_d = torch.full((nq,), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros((nq,), dtype=torch.int64, device=dev)
    tt = target[:limit].T.contiguous()                     # (3, limit)
    for q0 in range(0, nq, query_chunk):
        qc = query[q0:q0 + query_chunk]
        bd = best_d[q0:q0 + query_chunk]
        bi = best_i[q0:q0 + query_chunk]
        for t0 in range(0, limit, target_chunk):
            tx, ty, tz = tt[:, t0:t0 + target_chunk]
            d = qc[:, 0:1] - tx
            d.mul_(d)
            e = qc[:, 1:2] - ty
            d.add_(e.mul_(e))
            torch.sub(qc[:, 2:3], tz, out=e)
            d.add_(e.mul_(e))
            dmin, a = d.min(dim=1)
            better = dmin < bd
            bd.copy_(torch.where(better, dmin, bd))
            bi.copy_(torch.where(better, a + t0, bi))
    found = best_d < cap2
    idx = torch.where(found, best_i, 0).to(torch.int32)
    d = torch.where(found, best_d, cap2)
    return _finish(query, target, idx, d, cap2)


def nn1_walk_plain(query: Tensor, target: Tensor, t_count=None,
                   max_dist=None, *, group: int = Q_GROUP,
                   t_tile: int = T_TILE, order: str = "bound"):
    """Plain torch model of the kernel's walk, one warp per query group:
    (idx, sqd, rows (groups,) int64: the target rows each group scanned).

    Each group walks its visit list (``visit_lists``). A tile is scanned
    only if some query of the group needs it: its point-to-box squared
    distance is not above that query's current best. A scanned row
    replaces a query's best iff its packed (d^2, index) is smaller, which
    is what the kernel's 64-bit ``atomicMin`` does; the start (cap^2, 0)
    keeps idx 0 and cap^2 for a query with nothing strictly inside the
    cap. ``order``: "bound" walks best-first and stops a group at the
    first entry whose bound is above the group's worst best (the kernel);
    "tile" and "reverse" walk the same candidates by tile index and
    worst-first: the result must not depend on it."""
    dev = query.device
    nq, nt = query.shape[0], target.shape[0]
    count = _count(t_count, nt, dev)
    cap2 = _cap2(max_dist, dev)
    limit = torch.clamp(count, 0, nt)
    vlist, vlb, vcnt = visit_lists(query, target, count, cap2, group, t_tile)
    ng, ntt = vlist.shape
    vlist = vlist.long()
    pos = torch.arange(ntt, device=dev)
    if order == "tile":
        listed = torch.where(pos[None] < vcnt[:, None], vlist, ntt)
        vlist = torch.sort(listed, dim=1).values.clamp(max=ntt - 1)
    elif order == "reverse":
        back = (vcnt[:, None].long() - 1 - pos[None]).clamp(min=0)
        vlist, vlb = vlist.gather(1, back), vlb.gather(1, back)
    elif order != "bound":
        raise ValueError(f"nn1_walk_plain: order {order!r}")
    tmin, tmax = _target_boxes(target, count, t_tile)
    pad = ng * group - nq
    qg = torch.cat([query, query.new_zeros(pad, 3)]).reshape(ng, group, 3)
    has = (torch.arange(ng * group, device=dev) < nq).reshape(ng, group)
    best_d = cap2.expand(ng, group).clone()
    best_i = torch.zeros((ng, group), dtype=torch.int64, device=dev)
    alive = torch.ones(ng, dtype=torch.bool, device=dev)
    rows_scanned = torch.zeros(ng, dtype=torch.int64, device=dev)
    within = torch.arange(t_tile, device=dev)
    for p in range(int(vcnt.max()) if ng else 0):
        tile = vlist[:, p]
        if order == "bound":
            worst = torch.where(has, best_d, -torch.inf).amax(dim=1)
            alive = alive & ~(vlb[:, p] > worst)
        pb2 = _box_dist2(qg, qg, tmin[tile][:, None], tmax[tile][:, None])
        need = has & (pb2 <= best_d)
        visit = alive & (p < vcnt) & need.any(dim=1)
        rows = tile[:, None] * t_tile + within[None]            # (ng, tile)
        tt = target[rows.clamp(max=max(nt - 1, 0))]
        live = (rows < limit) & (torch.abs(tt) < _OK).all(dim=-1)
        d = sq_norm3(qg[:, :, None, :] - tt[:, None, :, :])
        d = torch.where(live[:, None, :], d, torch.inf)
        dmin, a = d.min(dim=2)                       # first minimum
        cand = tile[:, None] * t_tile + a
        better = (visit[:, None] & has
                  & ((dmin < best_d) | ((dmin == best_d) & (cand < best_i))))
        best_d = torch.where(better, dmin, best_d)
        best_i = torch.where(better, cand, best_i)
        rows_scanned += torch.where(visit, live.sum(dim=1), 0)
    idx = best_i.reshape(-1)[:nq].to(torch.int32)
    d = best_d.reshape(-1)[:nq]
    return (*_finish(query, target, idx, d, cap2), rows_scanned)


def needed_pairs(query: Tensor, target: Tensor, t_count, max_dist,
                 sqd: Tensor, *, t_tile: int = 256, query_chunk: int = 1024
                 ) -> int:
    """Query-target pairs a per-query best-first walk over ``t_tile``-row
    target tiles must evaluate: for each query, the live rows of the tiles
    whose point-to-box squared distance is below the query's final best
    (``sqd``, the call's result; cap^2 for a query that found nothing).
    Kernel A's operation bound counts these, whatever the kernel's own
    tiles are."""
    dev = query.device
    nt = target.shape[0]
    count = _count(t_count, nt, dev)
    cap2 = _cap2(max_dist, dev)
    tmin, tmax = _target_boxes(target, count, t_tile)
    ntt = tmin.shape[0]
    tile_rows = torch.clamp(torch.clamp(count, 0, nt).long()
                            - torch.arange(ntt, device=dev) * t_tile,
                            0, t_tile)
    final = torch.minimum(sqd, cap2)
    total = 0
    for q0 in range(0, query.shape[0], query_chunk):
        qc = query[q0:q0 + query_chunk, None, :]
        pb2 = _box_dist2(qc, qc, tmin[None], tmax[None])
        needed = pb2 < final[q0:q0 + query_chunk, None]
        total += int((needed * tile_rows[None]).sum())
    return total
