"""Nearest-neighbour search (port of ``noetic_slam_tpu.ops.neighbors``).

``nn1`` finds GICP's correspondences in every outer LM iteration. A CUDA
tensor goes to kernel A (``ops.cuda.nn_kernel.nn1_fused``); a CPU tensor
goes to its plain version (``nn1_plain``). The JAX module's TPU shape gate
is gone: the CUDA kernel masks ragged edges itself.

``knn`` serves ``ops.gicp.plane_covariances`` (the keyframe archive's
closure path): a chunked running top-k in plain torch, as in the JAX
module, where no Pallas kernel computes it either.
"""

from __future__ import annotations

import torch

from noetic_slam_tpu_torch.ops.cuda.nn_kernel import nn1_fused, nn1_plain

Tensor = torch.Tensor


def nn1(query: Tensor, target: Tensor, t_count=None, max_dist=None
        ) -> tuple[Tensor, Tensor]:
    """1-NN of each query in ``target``: (idx (Nq,) int32, sqd (Nq,) f32).

    ``t_count``: rows at or beyond it are never visited. ``max_dist``: a
    query with no target strictly inside it gets idx 0 and
    sqd = max_dist^2 (callers threshold on sqd)."""
    if query.is_cuda:
        return nn1_fused(query, target, t_count, max_dist)
    return nn1_plain(query, target, t_count, max_dist)


def _center(query: Tensor) -> Tensor:
    """Centroid of the non-sentinel queries."""
    w = (torch.abs(query) < 1e5).all(dim=-1).to(query.dtype)
    return torch.sum(query * w[:, None], dim=0) / torch.clamp(w.sum(),
                                                              min=1.0)


def _pad_to_multiple(x: Tensor, chunk: int) -> Tensor:
    rem = (-x.shape[0]) % chunk
    if rem:
        x = torch.cat([x, x.new_full((rem, 3), 1e7)])
    return x


def knn(query: Tensor, target: Tensor, k: int, *, query_chunk: int = 512,
        target_chunk: int = 8192) -> tuple[Tensor, Tensor]:
    """k-NN with a running top-k across target chunks: (idx (Nq, k) int64,
    sqd (Nq, k) f32), sorted ascending by distance.

    Distances inside the search are the centred expansion |q|^2 - 2 q.t +
    |t|^2 (both clouds centred on the query centroid, as in JAX); the
    winners' squared distances are then recomputed by direct differences
    and sorted."""
    nq = query.shape[0]
    c = _center(query)
    tp = _pad_to_multiple(target, target_chunk)
    tc_all = tp - c
    tt_all = torch.sum(tc_all * tc_all, dim=-1)
    best_d = torch.full((nq, k), torch.inf, dtype=torch.float32,
                        device=query.device)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=query.device)
    for q0 in range(0, nq, query_chunk):
        qc = query[q0:q0 + query_chunk] - c
        qq = torch.sum(qc * qc, dim=-1, keepdim=True)
        bd, bi = best_d[q0:q0 + query_chunk], best_i[q0:q0 + query_chunk]
        for t0 in range(0, tp.shape[0], target_chunk):
            tc = tc_all[t0:t0 + target_chunk]
            d = qq - 2.0 * (qc @ tc.T) + tt_all[None, t0:t0 + target_chunk]
            top_d, top_a = torch.topk(d, k, dim=-1, largest=False)
            merged_d, sel = torch.topk(torch.cat([bd, top_d], dim=-1), k,
                                       dim=-1, largest=False)
            merged_i = torch.gather(torch.cat([bi, t0 + top_a], dim=-1), 1,
                                    sel)
            bd.copy_(merged_d)
            bi.copy_(merged_i)
    diff = query[:, None, :] - tp[best_i]
    sqd = torch.sum(diff * diff, dim=-1)
    sqd, order = torch.sort(sqd, dim=-1)
    return torch.gather(best_i, 1, order), sqd
