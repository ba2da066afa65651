"""Nearest-neighbour search (port of ``noetic_slam_tpu.ops.neighbors``).

``nn1`` finds GICP's correspondences in every outer LM iteration. A CUDA
tensor goes to kernel A (``ops.cuda.nn_kernel.nn1_fused``); a CPU tensor
goes to its plain version (``nn1_plain``). The JAX module's TPU shape gate
is gone: the CUDA kernel masks ragged edges itself. ``knn`` (used only by
the non-default ``cov_engine="knn"``) is not ported yet.
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
