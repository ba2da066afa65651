"""Kernel C: occupancy log-odds block accumulation (``csrc/block_accum.cu``)
and its plain version.

Replaces ``noetic_slam_tpu/ops/pallas/tsdf_kernel.py`` (``_logodds_kernel``,
launched by ``logodds_accumulate``). Each candidate entry b names a payload
row ``rows[b]`` and a contiguous range ``[starts[b], starts[b] + cnts[b])``
of the block-sorted sample stream (``ivox``, ``delta``). The range is
summed into the row, once, and the row is clipped:
``L = clip(L + Σdelta, l_min, l_max)``: the occupancy map's clamp at scan
granularity, never per sample. With ``l_min``/``l_max`` at -/+1e30 the clip
is the identity in f32, a pure sum (signed de-fusion). Entries with
``cnts <= 0`` are skipped; rows must be unique among the others. Untouched
rows are never read or written. The payload is updated in place.

The kernel is kernel B's template (``csrc/block_accum.cu``) with one
channel and the clip as its epilogue; what bounds it on the card and what
the design does about it are in the note at the top of that file. The TPU
version's 8-row group scratch and its padding-first ordering contract,
with the caller's reorder for it, are not carried over.
"""

from __future__ import annotations

import torch

from noetic_slam_tpu_torch.ops.cuda import _build
from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import (
    check_entries,
    entry_sums,
)

Tensor = torch.Tensor

UNCLAMPED = 1e30     # |l_min|, |l_max| of the signed (archive) mode


def logodds_accumulate(logodds: Tensor, rows: Tensor, starts: Tensor,
                       cnts: Tensor, ivox: Tensor, delta: Tensor,
                       l_min: float, l_max: float) -> None:
    """Kernel C on the card; updates ``logodds`` (C, 512) in place.

    CUDA tensors only; raises on anything else (no fallback)."""
    check_entries("logodds_accumulate", logodds, rows, starts, cnts, ivox,
                  {"delta": delta})
    lib = _build.load()
    with torch.cuda.device(logodds.device):
        stream = torch.cuda.current_stream(logodds.device).cuda_stream
        err = lib.nst_logodds_accum_launch(
            logodds.data_ptr(), logodds.shape[0], rows.data_ptr(),
            starts.data_ptr(), cnts.data_ptr(), rows.shape[0],
            ivox.data_ptr(), delta.data_ptr(), ivox.shape[0], float(l_min),
            float(l_max), stream)
    _build.check(err, "logodds_accumulate")
    logodds_accumulate.launches += 1


logodds_accumulate.launches = 0


def logodds_accumulate_plain(logodds: Tensor, rows: Tensor, starts: Tensor,
                             cnts: Tensor, ivox: Tensor, delta: Tensor,
                             l_min: float, l_max: float) -> None:
    """Plain torch version of kernel C (``index_add_`` into per-entry
    accumulators, then one clipped update of the touched rows), same
    contract, in place; the kernel's association (each entry summed first,
    added to its row after)."""
    real = cnts > 0
    (acc,) = entry_sums(starts, cnts, ivox, (delta,))
    r = rows[real].long()
    logodds[r] = torch.clamp(logodds[r] + acc[real], l_min, l_max)
