"""Kernel C: occupancy log-odds block accumulation (``csrc/block_accum.cu``)
and its plain version.

Replaces ``noetic_slam_tpu/ops/pallas/tsdf_kernel.py`` (``_logodds_kernel``,
launched by ``logodds_accumulate``). Each candidate entry b names a payload
row ``rows[b]`` and a contiguous range ``[starts[b], starts[b] + cnts[b])``
of the block-sorted sample stream (``ivox``, ``delta``). The range is
summed per voxel, once, and each voxel that some sample of the range hits
is clipped: ``L = clip(L + Σdelta, l_min, l_max)``: the occupancy map's
clamp at scan granularity, never per sample. With ``l_min``/``l_max`` at
-/+1e30 the clip is the identity in f32, a pure sum (signed de-fusion).
Entries with ``cnts <= 0`` are skipped; rows must be unique among the
others. The payload is updated in place.

Hit-voxel contract: only voxels that some sample of a real entry hits are
read and written. Voxels of a touched row that no sample hits keep their
value bitwise, as do untouched rows. The TPU kernel clips whole 8-row
groups and relies on the clip being the identity where nothing was added;
on every state a map can reach (log-odds in ``[l_min, l_max]``, or the
unclamped ±1e30 mode) the two agree.

The kernel is kernel B's template (``csrc/block_accum.cu``) with one
channel and the clip as its epilogue: what bounds it on the card (latency
and the balance of the work, not bytes) and what the design does about it
(short entries one warp each, long ones cut into parts across the warps
of a CTA, same-voxel samples merged in the warp, only the hit voxels
touched) are in the note at the top of that file and in
``ops/cuda/tsdf_kernel.py``. The sums are deterministic and
negation-symmetric: deltas fused with sign +1 and then -1 from a zero
payload return exactly 0, which the archive's de-fusion relies on.
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
    """Kernel C on the card; updates the hit voxels of ``logodds`` (C, 512)
    in place (hit-voxel contract: module docstring). One launch per call,
    sized from the entry count alone (as kernel B's); nothing is read back
    to the host.

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
    sums, then one clipped update of the hit voxels), same contract, in
    place."""
    idx, (acc,) = entry_sums(rows, starts, cnts, ivox, (delta,))
    L = logodds.view(-1)
    L[idx] = torch.clamp(L[idx] + acc, l_min, l_max)
