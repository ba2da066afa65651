"""Kernel B: TSDF block accumulation (``csrc/tsdf_accum.cu``) and its plain
version.

Replaces ``noetic_slam_tpu/ops/pallas/tsdf_kernel.py`` (``_accum_kernel``,
launched by ``block_accumulate``). Each candidate entry b names a payload
row ``rows[b]`` and a contiguous range ``[starts[b], starts[b] + cnts[b])``
of the block-sorted sample stream (``ivox``, ``w``, ``wd`` = w*sdf). The
range is summed into the row, then the row is clamped:
``new_w = min(W + ΣW, max_weight)`` and ``Σwd`` is scaled by
``new_w / (W + ΣW)``. At ``max_weight >= NO_CLAMP`` it is a pure sum.
Entries with ``cnts <= 0`` are skipped; rows must be unique among the
others. Untouched rows are never read or written. The payload is updated
in place.

What bounds it on the card, and what the design does about it: see the
note at the top of ``csrc/tsdf_accum.cu``. The TPU version's 8-row group
scratch and its padding-first ordering contract are not carried over.
"""

from __future__ import annotations

import torch

from noetic_slam_tpu_torch.ops.cuda import _build

Tensor = torch.Tensor

BLOCK_VOLUME = 512
NO_CLAMP = 1e30


def _check(name: str, x: Tensor, dtype, ndim: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"block_accumulate: {name} must be a CUDA tensor")
    if x.dtype != dtype or x.dim() != ndim:
        raise ValueError(f"block_accumulate: {name} must be {dtype} with "
                         f"{ndim} dims, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"block_accumulate: {name} must be contiguous")


def block_accumulate(weight: Tensor, wsum: Tensor, rows: Tensor,
                     starts: Tensor, cnts: Tensor, ivox: Tensor, w: Tensor,
                     wd: Tensor, max_weight: float) -> None:
    """Kernel B on the card; updates ``weight``/``wsum`` (C, 512) in place.

    CUDA tensors only; raises on anything else (no fallback)."""
    _check("weight", weight, torch.float32, 2)
    _check("wsum", wsum, torch.float32, 2)
    for name, x in (("rows", rows), ("starts", starts), ("cnts", cnts),
                    ("ivox", ivox)):
        _check(name, x, torch.int32, 1)
    _check("w", w, torch.float32, 1)
    _check("wd", wd, torch.float32, 1)
    C, V = weight.shape
    if V != BLOCK_VOLUME or wsum.shape != weight.shape:
        raise ValueError(f"block_accumulate: payload must be (C, "
                         f"{BLOCK_VOLUME}), got {tuple(weight.shape)} / "
                         f"{tuple(wsum.shape)}")
    A = rows.shape[0]
    S = ivox.shape[0]
    if starts.shape[0] != A or cnts.shape[0] != A:
        raise ValueError("block_accumulate: rows/starts/cnts lengths differ")
    if w.shape[0] != S or wd.shape[0] != S:
        raise ValueError("block_accumulate: ivox/w/wd lengths differ")
    no_clamp = max_weight >= NO_CLAMP
    lib = _build.load()
    with torch.cuda.device(weight.device):
        stream = torch.cuda.current_stream(weight.device).cuda_stream
        err = lib.nst_tsdf_accum_launch(
            weight.data_ptr(), wsum.data_ptr(), C, rows.data_ptr(),
            starts.data_ptr(), cnts.data_ptr(), A, ivox.data_ptr(),
            w.data_ptr(), wd.data_ptr(), S,
            float(0.0 if no_clamp else max_weight), int(no_clamp), stream)
    _build.check(err, "block_accumulate")
    block_accumulate.launches += 1


block_accumulate.launches = 0


def block_accumulate_plain(weight: Tensor, wsum: Tensor, rows: Tensor,
                           starts: Tensor, cnts: Tensor, ivox: Tensor,
                           w: Tensor, wd: Tensor, max_weight: float) -> None:
    """Plain torch version of kernel B (``index_add_`` into per-entry
    accumulators, then one update of the touched rows), same contract,
    in place. Sums each entry first and adds it to the row after, the
    kernel's association."""
    A = rows.shape[0]
    dev = weight.device
    real = cnts > 0
    cnt = torch.where(real, cnts, 0).long()
    ent = torch.repeat_interleave(torch.arange(A, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    pos = (torch.repeat_interleave(starts.long(), cnt)
           + torch.arange(ent.shape[0], device=dev)
           - torch.repeat_interleave(first, cnt))
    flat = ent * BLOCK_VOLUME + ivox[pos].long()
    acc_w = torch.zeros(A * BLOCK_VOLUME, dtype=torch.float32, device=dev)
    acc_wd = torch.zeros_like(acc_w)
    acc_w.index_add_(0, flat, w[pos])
    acc_wd.index_add_(0, flat, wd[pos])
    r = rows[real].long()
    new_w = weight[r] + acc_w.view(A, BLOCK_VOLUME)[real]
    new_wd = wsum[r] + acc_wd.view(A, BLOCK_VOLUME)[real]
    if max_weight >= NO_CLAMP:
        weight[r] = new_w
        wsum[r] = new_wd
    else:
        clamped = torch.clamp(new_w, max=max_weight)
        wsum[r] = new_wd * (clamped / torch.clamp(new_w, min=1e-12))
        weight[r] = clamped
