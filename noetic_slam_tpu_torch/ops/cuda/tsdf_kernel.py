"""Kernel B: TSDF block accumulation (``csrc/block_accum.cu``) and its plain
version.

Replaces ``noetic_slam_tpu/ops/pallas/tsdf_kernel.py`` (``_accum_kernel``,
launched by ``block_accumulate``). Each candidate entry b names a payload
row ``rows[b]`` and a contiguous range ``[starts[b], starts[b] + cnts[b])``
of the block-sorted sample stream (``ivox``, ``w``, ``wd`` = w*sdf). The
range is summed per voxel, and each voxel that some sample of the range
hits is updated: ``new_w = min(W + ΣW, max_weight)`` and ``WS + Σwd`` is
scaled by ``new_w / (W + ΣW)``. At ``max_weight >= NO_CLAMP`` it is a pure
sum. Entries with ``cnts <= 0`` are skipped; rows must be unique among the
others. The payload is updated in place.

Hit-voxel contract: only voxels that some sample of a real entry hits are
read and written. Voxels of a touched row that no sample hits keep their
value bitwise, as do untouched rows. The TPU kernel instead applies the
clamp to whole 8-row groups and relies on it being the identity where
nothing was added; on every state a map can reach (weights in
``[0, max_weight]``, ``wsum`` 0 where the weight is 0; any state at
``NO_CLAMP``) the two agree.

What bounds it on the card is latency and balance, not bytes: one scan's
4,096 entries hold ~30 samples on average and the few blocks around the
sensor ~4,000, and merging one 32-sample tile in a warp is a chain of
shuffle and shared-memory round trips. The kernel gives an entry of at
most 384 samples to one warp and cuts a longer one into equal parts that
up to 16 warps of one CTA walk side by side; it merges same-voxel samples
inside each tile (``__match_any_sync``), keeps per-warp partials and hit
masks in shared memory, merges the parts of a long entry in part order,
and touches only the hit voxels of the payload. The note at the top of ``csrc/block_accum.cu`` (whose
template B shares with kernel C, ``ops/cuda/logodds_kernel.py``) has the
details. The sums are deterministic and negation-symmetric: a stream fused
with sign +1 and then -1 from a zero payload returns exactly 0.
"""

from __future__ import annotations

import torch

from noetic_slam_tpu_torch.ops.cuda import _build

Tensor = torch.Tensor

BLOCK_VOLUME = 512
NO_CLAMP = 1e30


def check_operand(fn: str, name: str, x: Tensor, dtype, ndim: int) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``dtype``/``ndim``."""
    if not x.is_cuda:
        raise ValueError(f"{fn}: {name} must be a CUDA tensor")
    if x.dtype != dtype or x.dim() != ndim:
        raise ValueError(f"{fn}: {name} must be {dtype} with {ndim} dims, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def check_entries(fn: str, payload: Tensor, rows: Tensor, starts: Tensor,
                  cnts: Tensor, ivox: Tensor, channels: dict) -> None:
    """The checks kernels B and C share: a (C, 512) f32 payload, int32
    entry arrays of one length, an int32 ``ivox`` and f32 channels of the
    stream's length."""
    check_operand(fn, "payload", payload, torch.float32, 2)
    for name, x in (("rows", rows), ("starts", starts), ("cnts", cnts),
                    ("ivox", ivox)):
        check_operand(fn, name, x, torch.int32, 1)
    for name, x in channels.items():
        check_operand(fn, name, x, torch.float32, 1)
        if x.shape[0] != ivox.shape[0]:
            raise ValueError(f"{fn}: ivox/{name} lengths differ")
    if payload.shape[1] != BLOCK_VOLUME:
        raise ValueError(f"{fn}: payload must be (C, {BLOCK_VOLUME}), got "
                         f"{tuple(payload.shape)}")
    if starts.shape[0] != rows.shape[0] or cnts.shape[0] != rows.shape[0]:
        raise ValueError(f"{fn}: rows/starts/cnts lengths differ")


def entry_addresses(starts: Tensor, cnts: Tensor) -> tuple[Tensor, Tensor]:
    """(entry index, stream position) of every sample of an entry with
    ``cnts > 0``, entry by entry: int64 arrays of length ``Σ max(cnts, 0)``."""
    dev = starts.device
    cnt = torch.clamp(cnts, min=0).long()
    ent = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    pos = (starts.long()[ent] + torch.arange(ent.shape[0], device=dev)
           - first[ent])
    return ent, pos


def entry_sums(rows: Tensor, starts: Tensor, cnts: Tensor, ivox: Tensor,
               channels: tuple) -> tuple[Tensor, tuple]:
    """The plain versions' sums: ``(idx, sums)``, where ``idx`` holds the
    flat payload index (``row * 512 + voxel``) of every voxel that some
    sample of an entry with ``cnts > 0`` hits, and ``sums`` each channel's
    per-entry sum there. Each entry's samples are added with ``index_add_``
    into its own zeroed row first (the kernel's association: an entry is
    summed before it meets the payload)."""
    A = starts.shape[0]
    ent, pos = entry_addresses(starts, cnts)
    flat = ent * BLOCK_VOLUME + ivox[pos].long()
    hit = torch.unique(flat)
    sums = []
    for x in channels:
        acc = torch.zeros(A * BLOCK_VOLUME, dtype=torch.float32,
                          device=ivox.device)
        acc.index_add_(0, flat, x[pos])
        sums.append(acc[hit])
    idx = rows.long()[hit // BLOCK_VOLUME] * BLOCK_VOLUME + hit % BLOCK_VOLUME
    return idx, tuple(sums)


def block_accumulate(weight: Tensor, wsum: Tensor, rows: Tensor,
                     starts: Tensor, cnts: Tensor, ivox: Tensor, w: Tensor,
                     wd: Tensor, max_weight: float) -> None:
    """Kernel B on the card; updates the hit voxels of ``weight``/``wsum``
    (C, 512) in place (hit-voxel contract: module docstring). One launch
    per call, of one CTA per ``entry_cut()[0]`` entries, sized from the
    entry count alone; nothing is read back to the host.

    CUDA tensors only; raises on anything else (no fallback)."""
    check_entries("block_accumulate", weight, rows, starts, cnts, ivox,
                  {"w": w, "wd": wd})
    check_operand("block_accumulate", "wsum", wsum, torch.float32, 2)
    if wsum.shape != weight.shape:
        raise ValueError(f"block_accumulate: weight/wsum shapes differ: "
                         f"{tuple(weight.shape)} / {tuple(wsum.shape)}")
    C = weight.shape[0]
    A = rows.shape[0]
    S = ivox.shape[0]
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


def entry_cut() -> tuple[int, int, int]:
    """The cut of an entry in the built kernels B and C: (the most warps
    one entry gets, the samples one warp takes alone, the samples of a
    part). An entry of ``cnt <= short`` samples is one warp's
    ``ceil(cnt / 32)`` serial 32-sample tiles; a longer one is cut into
    ``min(warps, ceil(cnt / part))`` equal parts, rounded up to whole
    tiles, walked side by side."""
    lib = _build.load()
    return (lib.nst_block_accum_warps(), lib.nst_block_accum_short(),
            lib.nst_block_accum_part())


def block_accumulate_plain(weight: Tensor, wsum: Tensor, rows: Tensor,
                           starts: Tensor, cnts: Tensor, ivox: Tensor,
                           w: Tensor, wd: Tensor, max_weight: float) -> None:
    """Plain torch version of kernel B (``index_add_`` into per-entry
    sums, then one update of the hit voxels), same contract, in place."""
    idx, (sw, swd) = entry_sums(rows, starts, cnts, ivox, (w, wd))
    W, WS = weight.view(-1), wsum.view(-1)
    new_w = W[idx] + sw
    new_wd = WS[idx] + swd
    if max_weight >= NO_CLAMP:
        W[idx] = new_w
        WS[idx] = new_wd
    else:
        clamped = torch.clamp(new_w, max=max_weight)
        WS[idx] = new_wd * (clamped / torch.clamp(new_w, min=1e-12))
        W[idx] = clamped
