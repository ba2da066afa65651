"""Kernel B: TSDF block accumulation (``csrc/block_accum.cu``) and its plain
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
note at the top of ``csrc/block_accum.cu``, whose kernel template B shares
with kernel C (``ops/cuda/logodds_kernel.py``). The TPU version's 8-row group
scratch and its padding-first ordering contract are not carried over.
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


def entry_sums(starts: Tensor, cnts: Tensor, ivox: Tensor,
               channels: tuple) -> tuple:
    """The plain versions' per-entry sums: ``(A, 512)`` per channel, each
    entry's samples added into its own zeroed row with ``index_add_``
    (entries with ``cnts <= 0`` stay zero)."""
    A = starts.shape[0]
    dev = ivox.device
    ent, pos = entry_addresses(starts, cnts)
    flat = ent * BLOCK_VOLUME + ivox[pos].long()
    out = []
    for x in channels:
        acc = torch.zeros(A * BLOCK_VOLUME, dtype=torch.float32, device=dev)
        acc.index_add_(0, flat, x[pos])
        out.append(acc.view(A, BLOCK_VOLUME))
    return tuple(out)


def block_accumulate(weight: Tensor, wsum: Tensor, rows: Tensor,
                     starts: Tensor, cnts: Tensor, ivox: Tensor, w: Tensor,
                     wd: Tensor, max_weight: float) -> None:
    """Kernel B on the card; updates ``weight``/``wsum`` (C, 512) in place.

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


def block_accumulate_plain(weight: Tensor, wsum: Tensor, rows: Tensor,
                           starts: Tensor, cnts: Tensor, ivox: Tensor,
                           w: Tensor, wd: Tensor, max_weight: float) -> None:
    """Plain torch version of kernel B (``index_add_`` into per-entry
    accumulators, then one update of the touched rows), same contract,
    in place. Sums each entry first and adds it to the row after, the
    kernel's association."""
    real = cnts > 0
    acc_w, acc_wd = entry_sums(starts, cnts, ivox, (w, wd))
    r = rows[real].long()
    new_w = weight[r] + acc_w[real]
    new_wd = wsum[r] + acc_wd[real]
    if max_weight >= NO_CLAMP:
        weight[r] = new_w
        wsum[r] = new_wd
    else:
        clamped = torch.clamp(new_w, max=max_weight)
        wsum[r] = new_wd * (clamped / torch.clamp(new_w, min=1e-12))
        weight[r] = clamped
