"""Scan intake and preprocessing (port of ``noetic_slam_tpu.ops.pointcloud``).

Same fixed-shape, masked design as the JAX module: every cloud is
``(N, 3) xyz`` + ``(N,) t`` + ``(N,) bool`` validity, invalid slots sit at
the far ``SENTINEL``. Two differences of idiom:

- JAX's ``.at[idx].set/add(..., mode="drop")`` silently drops
  out-of-range indices; torch raises on them. Each such scatter here
  writes into a buffer one row longer than the result, routes dropped
  entries to that extra "dump" row, and slices it off.
- Sorts are ``stable=True`` (``jnp.argsort`` is stable by default).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

Tensor = torch.Tensor

SENTINEL = 1.0e6
INT32_MAX = torch.iinfo(torch.int32).max


def take(x: Tensor, i: Tensor) -> Tensor:
    """``x[i]`` for a 0-dim index tensor, without reading the index on the
    host (indexing with a 0-dim tensor converts it to a Python int, a
    device sync on CUDA)."""
    return x.index_select(0, i.reshape(1).long())[0]


def put(x: Tensor, i: Tensor, value: Tensor) -> None:
    """``x[i] = value`` in place for a 0-dim index tensor (no host read)."""
    x.index_copy_(0, i.reshape(1).long(), value.to(x.dtype).unsqueeze(0))


@functools.lru_cache(maxsize=64)
def const(values: tuple, device: torch.device) -> Tensor:
    """A float32 constant on ``device``, copied there once per process
    (each host->device copy of a fresh tensor synchronises the stream).
    Callers must not modify it."""
    return torch.tensor(values, dtype=torch.float32, device=device)


class Scan(NamedTuple):
    xyz: Tensor    # (N, 3)
    t: Tensor      # (N,) relative seconds
    valid: Tensor  # (N,) bool
    count: Tensor  # () int32


def _part1by2(x: Tensor) -> Tensor:
    """Spread the low 10 bits of x so they occupy every 3rd bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton30(v: Tensor) -> Tensor:
    """(..., 3) int32 grid coords in [0, 1024) -> 30-bit Morton key."""
    return (_part1by2(v[..., 0]) | (_part1by2(v[..., 1]) << 1)
            | (_part1by2(v[..., 2]) << 2))


def _masked_min(xyz: Tensor, valid: Tensor) -> Tensor:
    """Per-axis minimum over valid rows (0 when there are none)."""
    pmin = torch.where(valid[:, None], xyz, torch.inf).amin(dim=0)
    return torch.where(torch.isfinite(pmin), pmin, 0.0)


def morton_sort_key(xyz: Tensor, valid: Tensor, cell: float) -> Tensor:
    """Morton key on a ``cell`` grid anchored at the cloud minimum (clamped
    to 1024^3 reach); invalid points key to INT32_MAX."""
    pmin = _masked_min(xyz, valid)
    v = torch.clamp(torch.floor((xyz - pmin) / cell).to(torch.int32), 0, 1023)
    return torch.where(valid, morton30(v), INT32_MAX)


def crop_box(scan: Scan, size: float) -> Scan:
    """Drop points inside the sensor-centred box [-size, size]^3."""
    inside = (torch.abs(scan.xyz) <= size).all(dim=-1)
    valid = scan.valid & ~inside
    xyz = torch.where(valid[:, None], scan.xyz, SENTINEL)
    return Scan(xyz, scan.t, valid, valid.sum().to(torch.int32))


class PreparedScan(NamedTuple):
    """Scan sorted by per-point time with unique-timestamp frame grouping."""
    xyz: Tensor          # (N, 3) sorted by time
    t: Tensor            # (N,)
    valid: Tensor        # (N,)
    count: Tensor        # () int32
    frame_idx: Tensor    # (N,) int64 index into unique_t per point
    unique_t: Tensor     # (F,) unique timestamps (padded with the last)
    unique_count: Tensor # () int64
    median_idx: Tensor   # () int64
    scan_stamp: Tensor   # () relative time of the median unique stamp


def _first_flags(x: Tensor) -> Tensor:
    """True where x differs from its predecessor (and at index 0)."""
    return torch.cat([torch.ones_like(x[:1], dtype=torch.bool),
                      x[1:] != x[:-1]])


def prepare_scan(scan: Scan, max_frames: int) -> PreparedScan:
    """Sort by timestamp and build the unique-timestamp frame structure
    (invalid points sort to the end)."""
    key = torch.where(scan.valid, scan.t, torch.inf)
    order = torch.sort(key, stable=True).indices
    t = scan.t[order]
    xyz = scan.xyz[order]
    valid = scan.valid[order]

    first = _first_flags(t) & valid
    frame_idx = torch.clamp(torch.cumsum(first, 0) - 1, 0, max_frames - 1)
    unique_count = torch.clamp(first.sum(), max=max_frames)

    # scatter unique times; non-first points go to the dump slot F
    uniq = torch.full((max_frames + 1,), -torch.inf, dtype=torch.float32,
                      device=t.device)
    uniq[torch.where(first, frame_idx, max_frames)] = t
    uniq = uniq[:max_frames]
    last_t = take(uniq, torch.clamp(unique_count - 1, 0, max_frames - 1))
    slot = torch.arange(max_frames, device=t.device)
    uniq = torch.where(slot < unique_count, uniq, last_t)

    median_idx = unique_count // 2
    scan_stamp = take(uniq, torch.clamp(median_idx, 0, max_frames - 1))
    return PreparedScan(xyz, t, valid, valid.sum().to(torch.int32),
                        frame_idx, uniq, unique_count, median_idx, scan_stamp)


def voxel_downsample(xyz: Tensor, valid: Tensor, res: float,
                     out_capacity: int) -> tuple[Tensor, Tensor, Tensor]:
    """Voxel-grid centroid downsampling (PCL VoxelGrid semantics): Morton
    voxel keys relative to the cloud minimum, sort, segment mean.
    Segments beyond ``out_capacity`` are dropped.

    Deterministic on the card as on the CPU: the sorted keys make each
    voxel a contiguous run, and ``segment_reduce`` sums each run in index
    order (one thread a run and coordinate on the card; the CPU adds in
    the same order, as ``index_add_`` does there). A scatter-add would sum
    in an order that changes from run to run on the card.

    Returns (xyz_ds (out_capacity, 3), valid_ds, count)."""
    pmin = _masked_min(xyz, valid)
    origin = torch.floor(pmin / res)
    v = torch.clamp((torch.floor(xyz / res) - origin).to(torch.int32),
                    0, 1023)
    key = torch.where(valid, morton30(v), INT32_MAX)

    key_s, order = torch.sort(key, stable=True)
    xyz_s = xyz[order]
    valid_s = valid[order]

    first = _first_flags(key_s) & valid_s
    seg = torch.cumsum(first, 0) - 1
    nseg = first.sum()

    # runs past the capacity and the invalid tail (sorted last) form one
    # dump run at index out_capacity
    seg_clip = torch.where(valid_s & (seg < out_capacity), seg, out_capacity)
    # (integer adds: exact in any order; bincount would read its size
    # on the host)
    lengths = torch.zeros((out_capacity + 1,), dtype=torch.int64,
                          device=xyz.device).index_add_(
        0, seg_clip, torch.ones_like(seg_clip))
    w = valid_s.to(xyz.dtype)
    sums = torch.segment_reduce(xyz_s * w[:, None], "sum", lengths=lengths,
                                unsafe=True)[:out_capacity]
    cnts = lengths[:out_capacity].to(xyz.dtype)

    n_out = torch.clamp(nseg, max=out_capacity)
    slot = torch.arange(out_capacity, device=xyz.device)
    out_valid = slot < n_out
    centroid = sums / torch.clamp(cnts, min=1.0)[:, None]
    out_xyz = torch.where(out_valid[:, None], centroid, SENTINEL)
    return out_xyz, out_valid, n_out.to(torch.int32)
