"""Block-hashed TSDF fusion (port of ``noetic_slam_tpu.models.tsdf``).

Same design as the JAX module: a sorted block directory (keys, payload
slots) beside a fixed-slot sum-form payload (Σw·d, Σw) of 512 voxels per
block, and one block-major sort of each scan's ray samples, after which
every touched block owns one contiguous range of the stream. The payload
update is kernel B on the card (``ops.cuda.tsdf_kernel.block_accumulate``)
and its plain version on the CPU; both update the payload in place, where
JAX donated the state.

Porting notes:
- ``_block_key`` shifts ``(bz + 512) << 22``, which wraps negative in int32
  for every block with z >= 0 in JAX. The port computes the key in int64
  and wraps it to the same int32 bits, so the directory order matches.
- ``associative_scan(jnp.maximum)`` is ``torch.cummax``.
- The TPU-only reorder for the Pallas kernel (padding entries first, row
  groups) is not ported: kernel B takes the entries in rank order and
  skips those with no samples.
- The directory and run part of a scan's fusion (``block_runs``) is shared
  with the occupancy backend (``models/occupancy.py``), which gathers its
  own channel and calls kernel C.
- ``voxel_centers`` writes only the rows of allocated slots (JAX scatters
  every padding key to slot C-1, a duplicate-index scatter that torch
  does not order); the other rows are zero.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from noetic_slam_tpu_torch import resolve_device
from noetic_slam_tpu_torch.config import TsdfConfig
from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import (  # noqa: F401
    NO_CLAMP,
    block_accumulate,
    block_accumulate_plain,
)
from noetic_slam_tpu_torch.ops.pointcloud import const

Tensor = torch.Tensor

BLOCK = 8
BLOCK_VOLUME = BLOCK ** 3
KEY_PAD = torch.iinfo(torch.int32).max


class TsdfState(NamedTuple):
    dir_keys: Tensor    # (C,) int32 sorted block keys (pad = INT32_MAX)
    dir_slots: Tensor   # (C,) int32 payload slot per key
    num_blocks: Tensor  # () int32
    wsum: Tensor        # (C, 512) f32 Σ w·d
    weight: Tensor      # (C, 512) f32 Σ w, clamped at cfg.max_weight
    dropped: Tensor     # () int32 samples/blocks dropped for capacity


def init_tsdf(cfg: TsdfConfig, device=None) -> TsdfState:
    """An empty TSDF on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    C = cfg.max_blocks
    i32 = dict(dtype=torch.int32, device=device)
    return TsdfState(
        dir_keys=torch.full((C,), KEY_PAD, **i32),
        dir_slots=torch.zeros((C,), **i32),
        num_blocks=torch.zeros((), **i32),
        wsum=torch.zeros((C, BLOCK_VOLUME), dtype=torch.float32,
                         device=device),
        weight=torch.zeros((C, BLOCK_VOLUME), dtype=torch.float32,
                           device=device),
        dropped=torch.zeros((), **i32),
    )


def tsdf_distance(cfg: TsdfConfig, state: TsdfState) -> Tensor:
    """Per-voxel signed distance (C, 512): Σwd/Σw; unobserved -> +trunc."""
    return torch.where(state.weight > 0.0,
                       state.wsum / torch.clamp(state.weight, min=1e-12),
                       cfg.truncation)


def _block_key(b: Tensor) -> Tensor:
    """(..., 3) int block coords -> packed int32 key (invalid -> KEY_PAD),
    bit-identical to the JAX module's int32 arithmetic (which wraps)."""
    b = b.long()
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    ok = ((bx >= -1024) & (bx < 1024) & (by >= -1024) & (by < 1024)
          & (bz >= -512) & (bz < 512))
    key = ((bz + 512) << 22) | ((by + 1024) << 11) | (bx + 1024)
    key = torch.where(key >= 2 ** 31, key - 2 ** 32, key)   # int32 wrap
    return torch.where(ok, key, KEY_PAD).to(torch.int32)


def _lookup_join(ref_keys: Tensor, ref_vals: Tensor, q_keys: Tensor
                 ) -> Tensor:
    """Batch key lookup by sorted merge: stable argsort of the
    concatenation (ref rows first), forward-propagate the last ref row
    with a cummax, read back through the inverse permutation. Returns the
    slot per query key, or -1."""
    C = ref_keys.shape[0]
    Q = q_keys.shape[0]
    keys_all = torch.cat([ref_keys, q_keys])
    k_s, order = torch.sort(keys_all, stable=True)
    is_ref = order < C
    idx = torch.arange(C + Q, device=keys_all.device)
    last_ref_pos = torch.cummax(torch.where(is_ref, idx, -1), dim=0).values
    lrp = torch.clamp(last_ref_pos, 0, C + Q - 1)
    hit = (last_ref_pos >= 0) & (k_s[lrp] == k_s) & (k_s != KEY_PAD)
    val_sorted = torch.where(hit, ref_vals[torch.clamp(order[lrp], 0, C - 1)],
                             -1)
    out = torch.empty_like(val_sorted)
    out[order] = val_sorted                      # inverse permutation
    return out[C:]


def _lookup(state, keys: Tensor) -> Tensor:
    """Sorted-directory lookup: key -> payload slot (or -1), by the
    sort-merge join at every batch size."""
    return _lookup_join(state.dir_keys, state.dir_slots, keys)


def allocate_blocks(state: TsdfState, want_keys: Tensor) -> TsdfState:
    """Insert any unseen keys into the directory (sorted merge).

    ``want_keys`` (A,) may hold duplicates and ``KEY_PAD``. New blocks take
    payload slots from the running counter; beyond capacity they are
    dropped and counted in ``dropped``."""
    C = state.dir_keys.shape[0]
    dev = want_keys.device
    wk = torch.sort(want_keys.to(torch.int32)).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       wk[1:] != wk[:-1]])
    wk = torch.where(first, wk, KEY_PAD)
    wk = torch.where(_lookup(state, wk) >= 0, KEY_PAD, wk)
    wk = torch.sort(wk).values
    live = wk != KEY_PAD
    n_new = live.sum()
    slot = state.num_blocks + torch.cumsum(live, 0) - 1
    ok = live & (slot < C)
    wk = torch.where(ok, wk, KEY_PAD)
    slot = torch.where(ok, slot, 0).to(torch.int32)
    keys, order = torch.sort(torch.cat([state.dir_keys, wk]), stable=True)
    slots = torch.cat([state.dir_slots, slot])[order]
    num = torch.clamp(state.num_blocks + n_new, max=C)
    return state._replace(
        dir_keys=keys[:C].contiguous(), dir_slots=slots[:C].contiguous(),
        num_blocks=num.to(torch.int32),
        dropped=(state.dropped + n_new - (num - state.num_blocks)
                 ).to(torch.int32))


def _ray_samples(cfg: TsdfConfig, points: Tensor, valid: Tensor,
                 origin: Tensor):
    """Sample positions, SDF values and weights along each ray: a surface
    band at voxel spacing within [-trunc, +trunc] around the hit (linear
    taper behind the surface), plus optional free-space carving samples.
    Returns (pos (N*S, 3), sdf (N*S,), w (N*S,))."""
    dev = points.device
    d = points - origin
    r = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    ok = valid & (r[:, 0] > 0.3) & (r[:, 0] < cfg.max_range)
    u = d / torch.clamp(r, min=1e-6)

    n_band = max(int(round(2.0 * cfg.truncation / cfg.voxel_size)) + 1, 3)
    offs = const(tuple(np.linspace(-cfg.truncation, cfg.truncation, n_band)),
                 dev)
    band_pos = points[:, None, :] + u[:, None, :] * offs[None, :, None]
    band_sdf = (-offs)[None, :].expand(points.shape[0], n_band)
    band_w = torch.where(band_sdf < 0.0, 1.0 + band_sdf / cfg.truncation, 1.0)
    band_w = torch.clamp(band_w, min=0.05) * ok[:, None]

    pos, sdf, w = band_pos, band_sdf, band_w
    if cfg.space_carving and cfg.carving_samples > 0:
        S = cfg.carving_samples
        frac = (torch.arange(S, device=dev, dtype=torch.float32) + 0.5) / S
        carve_r = frac[None, :] * torch.clamp(r - cfg.truncation, min=0.0)
        carve_pos = origin + u[:, None, :] * carve_r[:, :, None]
        carve_sdf = torch.full((points.shape[0], S), cfg.truncation,
                               device=dev)
        carve_w = torch.full((points.shape[0], S), 0.1,
                             device=dev) * ok[:, None]
        pos = torch.cat([pos, carve_pos], dim=1)
        sdf = torch.cat([sdf, carve_sdf], dim=1)
        w = torch.cat([w, carve_w], dim=1)
    return pos.reshape(-1, 3), sdf.reshape(-1), w.reshape(-1)


class BlockRuns(NamedTuple):
    """The shared block-stream skeleton's result for one batch of samples:
    per candidate entry the payload row, stream offset and count (count 0 =
    skip), and the block-major sort order of the samples."""
    rows: Tensor      # (A,) int32
    starts: Tensor    # (A,) int32
    cnts: Tensor      # (A,) int32
    order: Tensor     # (S,) int64 sample index per sorted position


def sample_keys(pos: Tensor, voxel_size: float, live: Tensor
                ) -> tuple[Tensor, Tensor]:
    """(block key (S,) int32, intra-block voxel (S,) int32) of each sample
    position; samples without ``live`` get ``KEY_PAD``."""
    vx = torch.floor(pos / voxel_size).to(torch.int32)
    b = vx >> 3
    intra = vx - (b << 3)
    gk = torch.where(live, _block_key(b), KEY_PAD)
    ivox = intra[:, 0] + (intra[:, 1] << 3) + (intra[:, 2] << 6)
    return gk, ivox


def block_runs(state, gk: Tensor, cap: int):
    """The block-stream skeleton shared by the TSDF and occupancy backends:
    the block-major sort of the samples' keys, the run boundaries, up to
    ``cap`` candidate blocks with their sample ranges, the directory probe
    and the merge of new blocks (beyond capacity: dropped and counted).

    ``state`` is any map state with ``dir_keys``, ``dir_slots``,
    ``num_blocks`` and ``dropped``. Returns it with the new directory
    (payload untouched) and the ``BlockRuns``; each backend gathers its own
    channels through ``order``."""
    C = state.dir_keys.shape[0]
    S = gk.shape[0]
    dev = gk.device

    # 1. block-major sort
    gk_s, order = torch.sort(gk, stable=True)

    # 2a. run boundaries; run starts compacted by a (stable) position sort
    first_blk = (torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            gk_s[1:] != gk_s[:-1]]) & (gk_s != KEY_PAD))
    blk_rank = torch.cumsum(first_blk, 0) - 1
    n_runs = blk_rank[-1] + 1
    pos_key = torch.where(first_blk, blk_rank, S)
    pos_sorted = torch.sort(pos_key, stable=True).indices
    k_take = min(cap + 1, S)
    pos_arr = torch.full((cap + 1,), S, dtype=torch.int64, device=dev)
    pos_arr[:k_take] = pos_sorted[:k_take]
    pos_arr = torch.where(torch.arange(cap + 1, device=dev) < n_runs,
                          pos_arr, S)
    rank_overflow = torch.clamp(n_runs - cap, min=0)

    # 2b. candidate keys + sample ranges
    cand_pos = pos_arr[:cap]
    cand = torch.where(cand_pos < S, gk_s[torch.clamp(cand_pos, 0, S - 1)],
                       KEY_PAD)
    pad_start = (gk_s != KEY_PAD).sum()
    start = torch.minimum(cand_pos, pad_start)
    cnt = torch.clamp(torch.minimum(pos_arr[1:], pad_start) - start, 0, S)

    # 2c. directory probe + merge of new rows
    slot_probe = _lookup(state, cand)
    hit = slot_probe >= 0
    is_new = (~hit) & (cand != KEY_PAD)
    n_new = is_new.sum()
    new_rank = torch.cumsum(is_new, 0) - 1
    slot_new = state.num_blocks + new_rank
    ok_new = is_new & (slot_new < C)
    add_keys = torch.where(ok_new, cand, KEY_PAD)
    add_slots = torch.where(ok_new, slot_new, 0).to(torch.int32)
    keys2, o2 = torch.sort(torch.cat([state.dir_keys, add_keys]),
                           stable=True)
    slots2 = torch.cat([state.dir_slots, add_slots])[o2]
    keys2, slots2 = keys2[:C].contiguous(), slots2[:C].contiguous()
    num2 = torch.clamp(state.num_blocks + n_new, max=C).to(torch.int32)
    dropped2 = (state.dropped + rank_overflow
                + (n_new - (num2 - state.num_blocks))).to(torch.int32)
    slot_cand = torch.where(hit, slot_probe.long(),
                            torch.where(ok_new, slot_new, -1))

    real = (slot_cand >= 0) & (cnt > 0)
    runs = BlockRuns(
        rows=torch.where(real, slot_cand, 0).to(torch.int32),
        starts=torch.where(real, start, 0).to(torch.int32),
        cnts=torch.where(real, cnt, 0).to(torch.int32),
        order=order)
    return state._replace(dir_keys=keys2, dir_slots=slots2, num_blocks=num2,
                          dropped=dropped2), runs


def block_stream(cfg: TsdfConfig, state: TsdfState, pos: Tensor,
                 sdf: Tensor, w: Tensor):
    """Steps 1-2 of ``_integrate_samples``: ``block_runs`` on the samples
    with a weight (``!= 0``: signed de-integration carries negative ones),
    then the gather of the TSDF's channels into block order. Returns the
    state with its new directory (payload untouched), the ``BlockRuns``
    and the sorted stream ``(ivox, w, w·clip(sdf))``: kernel B's
    operands."""
    gk, ivox = sample_keys(pos, cfg.voxel_size, w != 0.0)
    state, r = block_runs(state, gk, cfg.scan_block_cap)
    wd = w * torch.clamp(sdf, -cfg.truncation, cfg.truncation)
    return state, r, tuple(x[r.order].contiguous() for x in (ivox, w, wd))


def _integrate_samples(cfg: TsdfConfig, state: TsdfState, pos: Tensor,
                       sdf: Tensor, w: Tensor) -> TsdfState:
    """Fuse one batch of ray samples (the JAX module's structure):

    1. one block-major sort carrying (ivox, w, w·d);
    2. run boundaries -> up to ``scan_block_cap`` candidate blocks with
       their sample ranges; a sort-merge probe of the directory and a
       merge of the new blocks (beyond capacity: dropped and counted);
    3. the payload update of the candidate rows: kernel B on the card, its
       plain version on the CPU, in place.
    """
    state, r, stream = block_stream(cfg, state, pos, sdf, w)
    accumulate = (block_accumulate if state.weight.is_cuda
                  else block_accumulate_plain)
    accumulate(state.weight, state.wsum, r.rows, r.starts, r.cnts, *stream,
               cfg.max_weight)
    return state


def integrate(cfg: TsdfConfig, state: TsdfState, points: Tensor,
              valid: Tensor, origin: Tensor) -> TsdfState:
    """Fuse one world-frame cloud into the TSDF (payload in place)."""
    pos, sdf, w = _ray_samples(cfg, points, valid, origin)
    return _integrate_samples(cfg, state, pos, sdf, w)


def integrate_signed(cfg: TsdfConfig, state: TsdfState, points: Tensor,
                     valid: Tensor, origin: Tensor, sign) -> TsdfState:
    """Fuse (sign = +1) or de-fuse (sign = -1) one cloud: the keyframe
    archive's volume primitive. With ``cfg.max_weight >= NO_CLAMP`` the
    payload is a pure sum, and the same cloud at the same origin subtracts
    what it added (kernel B sums in a fixed order, so the cancellation
    is exact to the rounding of the sums)."""
    pos, sdf, w = _ray_samples(cfg, points, valid, origin)
    return _integrate_samples(cfg, state, pos, sdf, w * sign)


def rebuild_from_keyframes(cfg: TsdfConfig, kf_xyz: Tensor, kf_valid: Tensor,
                           kf_pos: Tensor, kf_count: Tensor) -> TsdfState:
    """Re-fuse the whole TSDF from the (deformed) keyframe clouds, each at
    its keyframe position as the carving origin: the loop-closure
    consistency path. One fusion per keyframe slot, on ``kf_xyz``'s
    device; slots at or beyond ``kf_count`` are gated by zero sample
    weights, as in JAX (no host read of the count)."""
    state = init_tsdf(cfg, kf_xyz.device)
    for k in range(kf_xyz.shape[0]):
        pos, sdf, w = _ray_samples(cfg, kf_xyz[k], kf_valid[k], kf_pos[k])
        w = w * (kf_count > k).to(w.dtype)
        state = _integrate_samples(cfg, state, pos, sdf, w)
    return state


def slot_used(state) -> Tensor:
    """(C,) bool: payload slots that hold an allocated block."""
    C = state.dir_keys.shape[0]
    used = torch.zeros(C + 1, dtype=torch.bool, device=state.dir_keys.device)
    used.index_fill_(0, torch.where(state.dir_keys != KEY_PAD,
                                    state.dir_slots.long(), C), True)
    return used[:C]


def voxel_centers(cfg, state) -> Tensor:
    """World-space centres of every voxel in slot order: (C, 512, 3), so
    that ``centers[slot]`` matches the payload's ``[slot]``. Rows of
    unallocated slots are zero. ``cfg`` is any map config with a
    ``voxel_size``; one (C, 512, 3) array is made and scaled in place."""
    keys = state.dir_keys
    C = keys.shape[0]
    dev = keys.device
    b = torch.stack([(keys & 0x7FF) - 1024, ((keys >> 11) & 0x7FF) - 1024,
                     ((keys >> 22) & 0x3FF) - 512], dim=-1)       # (C, 3)
    used = keys != KEY_PAD
    # block corner per slot (a dump row takes the padding keys)
    corner = torch.zeros((C + 1, 3), dtype=torch.float32, device=dev)
    corner.index_copy_(0, torch.where(used, state.dir_slots.long(), C),
                       (b * BLOCK).to(torch.float32))
    iv = torch.arange(BLOCK_VOLUME, device=dev)
    intra = torch.stack([iv & 7, (iv >> 3) & 7, (iv >> 6) & 7], dim=-1)
    # (corner + intra + 0.5) is exact in f32, so this equals JAX's
    # (vox + 0.5) * v bit for bit
    centers = corner[:C, None, :] + (intra.to(torch.float32) + 0.5)[None]
    centers.mul_(cfg.voxel_size)
    centers.mul_(slot_used(state)[:, None, None])
    return centers


def extract_surface(cfg: TsdfConfig, state: TsdfState,
                    iso_band: float = 0.5, min_weight: float = 1.0):
    """Surface points: centres of voxels near the zero crossing. Returns
    (points (C*512, 3), tsdf values (C*512,), mask (C*512,)); the host
    compacts."""
    centers = voxel_centers(cfg, state).reshape(-1, 3)
    d = tsdf_distance(cfg, state).reshape(-1)
    w = state.weight.reshape(-1)
    mask = ((w >= min_weight) & (torch.abs(d) < iso_band * cfg.voxel_size
                                 * 2.0)
            & slot_used(state).repeat_interleave(BLOCK_VOLUME))
    return centers, d, mask
