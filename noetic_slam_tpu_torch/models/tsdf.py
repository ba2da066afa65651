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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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


def init_tsdf(cfg: TsdfConfig, device) -> TsdfState:
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


class BlockStream(NamedTuple):
    """Kernel B's operands for one batch of samples: per candidate entry
    the payload row, stream offset and count (count 0 = skip), and the
    block-sorted sample stream."""
    rows: Tensor      # (A,) int32
    starts: Tensor    # (A,) int32
    cnts: Tensor      # (A,) int32
    ivox: Tensor      # (S,) int32
    w: Tensor         # (S,) f32
    wd: Tensor        # (S,) f32 w * clipped sdf


def block_stream(cfg: TsdfConfig, state: TsdfState, pos: Tensor,
                 sdf: Tensor, w: Tensor) -> tuple[TsdfState, BlockStream]:
    """Steps 1-2 of ``_integrate_samples``: the block-major sort of the
    samples, the candidate blocks and their sample ranges, the directory
    probe and the merge of new blocks. Returns the state with its new
    directory (payload untouched) and kernel B's operands."""
    C = state.weight.shape[0]
    S = pos.shape[0]
    dev = pos.device
    vx = torch.floor(pos / cfg.voxel_size).to(torch.int32)
    b = vx >> 3
    intra = vx - (b << 3)
    gk = _block_key(b)
    # != 0: signed (de-)integration carries negative weights
    gk = torch.where(w != 0.0, gk, KEY_PAD)
    ivox = intra[:, 0] + (intra[:, 1] << 3) + (intra[:, 2] << 6)
    sdf_c = torch.clamp(sdf, -cfg.truncation, cfg.truncation)

    # 1. block-major sort carrying the accumulands
    gk_s, order = torch.sort(gk, stable=True)
    iv_s = ivox[order].contiguous()
    w_s = w[order].contiguous()
    ws_s = (w * sdf_c)[order].contiguous()

    # 2a. run boundaries; run starts compacted by a (stable) position sort
    A = cfg.scan_block_cap
    first_blk = (torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            gk_s[1:] != gk_s[:-1]]) & (gk_s != KEY_PAD))
    blk_rank = torch.cumsum(first_blk, 0) - 1
    n_runs = blk_rank[-1] + 1
    pos_key = torch.where(first_blk, blk_rank, S)
    pos_sorted = torch.sort(pos_key, stable=True).indices
    k_take = min(A + 1, S)
    pos_arr = torch.full((A + 1,), S, dtype=torch.int64, device=dev)
    pos_arr[:k_take] = pos_sorted[:k_take]
    pos_arr = torch.where(torch.arange(A + 1, device=dev) < n_runs,
                          pos_arr, S)
    rank_overflow = torch.clamp(n_runs - A, min=0)

    # 2b. candidate keys + sample ranges
    cand_pos = pos_arr[:A]
    cand = torch.where(cand_pos < S, gk_s[torch.clamp(cand_pos, 0, S - 1)],
                       KEY_PAD)
    pad_start = (gk_s != KEY_PAD).sum()
    start = torch.minimum(cand_pos, pad_start)
    cnt = torch.clamp(torch.minimum(pos_arr[1:], pad_start) - start, 0, S)

    # 2c. directory probe + merge of new rows
    slot_probe = _lookup_join(state.dir_keys, state.dir_slots, cand)
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
    stream = BlockStream(
        rows=torch.where(real, slot_cand, 0).to(torch.int32),
        starts=torch.where(real, start, 0).to(torch.int32),
        cnts=torch.where(real, cnt, 0).to(torch.int32),
        ivox=iv_s, w=w_s, wd=ws_s)
    return state._replace(dir_keys=keys2, dir_slots=slots2, num_blocks=num2,
                          dropped=dropped2), stream


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
    state, s = block_stream(cfg, state, pos, sdf, w)
    accumulate = (block_accumulate if state.weight.is_cuda
                  else block_accumulate_plain)
    accumulate(state.weight, state.wsum, s.rows, s.starts, s.cnts, s.ivox,
               s.w, s.wd, cfg.max_weight)
    return state


def integrate(cfg: TsdfConfig, state: TsdfState, points: Tensor,
              valid: Tensor, origin: Tensor) -> TsdfState:
    """Fuse one world-frame cloud into the TSDF (payload in place)."""
    pos, sdf, w = _ray_samples(cfg, points, valid, origin)
    return _integrate_samples(cfg, state, pos, sdf, w)
