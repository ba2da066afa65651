"""Occupancy-grid map backend, Octomap class (port of
``noetic_slam_tpu.models.occupancy``).

Same design as the JAX module: the TSDF backend's sorted block directory
and fixed-slot payload, here one f32 log-odds per voxel. Each scan's beams
give an endpoint hit (``l_hit``) and ``miss_samples`` free-space samples
(``l_miss``); after the block-major sort (``tsdf.block_runs``, shared with
the TSDF backend) every touched block owns one contiguous range of the
(ivox, delta) stream. The payload update is kernel C on the card
(``ops.cuda.logodds_kernel.logodds_accumulate``) and its plain version on
the CPU: ``L = clip(L + Σdelta, l_min, l_max)`` per touched voxel, with all
of a scan's deltas for a voxel summed before the one clamp (the clamp is at
scan granularity, never per sample). Both update the payload in place,
where JAX donated the state.

Porting notes:
- JAX's XLA fallback clips every payload row, the identity on untouched
  ones; the port touches only the candidate rows, as the kernel route does.
- The TPU-only reorder for the Pallas kernel (padding entries first, row
  groups) is not ported.
- Occupied iff ``L > occ_thresh``; probability ``1 - 1 / (1 + exp(L))``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from noetic_slam_tpu_torch import resolve_device
from noetic_slam_tpu_torch.config import OccupancyConfig
from noetic_slam_tpu_torch.models.tsdf import (
    BLOCK_VOLUME,
    KEY_PAD,
    block_runs,
    sample_keys,
    slot_used,
    voxel_centers,
)
from noetic_slam_tpu_torch.ops.cuda.logodds_kernel import (
    logodds_accumulate,
    logodds_accumulate_plain,
)

Tensor = torch.Tensor


class OccupancyState(NamedTuple):
    dir_keys: Tensor    # (C,) int32 sorted block keys (pad = INT32_MAX)
    dir_slots: Tensor   # (C,) int32 payload slot per key
    num_blocks: Tensor  # () int32
    logodds: Tensor     # (C, 512) f32 clamped log-odds
    dropped: Tensor     # () int32 blocks dropped for capacity


def init_occupancy(cfg: OccupancyConfig, device=None) -> OccupancyState:
    """An empty occupancy map on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    C = cfg.max_blocks
    i32 = dict(dtype=torch.int32, device=device)
    return OccupancyState(
        dir_keys=torch.full((C,), KEY_PAD, **i32),
        dir_slots=torch.zeros((C,), **i32),
        num_blocks=torch.zeros((), **i32),
        logodds=torch.zeros((C, BLOCK_VOLUME), dtype=torch.float32,
                            device=device),
        dropped=torch.zeros((), **i32),
    )


def _beam_samples(cfg: OccupancyConfig, points: Tensor, valid: Tensor,
                  origin: Tensor) -> tuple[Tensor, Tensor]:
    """(pos (N*(1+M), 3), delta (N*(1+M),)) of one scan: per beam the
    endpoint hit, then ``miss_samples`` free-space samples strictly inside
    the beam (they stop one voxel short of the endpoint, so misses never
    cancel the hit)."""
    dev = points.device
    N = points.shape[0]
    d = points - origin
    r = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    ok = (valid & (r[:, 0] > 0.3) & (r[:, 0] < cfg.max_range)
          ).to(torch.float32)
    u = d / torch.clamp(r, min=1e-6)

    hit_delta = torch.full((N, 1), cfg.l_hit, device=dev) * ok[:, None]
    M = cfg.miss_samples
    frac = (torch.arange(M, device=dev, dtype=torch.float32) + 0.5) / M
    miss_r = frac[None, :] * torch.clamp(r - cfg.voxel_size, min=0.0)
    miss_pos = origin + u[:, None, :] * miss_r[:, :, None]
    miss_delta = torch.full((N, M), cfg.l_miss, device=dev) * ok[:, None]

    pos = torch.cat([points[:, None, :], miss_pos], dim=1).reshape(-1, 3)
    delta = torch.cat([hit_delta, miss_delta], dim=1).reshape(-1)
    return pos, delta


def delta_stream(cfg: OccupancyConfig, state: OccupancyState, pos: Tensor,
                 delta: Tensor):
    """``block_runs`` on the samples with a non-zero delta, then the gather
    of (ivox, delta) into block order. Returns the state with its new
    directory (payload untouched), the ``BlockRuns`` and the sorted stream
    ``(ivox, delta)``: kernel C's operands."""
    gk, ivox = sample_keys(pos, cfg.voxel_size, delta != 0.0)
    state, r = block_runs(state, gk, cfg.scan_block_cap)
    return state, r, tuple(x[r.order].contiguous() for x in (ivox, delta))


def _integrate_deltas(cfg: OccupancyConfig, state: OccupancyState,
                      pos: Tensor, delta: Tensor) -> OccupancyState:
    """Fuse one batch of (position, log-odds delta) samples: the shared
    block-stream skeleton, then the clamped payload update of the candidate
    rows, kernel C on the card and its plain version on the CPU, in
    place."""
    state, r, stream = delta_stream(cfg, state, pos, delta)
    accumulate = (logodds_accumulate if state.logodds.is_cuda
                  else logodds_accumulate_plain)
    accumulate(state.logodds, r.rows, r.starts, r.cnts, *stream, cfg.l_min,
               cfg.l_max)
    return state


def integrate(cfg: OccupancyConfig, state: OccupancyState, points: Tensor,
              valid: Tensor, origin: Tensor) -> OccupancyState:
    """Fuse one world-frame registered cloud into the map (in place)."""
    pos, delta = _beam_samples(cfg, points, valid, origin)
    return _integrate_deltas(cfg, state, pos, delta)


def integrate_signed(cfg: OccupancyConfig, state: OccupancyState,
                     points: Tensor, valid: Tensor, origin: Tensor,
                     sign) -> OccupancyState:
    """Fuse (sign = +1) or de-fuse (sign = -1) one cloud: the keyframe
    archive's volume primitive. Exact inversion needs an unclamped config
    (``l_min``/``l_max`` at -/+1e30, where the clip is the identity);
    readers of the probability clamp at read time instead."""
    pos, delta = _beam_samples(cfg, points, valid, origin)
    return _integrate_deltas(cfg, state, pos, delta * sign)


def rebuild_from_keyframes(cfg: OccupancyConfig, kf_xyz: Tensor,
                           kf_valid: Tensor, kf_pos: Tensor,
                           kf_count: Tensor) -> OccupancyState:
    """Re-fuse the map from the (deformed) keyframe clouds, each from its
    keyframe position, on ``kf_xyz``'s device; slots at or beyond
    ``kf_count`` are gated by zero deltas (same contract as
    ``tsdf.rebuild_from_keyframes``)."""
    state = init_occupancy(cfg, kf_xyz.device)
    for k in range(kf_xyz.shape[0]):
        pos, delta = _beam_samples(cfg, kf_xyz[k], kf_valid[k], kf_pos[k])
        delta = delta * (kf_count > k).to(delta.dtype)
        state = _integrate_deltas(cfg, state, pos, delta)
    return state


def occupancy_prob(state: OccupancyState) -> Tensor:
    """Per-voxel occupancy probability (C, 512)."""
    return 1.0 - 1.0 / (1.0 + torch.exp(state.logodds))


def extract_occupied(cfg: OccupancyConfig, state: OccupancyState):
    """(centres (C*512, 3), log-odds (C*512,), mask of occupied voxels);
    the host compacts (``tsdf.extract_surface``'s contract)."""
    centers = voxel_centers(cfg, state).reshape(-1, 3)
    L = state.logodds.reshape(-1)
    mask = ((L > cfg.occ_thresh)
            & slot_used(state).repeat_interleave(BLOCK_VOLUME))
    return centers, L, mask
