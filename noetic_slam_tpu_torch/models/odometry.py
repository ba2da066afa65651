"""DLIO-style LiDAR-inertial odometry step (port of
``noetic_slam_tpu.models.odometry``).

The JAX module compiles the whole per-scan computation into one pure
function ``(OdomState, StepInput) -> (OdomState, StepOutput)``. The port
runs the same computation eagerly on fixed-shape tensors:

- ``OdomState`` is a NamedTuple of tensors; the keyframe store, the outbox
  ring and the trajectory ring are updated in place (JAX donated them).
- the three ``lax.cond``s (skip / bootstrap / submap re-gather) decide on
  the host from one scalar read each, and GICP's outer LM loop reads its
  continue flag once per iteration. Every such read is counted in the
  ``HostSyncs`` passed to ``make_odometry_step``;
- source covariances come from ``cov_engine``: the radius-weighted
  moments (``"radius"``) or each point's k nearest neighbours
  (``"knn"``, from a grid over the scan when ``nn_engine="grid"``);
- correspondences come from kernel A (``nn_engine="brute"``) or from the
  grid index over the submap that ``OdomState`` carries
  (``nn_engine="grid"``, ``ops.gridnn``), rebuilt with every submap;
- registration is ``align_fn`` (default ``ops.gicp.gicp_align``); the
  sharded path passes ``parallel.registration.make_sharded_align``.

Times in ``StepInput``/state are float32 seconds relative to the current
scan's header stamp, as in the JAX module.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from noetic_slam_tpu_torch import resolve_device
from noetic_slam_tpu_torch.config import DlioConfig
from noetic_slam_tpu_torch.models import occupancy as occ_mod
from noetic_slam_tpu_torch.models import tsdf as tsdf_mod
from noetic_slam_tpu_torch.ops import gicp as gicp_ops
from noetic_slam_tpu_torch.ops import gridnn
from noetic_slam_tpu_torch.ops import imu as imu_ops
from noetic_slam_tpu_torch.ops.deskew import deskew_points, transform_cloud
from noetic_slam_tpu_torch.ops.gicp import HostSyncs
from noetic_slam_tpu_torch.ops.pointcloud import (
    SENTINEL,
    Scan,
    const,
    crop_box,
    morton_sort_key,
    prepare_scan,
    put,
    take,
    voxel_downsample,
)
from noetic_slam_tpu_torch.utils.geometry import (
    cross,
    make_se3,
    quat_angle_deg,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    se3_q_p,
)

Tensor = torch.Tensor


class OdomState(NamedTuple):
    """The odometry state (device tensors, fixed shapes); the fields and
    their meaning are the JAX ``OdomState``'s."""
    q: Tensor            # (4,) observer orientation wxyz
    p: Tensor            # (3,)
    v: Tensor            # (3,)
    ba: Tensor           # (3,) accel bias
    bg: Tensor           # (3,) gyro bias
    lidar_q: Tensor      # (4,) GICP-fused pose
    lidar_p: Tensor      # (3,)
    prev_vel: Tensor     # (3,)
    T: Tensor            # (4, 4)
    T_prior: Tensor      # (4, 4)
    T_corr: Tensor       # (4, 4)
    first_opt_done: Tensor   # () bool
    kf_pos: Tensor       # (K, 3) keyframe store
    kf_quat: Tensor      # (K, 4)
    kf_xyz: Tensor       # (K, Nk, 3)
    kf_valid: Tensor     # (K, Nk) bool
    kf_cov: Tensor       # (K, Nk, 6)
    kf_count: Tensor     # () int32 resident keyframes
    kf_seq: Tensor       # (K,) int32 insertion sequence per slot
    kf_total: Tensor     # () int32 keyframes ever created
    ob_q: Tensor         # (Q, 4) keyframe outbox ring
    ob_p: Tensor         # (Q, 3)
    ob_seq: Tensor       # (Q,) int32
    ob_slot: Tensor      # (Q,) int32
    ob_xyz: Tensor       # (Q, Nk, 3)
    submap_xyz: Tensor   # (S, 3) registration target
    submap_valid: Tensor # (S,)
    submap_cov: Tensor   # (S, 6)
    submap_mask: Tensor  # (K,) bool current keyframe selection
    submap_count: Tensor # () int32 valid points (compacted to the front)
    submap_overflow: Tensor  # () int32 cumulative dropped selections
    grid_xyz: Tensor     # (S, 3) submap points sorted by grid cell key
    grid_keys: Tensor    # (S,) int32 sorted cell keys
    grid_order: Tensor   # (S,) int32 submap index of each sorted point
    grid_origin: Tensor  # (3,) cell-space origin
    spaciousness: Tensor # () adaptive-parameter LPF states
    density: Tensor      # ()
    source_density: Tensor   # ()
    keyframe_thresh_dist: Tensor  # ()
    prev_stamp_off: Tensor   # () rel. time of previous scan stamp
    prop_off: Tensor         # () propagation boundary offset
    traj: Tensor         # (Tcap, 12): step_idx, stamp, p(3), q(4), is_kf,
                         #             n_corr, iters
    num_scans: Tensor    # () int32 processed scans
    total_steps: Tensor  # () int32 step invocations (incl. skipped)
    reg_rejected: Tensor # () int32 scans whose correction failed the gate


_QSENT = 32767          # int16 sentinel of invalid rows (quantized wire)


class StepInput(NamedTuple):
    """One scan and its IMU context. Two wire formats, told apart by the
    dtype of ``points``: float32 (N, 4) = x, y, z, t with invalid rows at
    the 1e6 sentinel; or quantized int16 (N, 3) at the per-scan scale and
    offset in ``scalars[3:7]`` with float16 times in ``pt``, invalid rows at
    ``_QSENT``. Times are relative to this scan's header stamp."""
    points: Tensor      # (N, 4) f32  OR  (N, 3) int16
    imu: Tensor         # (M, 7): stamp, wx, wy, wz, fx, fy, fz
    scalars: Tensor     # (4,) or (8,): header_delta, deskew flag, imu_count,
                        #   [scale, off_x, off_y, off_z, pad]
    pt: Tensor | None = None   # (N,) f16 rel. times (quantized wire only)

    @property
    def quantized(self) -> bool:
        return self.points.dtype == torch.int16

    @property
    def valid(self) -> Tensor:
        if self.quantized:
            return self.points[:, 0] != _QSENT
        return (torch.abs(self.points[:, :3]) < 1e5).all(dim=-1)

    @property
    def xyz(self) -> Tensor:
        if self.quantized:
            dec = (self.points.to(torch.float32) * self.scalars[3]
                   + self.scalars[4:7])
            return torch.where(self.valid[:, None], dec, 1e6)
        return self.points[:, :3]

    @property
    def t(self) -> Tensor:
        if self.pt is not None:
            return self.pt.to(torch.float32)
        return self.points[:, 3]

    @property
    def imu_stamps(self) -> Tensor:
        return self.imu[:, 0]

    @property
    def imu_ang(self) -> Tensor:
        return self.imu[:, 1:4]

    @property
    def imu_acc(self) -> Tensor:
        return self.imu[:, 4:7]

    @property
    def header_delta(self) -> Tensor:
        return self.scalars[0]

    @property
    def deskew(self) -> Tensor:
        return self.scalars[1] > 0.5

    @property
    def imu_count(self) -> Tensor:
        return self.scalars[2].to(torch.int64)


class StepOutput(NamedTuple):
    pose_q: Tensor
    pose_p: Tensor
    lidar_q: Tensor
    lidar_p: Tensor
    world_xyz: Tensor    # (N, 3) deskewed, corrected world-frame cloud
    world_valid: Tensor  # (N,)
    scan_stamp: Tensor
    sweep_end: Tensor
    is_keyframe: Tensor
    processed: Tensor    # () bool (False: scan skipped)
    deskew_ok: Tensor
    gicp_iterations: Tensor
    gicp_error: Tensor
    num_corr: Tensor


def init_state(cfg: DlioConfig, device=None, q0=None, ba0=None, bg0=None
               ) -> OdomState:
    """Fresh state on ``device`` (``None``: the card); q0/ba0/bg0 from the
    host-side IMU calibration."""
    device = resolve_device(device)
    cap = cfg.capacity
    K, Nk = cap.max_keyframes, cap.max_ds_points
    S = cap.max_submap_kf * Nk
    Q = cap.outbox_slots
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)

    def vec(x, n):
        return (torch.zeros(n, **f32) if x is None
                else torch.as_tensor(np.asarray(x), **f32).clone())

    q0 = (torch.tensor([1.0, 0, 0, 0], **f32) if q0 is None
          else torch.as_tensor(np.asarray(q0), **f32).clone())
    T0 = torch.eye(4, **f32)
    T0[:3, :3] = quat_to_mat(q0)
    zero = lambda **kw: torch.zeros((), **kw)  # noqa: E731
    return OdomState(
        q=q0, p=torch.zeros(3, **f32), v=torch.zeros(3, **f32),
        ba=vec(ba0, 3), bg=vec(bg0, 3),
        lidar_q=q0.clone(), lidar_p=torch.zeros(3, **f32),
        prev_vel=torch.zeros(3, **f32),
        T=T0, T_prior=T0.clone(), T_corr=torch.eye(4, **f32),
        first_opt_done=zero(**b),
        kf_pos=torch.zeros((K, 3), **f32), kf_quat=torch.zeros((K, 4), **f32),
        kf_xyz=torch.full((K, Nk, 3), SENTINEL, **f32),
        kf_valid=torch.zeros((K, Nk), **b),
        kf_cov=torch.zeros((K, Nk, 6), **f32), kf_count=zero(**i32),
        kf_seq=torch.zeros((K,), **i32), kf_total=zero(**i32),
        ob_q=torch.zeros((Q, 4), **f32), ob_p=torch.zeros((Q, 3), **f32),
        ob_seq=torch.zeros((Q,), **i32), ob_slot=torch.zeros((Q,), **i32),
        ob_xyz=torch.full((Q, Nk, 3), SENTINEL, **f32),
        submap_xyz=torch.full((S, 3), SENTINEL, **f32),
        submap_valid=torch.zeros((S,), **b),
        submap_cov=torch.zeros((S, 6), **f32),
        submap_mask=torch.zeros((K,), **b),
        submap_count=zero(**i32), submap_overflow=zero(**i32),
        grid_xyz=torch.full((S, 3), SENTINEL, **f32),
        grid_keys=torch.full((S,), torch.iinfo(torch.int32).max, **i32),
        grid_order=torch.zeros((S,), **i32),
        grid_origin=torch.zeros((3,), **f32),
        spaciousness=zero(**f32), density=zero(**f32),
        source_density=zero(**f32),
        keyframe_thresh_dist=torch.tensor(cfg.keyframe.thresh_dist, **f32),
        prev_stamp_off=zero(**f32), prop_off=zero(**f32),
        traj=torch.zeros((cap.max_trajectory, 12), **f32),
        num_scans=zero(**i32), total_steps=zero(**i32),
        reg_rejected=zero(**i32),
    )


# ---------------------------------------------------------------------------
# IMU sample conditioning
# ---------------------------------------------------------------------------

def condition_imu(cfg: DlioConfig, stamps: Tensor, ang: Tensor, acc: Tensor,
                  ba: Tensor, bg: Tensor):
    """Extrinsic rotation, lever-arm compensation, bias/scale correction
    (the window predecessor supplies the Euler term)."""
    dev = stamps.device
    R = const(cfg.extrinsics.baselink2imu_R, dev).reshape(3, 3)
    t = const(cfg.extrinsics.baselink2imu_t, dev)
    sm = const(cfg.imu.accel_sm, dev).reshape(3, 3)
    w_cg = ang @ R.T
    a_cg = acc @ R.T
    dts = torch.clamp(torch.diff(stamps, prepend=stamps[:1]), min=1e-8)
    w_prev = torch.cat([w_cg[:1], w_cg[:-1]], dim=0)
    wdot = (w_cg - w_prev) / dts[:, None]
    a_cg = (a_cg + cross(wdot, -t[None, :])
            + cross(w_cg, cross(w_cg, -t[None, :])))
    a_corr = a_cg @ sm.T - ba
    w_corr = w_cg - bg
    return w_corr, a_corr


# ---------------------------------------------------------------------------
# Metrics + adaptive parameters
# ---------------------------------------------------------------------------

def _masked_median(x: Tensor, valid: Tensor) -> Tensor:
    """Element n_valid // 2 of the sorted valid entries (nth_element)."""
    xs = torch.sort(torch.where(valid, x, torch.inf)).values
    n = valid.sum()
    return take(xs, torch.clamp(n // 2, 0, x.shape[0] - 1))


def compute_adaptive(cfg: DlioConfig, state: OdomState, scan: Scan):
    """Spaciousness/density LPFs -> (threshD, max_corr_dist, sp_lpf,
    den_lpf), with setAdaptiveParams' boundary quirk."""
    r2d = torch.sqrt(scan.xyz[:, 0] ** 2 + scan.xyz[:, 1] ** 2)
    med = _masked_median(r2d, scan.valid)
    sp_lpf = torch.where(state.num_scans == 0, med,
                         0.95 * state.spaciousness + 0.05 * med)
    den_now = torch.where(state.first_opt_done, state.source_density, 0.0)
    den_lpf = torch.where(state.num_scans == 0, den_now,
                          0.95 * state.density + 0.05 * den_now)
    sp = torch.clamp(sp_lpf, 0.5, 5.0)
    mcd = cfg.gicp.max_corr_dist
    den = torch.clamp(den_lpf, 0.5 * mcd, 2.0 * mcd)
    den = torch.where(sp_lpf < 5.0, 0.5 * mcd, den)
    den = torch.where(sp_lpf > 5.0, 2.0 * mcd, den)
    if not cfg.adaptive:
        f32 = dict(dtype=torch.float32, device=sp.device)
        return (torch.full((), cfg.keyframe.thresh_dist, **f32),
                torch.full((), mcd, **f32), sp_lpf, den_lpf)
    return sp, den, sp_lpf, den_lpf


# ---------------------------------------------------------------------------
# Geometric observer scan-rate update
# ---------------------------------------------------------------------------

def geo_update(cfg: DlioConfig, state: OdomState, dt: Tensor) -> OdomState:
    g = cfg.geo
    qhat, pin, qin = state.q, state.lidar_p, state.lidar_q
    qe = quat_mul(quat_conj(qhat), qin)
    sgn = torch.where(qe[0] < 0, -1.0, 1.0)
    qcorr = torch.cat([(1.0 - torch.abs(qe[0]))[None], sgn * qe[1:]])
    qcorr = quat_mul(qhat, qcorr)
    err = pin - state.p
    err_body = quat_rotate(quat_conj(qhat), err)
    ba = torch.clamp(state.ba - dt * g.Kab * err_body,
                     -g.abias_max, g.abias_max)
    bg = torch.clamp(state.bg - dt * g.Kgb * qe[0] * qe[1:],
                     -g.gbias_max, g.gbias_max)
    p = state.p + dt * g.Kp * err
    v = state.v + dt * g.Kv * err
    q = quat_normalize(state.q + dt * g.Kq * qcorr)
    return state._replace(q=q, p=p, v=v, ba=ba, bg=bg, prev_vel=v)


# ---------------------------------------------------------------------------
# Keyframing
# ---------------------------------------------------------------------------

def _active(state: OdomState) -> Tensor:
    K = state.kf_pos.shape[0]
    return torch.arange(K, device=state.kf_pos.device) < state.kf_count


def keyframe_decision(state: OdomState, thresh_dist: Tensor,
                      thresh_rot: float) -> Tensor:
    """dd > threshD OR (theta > threshR AND at most one keyframe nearby)."""
    active = _active(state)
    d = torch.linalg.vector_norm(state.kf_pos - state.p[None, :], dim=-1)
    d = torch.where(active, d, torch.inf)
    num_nearby = torch.sum((d <= thresh_dist * 1.5) & active)
    closest = torch.argmin(d)
    dd = take(d, closest)
    theta = quat_angle_deg(state.q, take(state.kf_quat, closest))
    return (dd > thresh_dist) | ((theta > thresh_rot) & (num_nearby <= 1))


_KF_PROTECT_RECENT = 4   # newest keyframes never evicted


def select_eviction_victim(state: OdomState) -> Tensor:
    """Slot to overwrite when the store is full: the keyframe nearest to
    another one, excluding the ``_KF_PROTECT_RECENT`` newest."""
    K = state.kf_pos.shape[0]
    active = _active(state)
    d2 = torch.sum((state.kf_pos[:, None, :] - state.kf_pos[None, :, :]) ** 2,
                   dim=-1)
    eye = torch.eye(K, dtype=torch.bool, device=d2.device)
    pair_ok = active[:, None] & active[None, :] & ~eye
    nnd = torch.where(pair_ok, d2, torch.inf).amin(dim=1)
    recent = state.kf_seq > state.kf_total - _KF_PROTECT_RECENT
    return torch.argmin(torch.where(active & ~recent, nnd, torch.inf))


def push_keyframe(state: OdomState, cloud_xyz: Tensor, cloud_valid: Tensor,
                  cloud_cov: Tensor, enabled: Tensor) -> OdomState:
    """Insert a keyframe when ``enabled`` (append, or evict the most
    redundant one when full) and write it to the outbox ring: single-slot
    masked writes, in place."""
    K = state.kf_pos.shape[0]
    Q = state.ob_seq.shape[0]
    full = state.kf_count >= K
    i = torch.where(full, select_eviction_victim(state),
                    torch.clamp(state.kf_count, max=K - 1).long())
    o = torch.remainder(state.kf_total, Q).long()
    ok = enabled
    seq = (state.kf_total + 1).to(torch.int32)

    def write(buf: Tensor, j: Tensor, new: Tensor) -> None:
        put(buf, j, torch.where(ok, new, take(buf, j)))

    write(state.ob_q, o, state.lidar_q)
    write(state.ob_p, o, state.lidar_p)
    write(state.ob_seq, o, seq)
    write(state.ob_slot, o, i.to(torch.int32))
    write(state.ob_xyz, o, cloud_xyz)
    write(state.kf_pos, i, state.lidar_p)
    write(state.kf_quat, i, state.lidar_q)
    write(state.kf_xyz, i, cloud_xyz)
    write(state.kf_valid, i, cloud_valid)
    write(state.kf_cov, i, cloud_cov)
    write(state.kf_seq, i, seq)
    inc = ok.to(torch.int32)
    return state._replace(
        kf_count=torch.clamp(state.kf_count + inc, max=K),
        kf_total=state.kf_total + inc)


# ---------------------------------------------------------------------------
# Submap selection + gather
# ---------------------------------------------------------------------------

def _support_directions(n: int = 42) -> np.ndarray:
    """Quasi-uniform unit directions (Fibonacci sphere)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    d = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
                  np.cos(phi)], axis=-1)
    return np.asarray(d, "float32")


_SUPPORT_DIRS = _support_directions()
_CONVEX_DIRS = _support_directions(256)


def convex_hull_mask(kf_pos: Tensor, active: Tensor,
                     dirs: np.ndarray | None = None) -> Tensor:
    """Convex-hull vertex membership by support points over fixed
    Fibonacci directions plus each keyframe's centroid ray."""
    dirs = const(tuple(map(tuple, _CONVEX_DIRS if dirs is None else dirs)),
                 kf_pos.device)
    n_act = torch.clamp(active.sum(), min=1)
    centroid = torch.where(active[:, None], kf_pos, 0.0).sum(0) / n_act
    rays = kf_pos - centroid[None, :]
    rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1,
                                                       keepdim=True),
                              min=1e-9)
    all_dirs = torch.cat([dirs, rays], dim=0)
    proj = kf_pos @ all_dirs.T                      # (K, D + K)
    proj = torch.where(active[:, None], proj, -torch.inf)
    hull_idx = torch.argmax(proj, dim=0)
    mask = torch.zeros(kf_pos.shape[:1], dtype=torch.bool,
                       device=kf_pos.device)
    return mask.index_fill_(0, hull_idx, True) & active


def alpha_boundary_mask(kf_pos: Tensor, active: Tensor, alpha: Tensor,
                        dirs: np.ndarray | None = None) -> Tensor:
    """Alpha-shape boundary membership: i is on the boundary iff some
    open ball of radius alpha touching i (centre p_i + alpha*d over the
    direction set) holds no other point."""
    dirs = const(tuple(map(tuple, _SUPPORT_DIRS if dirs is None else dirs)),
                 kf_pos.device)
    K, D = kf_pos.shape[0], dirs.shape[0]
    centers = (kf_pos[:, None, :] + alpha * dirs[None, :, :]).reshape(-1, 3)
    d2 = (torch.sum(centers ** 2, -1)[:, None]
          - 2.0 * (centers @ kf_pos.T)
          + torch.sum(kf_pos ** 2, -1)[None, :])
    d2 = torch.where(active[None, :], d2, torch.inf)
    empty = (d2 >= (alpha * alpha) * (1.0 - 1e-3)).all(dim=-1)
    return empty.reshape(K, D).any(dim=-1) & active


def _knn_of(mask: Tensor, d: Tensor, k: int) -> Tensor:
    """The k smallest of d among ``mask``."""
    dm = torch.where(mask, d, torch.inf)
    idx = torch.topk(dm, min(k, d.shape[0]), largest=False).indices
    out = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
    return out.index_fill_(0, idx, True) & mask


def select_submap_keyframes(cfg: DlioConfig, state: OdomState,
                            alpha: Tensor | None = None) -> Tensor:
    """Keyframe selection: distance kNN ∪ convex-hull kNN (>= 4 keyframes)
    ∪ concave-hull kNN (>= 5 keyframes); alpha = adaptive threshD."""
    active = _active(state)
    d = torch.linalg.vector_norm(state.kf_pos - state.p[None, :], dim=-1)
    d = torch.where(active, d, torch.inf)
    if alpha is None:
        alpha = state.keyframe_thresh_dist
    mask = _knn_of(active, d, cfg.submap.knn)
    cv = convex_hull_mask(state.kf_pos, active)
    mask = mask | (_knn_of(cv, d, cfg.submap.kcv) & (state.kf_count >= 4))
    if cfg.submap.kcc > 0:
        cc = alpha_boundary_mask(state.kf_pos, active, alpha)
        mask = mask | (_knn_of(cc, d, cfg.submap.kcc)
                       & (state.kf_count >= 5))
    return mask & active


def gather_submap(cfg: DlioConfig, state: OdomState, mask: Tensor):
    """Concatenate the selected keyframe clouds into the submap buffers,
    Morton-sorted (valid points compacted to the front, compact tile
    boxes for kernel A). Returns (xyz, valid, cov, count, overflow)."""
    K, Nk = state.kf_xyz.shape[0], state.kf_xyz.shape[1]
    Smax_kf = cfg.capacity.max_submap_kf
    dev = mask.device
    overflow = torch.clamp(mask.sum() - Smax_kf, min=0).to(torch.int32)
    sel_rank = torch.cumsum(mask, 0) - 1
    kf_slots = torch.full((Smax_kf + 1,), K, dtype=torch.int64, device=dev)
    dest = torch.where(mask & (sel_rank < Smax_kf), sel_rank, Smax_kf)
    kf_slots[dest] = torch.arange(K, device=dev)
    kf_slots = kf_slots[:Smax_kf]
    safe = torch.clamp(kf_slots, max=K - 1)
    used = kf_slots < K
    xyz = torch.where(used[:, None, None], state.kf_xyz[safe], SENTINEL)
    valid = state.kf_valid[safe] & used[:, None]
    cov = torch.where(used[:, None, None], state.kf_cov[safe], 0.0)
    xyz = xyz.reshape(Smax_kf * Nk, 3)
    valid = valid.reshape(-1)
    cov = cov.reshape(Smax_kf * Nk, 6)
    key = morton_sort_key(xyz, valid, cell=1.0)
    order = torch.sort(key, stable=True).indices
    return (xyz[order], valid[order], cov[order],
            valid.sum().to(torch.int32), overflow)


# ---------------------------------------------------------------------------
# The per-scan step
# ---------------------------------------------------------------------------

def make_odometry_step(cfg: DlioConfig, syncs: HostSyncs | None = None,
                       align_fn=None):
    """The odometry step ``step(state, inp) -> (state, out)`` for ``cfg``.
    Host reads that decide control flow are counted in ``syncs``.

    ``align_fn(src_xyz, src_valid, src_cov, tgt_xyz, tgt_cov, cfg,
    max_corr_dist=, target_grid=, target_count=, syncs=) -> AlignResult``
    defaults to the one-device ``gicp_align``; the distributed path passes
    ``parallel.registration.make_sharded_align(mesh)``."""
    if cfg.gicp.nn_engine not in ("brute", "grid"):
        raise ValueError(f"nn_engine={cfg.gicp.nn_engine!r}: expected "
                         "'brute' or 'grid'")
    syncs = HostSyncs() if syncs is None else syncs
    align_fn = gicp_ops.gicp_align if align_fn is None else align_fn
    use_grid = cfg.gicp.nn_engine == "grid"
    # the cell covers the largest adaptive correspondence radius
    # (2 * max_corr_dist)
    grid_cell = 2.0 * cfg.gicp.max_corr_dist
    cap = cfg.capacity
    R_ext = np.asarray(cfg.extrinsics.baselink2lidar_R,
                       np.float32).reshape(3, 3)
    t_ext = np.asarray(cfg.extrinsics.baselink2lidar_t, np.float32)
    T_ext_np = np.eye(4, dtype=np.float32)
    T_ext_np[:3, :3], T_ext_np[:3, 3] = R_ext, t_ext

    def step(state: OdomState, inp: StepInput):
        dev = state.q.device
        ext_R = const(tuple(map(tuple, R_ext)), dev)
        ext_t = const(tuple(t_ext), dev)
        T_ext = const(tuple(map(tuple, T_ext_np)), dev)
        f32 = dict(dtype=torch.float32, device=dev)

        # ---- intake: crop + mask ------------------------------------------
        with record_function("odometry.intake_deskew"):
            valid_in = inp.valid
            scan = Scan(inp.xyz, inp.t, valid_in,
                        valid_in.sum().to(torch.int32))
            scan = crop_box(scan, cfg.preproc.crop_size)

            threshD, max_corr, sp_lpf, den_lpf = compute_adaptive(
                cfg, state, scan)
            w_corr, a_corr = condition_imu(cfg, inp.imu_stamps, inp.imu_ang,
                                           inp.imu_acc, state.ba, state.bg)

            # deskew / prior
            prep = prepare_scan(scan, cap.max_deskew_frames)
            scan_stamp = torch.where(inp.deskew, prep.scan_stamp,
                                     torch.zeros((), **f32))
            sweep_end = torch.where(
                inp.deskew,
                take(prep.unique_t, torch.clamp(prep.unique_count - 1, 0,
                                                cap.max_deskew_frames - 1)),
                scan_stamp)
            sweep_end = torch.maximum(sweep_end, scan_stamp)
            prev_stamp = state.prev_stamp_off - inp.header_delta
            prop_start = state.prop_off - inp.header_delta

            window = imu_ops.slice_imu_window(
                inp.imu_stamps, w_corr, a_corr, inp.imu_count, prev_stamp,
                sweep_end, cap.max_imu_window)
            frames_q, frames_p, imu_ok = imu_ops.integrate_imu(
                window, prev_stamp, state.lidar_q, state.lidar_p,
                state.prev_vel, prep.unique_t, cfg.gravity)

            first_scan = state.kf_count == 0
            med = torch.clamp(prep.median_idx, 0, cap.max_deskew_frames - 1)
            T_imu = make_se3(take(frames_q, med), take(frames_p, med))
            use_imu = imu_ok & ~first_scan
            T_prior = torch.where(use_imu, T_imu, state.T)
            deskew_ok = inp.deskew & use_imu

            world_deskewed = deskew_points(prep, frames_q, frames_p, ext_R,
                                           ext_t)
            world_rigid = transform_cloud(prep.xyz, prep.valid,
                                          T_prior @ T_ext)
            world_pts = torch.where(deskew_ok, world_deskewed, world_rigid)
            world_pts = torch.where(prep.valid[:, None], world_pts, SENTINEL)

        # ---- voxel filter ---------------------------------------------------
        with record_function("odometry.voxel"):
            if cfg.preproc.voxelize:
                ds_xyz, ds_valid, _ = voxel_downsample(
                    world_pts, prep.valid, cfg.preproc.voxel_res,
                    cap.max_ds_points)
            else:
                ds_xyz = world_pts[: cap.max_ds_points]
                ds_valid = prep.valid[: cap.max_ds_points]
            enough_points = ds_valid.sum() > cfg.gicp.min_num_points

        # ---- source covariances ---------------------------------------------
        with record_function("odometry.covariances"):
            if cfg.gicp.cov_engine == "radius":
                src_cov, src_density = gicp_ops.radius_covariances(
                    ds_xyz, ds_valid, cfg.gicp.cov_radius)
            else:
                src_cov, src_density = gicp_ops.plane_covariances(
                    ds_xyz, ds_valid, cfg.gicp.k_correspondences,
                    use_grid=use_grid, cell=4.0 * cfg.preproc.voxel_res)

        # ---- observer IMU-rate propagation over the inter-scan interval ------
        with record_function("odometry.propagate"):
            prop_window = imu_ops.slice_imu_window(
                inp.imu_stamps, w_corr, a_corr, inp.imu_count, prop_start,
                sweep_end, cap.max_imu_window)
            q_prop, p_prop, v_prop = imu_ops.propagate_state_batch(
                state.q, state.p, state.v, prop_window, prop_window.count,
                cfg.gravity, start_exclusive=prop_start)
            if cfg.geo.max_velocity > 0:
                vn = torch.linalg.vector_norm(v_prop)
                v_prop = torch.where(
                    vn > cfg.geo.max_velocity,
                    v_prop * (cfg.geo.max_velocity
                              / torch.clamp(vn, min=1e-9)),
                    v_prop)
            last_idx = torch.clamp(prop_window.count - 1, 0,
                                   cap.max_imu_window - 1)
            prop_boundary = torch.where(
                prop_window.count > 0,
                torch.maximum(take(prop_window.stamps, last_idx),
                              prop_start),
                torch.maximum(sweep_end, prop_start))
            fod = state.first_opt_done
            state = state._replace(q=torch.where(fod, q_prop, state.q),
                                   p=torch.where(fod, p_prop, state.p),
                                   v=torch.where(fod, v_prop, state.v))

        zero_i = torch.zeros((), dtype=torch.int64, device=dev)
        zero_diag = (zero_i, torch.zeros((), **f32), zero_i)
        true = torch.ones((), dtype=torch.bool, device=dev)

        def with_submap(st: OdomState, mask: Tensor) -> OdomState:
            sm_xyz, sm_valid, sm_cov, sm_count, sm_over = gather_submap(
                cfg, st, mask)
            st = st._replace(
                submap_xyz=sm_xyz, submap_valid=sm_valid, submap_cov=sm_cov,
                submap_mask=mask, submap_count=sm_count,
                submap_overflow=st.submap_overflow + sm_over)
            if use_grid:
                g = gridnn.build_grid(sm_xyz, sm_valid, grid_cell)
                st = st._replace(grid_xyz=g.xyz, grid_keys=g.keys,
                                 grid_order=g.order, grid_origin=g.origin)
            return st

        def bootstrap(st: OdomState):
            with record_function("odometry.keyframe_submap"):
                st = push_keyframe(st, ds_xyz, ds_valid, src_cov, true)
                mask = select_submap_keyframes(cfg, st, alpha=threshD)
                st = with_submap(st, mask)._replace(T_prior=T_prior)
            return st, (true, zero_diag)

        def register(st: OdomState):
            with record_function("odometry.gicp"):
                grid = (gridnn.Grid(st.grid_xyz, st.grid_keys,
                                    st.grid_order, st.grid_origin,
                                    torch.full((), grid_cell, **f32))
                        if use_grid else None)
                res = align_fn(
                    ds_xyz, ds_valid, src_cov, st.submap_xyz, st.submap_cov,
                    cfg.gicp, max_corr_dist=max_corr, target_grid=grid,
                    target_count=st.submap_count, syncs=syncs)
            with record_function("odometry.keyframe_submap"):
                # degenerate-registration gate: fall back to the IMU prior
                if cfg.gicp.max_correction > 0:
                    reg_ok = (torch.linalg.vector_norm(res.T[:3, 3])
                              < cfg.gicp.max_correction)
                else:
                    reg_ok = true
                T_corr = torch.where(reg_ok, res.T, torch.eye(4, **f32))
                T_new = T_corr @ T_prior
                lq, lp = se3_q_p(T_new)
                st = st._replace(
                    T=T_new, T_corr=T_corr, T_prior=T_prior, lidar_q=lq,
                    lidar_p=lp,
                    reg_rejected=st.reg_rejected + (~reg_ok).to(torch.int32))
                st = geo_update(cfg, st, scan_stamp - prev_stamp)

                is_kf = keyframe_decision(st, threshD, cfg.keyframe.thresh_rot)
                kf_cloud = transform_cloud(ds_xyz, ds_valid, T_corr)
                kf_cov = gicp_ops.rotate_sym6(src_cov, T_corr[:3, :3])
                st = push_keyframe(st, kf_cloud, ds_valid, kf_cov, is_kf)

                mask = select_submap_keyframes(cfg, st, alpha=threshD)
                # rebuild the registration target only when the selection
                # changed (the reference's "if submap has changed" gate)
                if syncs.read(torch.any(mask != st.submap_mask)):
                    st = with_submap(st, mask)
            st = st._replace(first_opt_done=true)
            return st, (is_kf, (res.iterations, res.error, res.num_corr))

        # one read decides both the skip and the bootstrap branch
        enough, first = syncs.read(enough_points, first_scan)
        if enough:
            st, (is_kf, diag) = bootstrap(state) if first else register(state)
            row = torch.cat([
                st.total_steps.to(torch.float32)[None], scan_stamp[None],
                st.lidar_p, st.lidar_q, is_kf.to(torch.float32)[None],
                diag[2].to(torch.float32)[None],
                diag[0].to(torch.float32)[None]])
            put(st.traj, torch.clamp(st.num_scans, max=cap.max_trajectory - 1),
                row)
            new_state = st._replace(
                spaciousness=sp_lpf, density=den_lpf,
                source_density=src_density, keyframe_thresh_dist=threshD,
                prev_stamp_off=scan_stamp, num_scans=st.num_scans + 1)
        else:
            # too few points: drop the scan; the observer propagation above
            # still applies, prev_stamp keeps pointing at the last scan
            new_state = state._replace(prev_stamp_off=prev_stamp)
            is_kf, diag = torch.zeros((), dtype=torch.bool,
                                      device=dev), zero_diag
        new_state = new_state._replace(
            prop_off=prop_boundary, total_steps=new_state.total_steps + 1)

        out_cloud = transform_cloud(world_pts, prep.valid, new_state.T_corr)
        out = StepOutput(
            pose_q=new_state.q, pose_p=new_state.p,
            lidar_q=new_state.lidar_q, lidar_p=new_state.lidar_p,
            world_xyz=out_cloud, world_valid=prep.valid,
            scan_stamp=scan_stamp, sweep_end=sweep_end,
            is_keyframe=is_kf, processed=enough_points, deskew_ok=deskew_ok,
            gicp_iterations=diag[0], gicp_error=diag[1], num_corr=diag[2])
        return new_state, out

    return step


def make_map_fuse(cfg: DlioConfig):
    """The fused step's map update: ``fuse(map_state, out) -> map_state``.

    The map backend follows ``cfg.map_backend``: ``"tsdf"`` (kernel B) or
    ``"occupancy"`` (kernel C). Skipped scans are gated by zeroing the
    sample weights or deltas, as in JAX (no host read)."""
    if cfg.map_backend == "occupancy":
        def fuse(map_state, out: StepOutput):
            with record_function("occupancy.fuse"):
                pos, delta = occ_mod._beam_samples(
                    cfg.occupancy, out.world_xyz, out.world_valid,
                    out.lidar_p)
                delta = delta * out.processed.to(delta.dtype)
                return occ_mod._integrate_deltas(cfg.occupancy, map_state,
                                                 pos, delta)
    elif cfg.map_backend == "tsdf":
        def fuse(map_state, out: StepOutput):
            with record_function("tsdf.fuse"):
                pos, sdf, w = tsdf_mod._ray_samples(
                    cfg.tsdf, out.world_xyz, out.world_valid, out.lidar_p)
                w = w * out.processed.to(w.dtype)
                return tsdf_mod._integrate_samples(cfg.tsdf, map_state, pos,
                                                   sdf, w)
    else:
        raise ValueError(f"map_backend={cfg.map_backend!r}: expected "
                         "'tsdf' or 'occupancy'")
    return fuse


def make_slam_step(cfg: DlioConfig, syncs: HostSyncs | None = None,
                   align_fn=None):
    """Odometry + dense-map fusion (``make_map_fuse``):
    ``step((odom_state, map_state), inp) -> ((odom_state, map_state), out)``.
    """
    fuse = make_map_fuse(cfg)
    odo = make_odometry_step(cfg, syncs, align_fn)

    def step(carry, inp: StepInput):
        odom_state, map_state = carry
        odom_state, out = odo(odom_state, inp)
        return (odom_state, fuse(map_state, out)), out

    return step
