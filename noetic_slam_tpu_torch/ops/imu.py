"""Continuous-time analytic IMU integration (port of
``noetic_slam_tpu.ops.imu``).

The numerical model is the JAX module's (see its docstring): per-interval
delta quaternions composed by a prefix Hamilton product, world
accelerations as a batched rotation, velocity and position as cumulative
sums, and closed-form interpolation of every query in its bracketing
interval. Idiom changes:

- ``lax.associative_scan(quat_mul)`` becomes ``quat_prefix``'s log-depth
  doubling scan (Hillis-Steele): ceil(log2 K) rounds of one batched
  product, instead of K tiny launches.
- ``lax.dynamic_slice`` with a traced start becomes a gather at
  ``lo + arange(capacity)``, so no start index is read on the host.
- ``jax.vmap(interp)`` becomes batched indexing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from noetic_slam_tpu_torch.ops.pointcloud import const, take
from noetic_slam_tpu_torch.utils.geometry import (
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_step,
)

Tensor = torch.Tensor


class ImuWindow(NamedTuple):
    """Fixed-size window of bias-corrected, baselink-frame IMU samples
    (stamps ascending over the valid prefix, padding stamps >= the last
    valid one)."""
    stamps: Tensor     # (M,)
    ang_vel: Tensor    # (M, 3)
    lin_accel: Tensor  # (M, 3)
    count: Tensor      # () int


def slice_imu_window(buf_stamps: Tensor, buf_ang_vel: Tensor,
                     buf_accel: Tensor, buf_count: Tensor,
                     start_time: Tensor, end_time: Tensor,
                     capacity: int) -> ImuWindow:
    """Select the integration window (imuMeasFromTimeRange): it starts at
    the newest sample with stamp < start_time and runs through the first
    sample with stamp >= end_time."""
    buf_stamps = buf_stamps.contiguous()
    n = buf_stamps.shape[0]
    if n < capacity:
        pad = capacity - n
        last = buf_stamps[n - 1]
        buf_stamps = torch.cat([buf_stamps, last + 1.0 + torch.arange(
            pad, dtype=buf_stamps.dtype, device=buf_stamps.device)])
        buf_ang_vel = torch.cat([buf_ang_vel, buf_ang_vel.new_zeros(pad, 3)])
        buf_accel = torch.cat([buf_accel, buf_accel.new_zeros(pad, 3)])
        n = capacity
    start_time = torch.as_tensor(start_time, dtype=buf_stamps.dtype,
                                 device=buf_stamps.device).reshape(1)
    end_time = torch.as_tensor(end_time, dtype=buf_stamps.dtype,
                               device=buf_stamps.device).reshape(1)
    lo = torch.searchsorted(buf_stamps, start_time)[0] - 1
    lo = torch.clamp(lo, 0, n - capacity)
    idx = lo + torch.arange(capacity, device=buf_stamps.device)
    hi = torch.searchsorted(buf_stamps, end_time)[0]       # first >= end
    count = torch.clamp(torch.minimum(hi + 1, buf_count) - lo, 0, capacity)
    return ImuWindow(buf_stamps[idx], buf_ang_vel[idx], buf_accel[idx],
                     count)


def _gravity(gravity: float, like: Tensor) -> Tensor:
    """(0, 0, g) on like's device."""
    return const((0.0, 0.0, gravity), like.device)


class _IntervalData(NamedTuple):
    q_end: Tensor   # (M-1, 4) orientation at interval end
    p0: Tensor      # (M-1, 3)
    v0: Tensor      # (M-1, 3)
    a0: Tensor      # (M-1, 3) world accel (gravity removed) at s_i
    jerk: Tensor    # (M-1, 3)
    alpha: Tensor   # (M-1, 3) angular accel
    w0: Tensor      # (M-1, 3)
    t0: Tensor      # (M-1,)


def quat_prefix(q0: Tensor, omegas: Tensor, dts: Tensor) -> Tensor:
    """Orientations at every sample from first-order steps:
    q_{k+1} = normalize(q_k ⊗ (1, 0.5*dt_k*omega_k)).

    Inclusive prefix product of the deltas by a doubling scan (element k
    takes ``x[k-s] ⊗ x[k]`` for s = 1, 2, 4, ...), normalised once at the
    end (|a ⊗ b| = |a||b|). Args: q0 (4,), omegas (K, 3), dts (K,).
    Returns (K+1, 4)."""
    half = 0.5 * dts[:, None] * omegas
    x = torch.cat([torch.ones_like(half[:, :1]), half], dim=-1)   # (K, 4)
    k = x.shape[0]
    s = 1
    while s < k:
        x = torch.cat([x[:s], quat_mul(x[:-s], x[s:])], dim=0)
        s *= 2
    q_all = torch.cat([q0[None], quat_mul(q0[None], x)], dim=0)
    return quat_normalize(q_all)


def _cumsum0(d: Tensor) -> Tensor:
    """Exclusive-from-zero cumulative sum: (K, 3) -> (K+1, 3)."""
    return torch.cat([torch.zeros_like(d[:1]), torch.cumsum(d, dim=0)], dim=0)


def _scan_intervals(window: ImuWindow, q0: Tensor, p0: Tensor, v0: Tensor,
                    gravity: float) -> _IntervalData:
    g = _gravity(gravity, p0)
    stamps, w, f = window.stamps, window.ang_vel, window.lin_accel
    dts = torch.clamp(stamps[1:] - stamps[:-1], min=1e-8)

    omega = w[:-1] + 0.5 * (w[1:] - w[:-1])
    q_all = quat_prefix(q0, omega, dts)                       # (M, 4)
    a_all = quat_rotate(q_all, f) - g                         # (M, 3)

    a0, a1 = a_all[:-1], a_all[1:]
    jerk = (a1 - a0) / dts[:, None]
    dv = 0.5 * (a0 + a1) * dts[:, None]
    v_all = v0[None] + _cumsum0(dv)
    dp = (v_all[:-1] * dts[:, None] + 0.5 * a0 * (dts ** 2)[:, None]
          + (1.0 / 6.0) * jerk * (dts ** 3)[:, None])
    p_all = p0[None] + _cumsum0(dp)
    alpha = (w[1:] - w[:-1]) / dts[:, None]
    return _IntervalData(q_end=q_all[1:], p0=p_all[:-1], v0=v_all[:-1],
                         a0=a0, jerk=jerk, alpha=alpha, w0=w[:-1],
                         t0=stamps[:-1])


def integrate_imu(window: ImuWindow, start_time: Tensor, q_init: Tensor,
                  p_init: Tensor, v_init: Tensor, query_times: Tensor,
                  gravity: float = 9.80665):
    """Integrate IMU over ``window`` and interpolate poses at the sorted
    ``query_times``. Returns (q (Q, 4), p (Q, 3), ok ()), ``ok`` replicating
    the reference's failure conditions (queries covered, start after the
    first sample, at least two samples)."""
    stamps, w, f = window.stamps, window.ang_vel, window.lin_accel

    # backward extrapolation start_time -> first sample
    dt01 = torch.clamp(stamps[1] - stamps[0], min=1e-8)
    idt = start_time - stamps[0]
    alpha01 = (w[1] - w[0]) / dt01
    omega_bwd = -(w[0] + 0.5 * alpha01 * idt)
    q0 = quat_step(q_init, omega_bwd, idt)
    q1 = quat_step(q0, w[0] + 0.5 * (w[1] - w[0]), dt01)
    g = _gravity(gravity, p_init)
    a0 = quat_rotate(q0, f[0]) - g
    a1 = quat_rotate(q1, f[1]) - g
    j01 = (a1 - a0) / dt01
    v0 = v_init - (a0 * idt + 0.5 * j01 * idt * idt)
    p0 = p_init - (v0 * idt + 0.5 * a0 * idt * idt
                   + (1.0 / 6.0) * j01 * idt ** 3)

    iv = _scan_intervals(window, q0, p0, v0, gravity)

    # t in (s_i, s_{i+1}]  =>  i = searchsorted(stamps, t, left) - 1
    i = torch.clamp(torch.searchsorted(stamps, query_times) - 1,
                    0, stamps.shape[0] - 2)
    it = (query_times - iv.t0[i])[:, None]
    omega_q = iv.w0[i] + 0.5 * iv.alpha[i] * it
    q_out = quat_step(iv.q_end[i], omega_q, it)
    p_out = (iv.p0[i] + iv.v0[i] * it + 0.5 * iv.a0[i] * it * it
             + (1.0 / 6.0) * iv.jerk[i] * it ** 3)

    last_q = query_times[-1]
    covered = take(stamps, torch.clamp(window.count - 1,
                                       max=stamps.shape[0] - 1)) >= last_q
    ok = (start_time >= stamps[0]) & (window.count >= 2) & covered
    return quat_normalize(q_out), p_out, ok


def propagate_state_batch(q: Tensor, p: Tensor, v: Tensor,
                          window: ImuWindow, count: Tensor,
                          gravity: float = 9.80665,
                          start_exclusive: Tensor | None = None):
    """Observer IMU-rate prediction (propagateState) over ``count`` samples
    of the window; intervals ending at or before ``start_exclusive``
    (+0.1 ms) are skipped so no interval is applied twice across scans.
    Returns the propagated (q, p, v)."""
    g = _gravity(gravity, p)
    stamps, wv, f = window.stamps, window.ang_vel, window.lin_accel
    ks = torch.arange(stamps.shape[0] - 1, device=stamps.device)
    dts = torch.clamp(stamps[1:] - stamps[:-1], min=0.0)
    dts = torch.where(ks < count - 1, dts, 0.0)
    if start_exclusive is not None:
        dts = torch.where(stamps[1:] > start_exclusive + 1e-4, dts, 0.0)

    q_all = quat_prefix(q, wv[1:], dts)                       # (M, 4)
    acc_w = quat_rotate(q_all[:-1], f[1:]) - g                # (M-1, 3)
    dv = acc_w * dts[:, None]
    v_pre = v[None] + _cumsum0(dv[:-1])
    pf = p + torch.sum(v_pre * dts[:, None]
                       + 0.5 * (dts ** 2)[:, None] * acc_w, dim=0)
    vf = v + torch.sum(dv, dim=0)
    return q_all[-1], pf, vf
