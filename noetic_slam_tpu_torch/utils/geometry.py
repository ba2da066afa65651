"""SO(3)/SE(3)/quaternion maths (port of ``noetic_slam_tpu.utils.geometry``).

Conventions are the JAX module's: quaternions are ``(..., 4)`` ``(w, x, y,
z)`` (Hamilton), poses are (q, p) pairs or 4x4 homogeneous matrices, every
function broadcasts over leading batch dims. The host-side numpy helpers
(``quat_to_mat_np``, ``make_se3_np``, ``mat_to_quat_np``) are not ported:
they are numpy already and have no caller in the port.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def quat_identity(device=None, dtype=torch.float32) -> Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_mul(q1: Tensor, q2: Tensor) -> Tensor:
    """Hamilton product q1 ⊗ q2, both (..., 4) wxyz."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conj(q: Tensor) -> Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Broadcasting cross product over the last axis (jnp.cross)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4):
    v' = v + 2*qw*(u x v) + 2*u x (u x v), u = q.vec."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_step(q: Tensor, omega: Tensor, dt) -> Tensor:
    """First-order integration q <- normalize(q + 0.5*dt * q ⊗ (0, omega))."""
    dq = quat_mul(q, torch.cat([torch.zeros_like(omega[..., :1]), omega],
                               dim=-1))
    return quat_normalize(q + 0.5 * dt * dq)


def quat_to_mat(q: Tensor) -> Tensor:
    """Quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: Tensor) -> Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) wxyz, by the
    branch-free Shepperd construction of the JAX module (all four
    candidates, best-conditioned one kept, w >= 0)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)
    scores = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
                         dim=-1)
    idx = torch.argmax(scores, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)          # (..., 4, 4)
    gi = idx[..., None, None].expand(idx.shape + (1, 4))
    q = quat_normalize(torch.gather(cand, -2, gi)[..., 0, :])
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def so3_exp_quat(omega: Tensor) -> Tensor:
    """Rotation vector -> quaternion, with the JAX module's small-angle
    Taylor branch."""
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta_quad = theta_sq * theta_sq
    small = theta_sq < 1e-10
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    half = 0.5 * theta
    imag = torch.where(small, 0.5 - theta_sq / 48.0 + theta_quad / 3840.0,
                       torch.sin(half) / theta)
    real = torch.where(small, 1.0 - theta_sq / 8.0 + theta_quad / 384.0,
                       torch.cos(half))
    return torch.cat([real, imag * omega], dim=-1)


def so3_log_quat(q: Tensor) -> Tensor:
    """Quaternion -> rotation vector (inverse of so3_exp_quat)."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-8),
                        theta / torch.clamp(vn, min=1e-20))
    return q[..., 1:] * scale


def skew(v: Tensor) -> Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def make_se3(q: Tensor, p: Tensor) -> Tensor:
    """(q (..., 4), p (..., 3)) -> homogeneous (..., 4, 4)."""
    R = quat_to_mat(q)
    batch = torch.broadcast_shapes(R.shape[:-2], p.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = p
    T[..., 3, 3].fill_(1.0)
    return T


def se3_q_p(T: Tensor) -> tuple[Tensor, Tensor]:
    """Homogeneous (..., 4, 4) -> (q, p)."""
    return mat_to_quat(T[..., :3, :3]), T[..., :3, 3]


def transform_points(T: Tensor, pts: Tensor) -> Tensor:
    """Apply SE(3) (..., 4, 4) to points (..., N, 3)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def quat_angle_deg(q1: Tensor, q2: Tensor) -> Tensor:
    """Rotation angle between two quaternions in degrees (hemisphere
    aligned, 2*atan2(|vec|, |w|) of q1 ⊗ conj(q2))."""
    dot = torch.sum(q1 * q2, dim=-1, keepdim=True)
    q2a = torch.where(dot < 0, -q2, q2)
    dq = quat_mul(q1, quat_conj(q2a))
    theta = 2.0 * torch.atan2(torch.linalg.vector_norm(dq[..., 1:], dim=-1),
                              torch.abs(dq[..., 0]))
    return theta * (180.0 / math.pi)
