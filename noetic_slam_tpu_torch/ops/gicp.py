"""GICP scan-to-map registration (port of ``noetic_slam_tpu.ops.gicp``).

Same maths as the JAX module: compact 6-vector covariances, radius-weighted
plane covariances, 1-NN correspondences with Mahalanobis weights
(C_B + R C_A R^T)^-1, masked H/b accumulation, and the Levenberg-Marquardt
schedule of NanoGICP.

The two ``lax.while_loop``s of ``gicp_align`` become:
- the inner LM lambda search: ``ops.cuda.lm_kernel.lm_search``, every
  candidate of the fixed lambda schedule solved and scored in one pass
  over the pairs (kernel D on the card, its plain version on the CPU),
  with the early-exiting loop's result;
- the outer loop: a Python loop that reads the search's ``stop`` flag on
  the host once per iteration (each iteration costs an NN search anyway).
  Every such read is counted in ``syncs`` (see ``HostSyncs``).

The correspondences carry the gathered target rows, so the
linearisation and the search read them without indexing again.

With a ``target_grid`` (``ops.gridnn.Grid`` over the target, the step's
``nn_engine="grid"``) correspondences come from the grid search and
kernel A is not launched; a miss gets idx 0 and sqd 1e30.
``plane_covariances(use_grid=True)`` takes each point's neighbours from a
grid over the cloud itself.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from noetic_slam_tpu_torch.config import GicpConfig
from noetic_slam_tpu_torch.ops import gridnn, neighbors
from noetic_slam_tpu_torch.ops.cuda.lm_kernel import error_sums, lm_search
from noetic_slam_tpu_torch.runtime.profiling import span
from noetic_slam_tpu_torch.utils.geometry import cross, skew

Tensor = torch.Tensor

MAX_PER_CELL = 64   # grid candidates a cell (the JAX functions' default)


class HostSyncs:
    """Counts the device->host scalar reads that decide control flow (the
    places where JAX kept the decision on the device); each read is an
    ``odometry.host_read`` span, the time the host waits for the device's
    queued work."""

    def __init__(self) -> None:
        self.n = 0

    def read(self, *flags: Tensor):
        """One host read of one or more scalar flags, counted once.
        Returns a bool, or a tuple of bools for several flags."""
        self.n += 1
        with span("odometry.host_read"):
            if len(flags) == 1:
                return bool(flags[0])
            return tuple(torch.stack([f.to(torch.bool)
                                      for f in flags]).tolist())


# ---------------------------------------------------------------------------
# Compact symmetric 3x3 <-> full helpers
# ---------------------------------------------------------------------------

def sym6_to_mat(c: Tensor) -> Tensor:
    """(..., 6) (xx,xy,xz,yy,yz,zz) -> (..., 3, 3)."""
    xx, xy, xz, yy, yz, zz = c.unbind(-1)
    m = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], dim=-1)
    return m.reshape(c.shape[:-1] + (3, 3))


def mat_to_sym6(m: Tensor) -> Tensor:
    return torch.stack([m[..., 0, 0], m[..., 0, 1], m[..., 0, 2],
                        m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]], dim=-1)


def rotate_sym6(c: Tensor, R: Tensor) -> Tensor:
    """R C R^T for compact covariances."""
    return mat_to_sym6(R @ sym6_to_mat(c) @ R.transpose(-1, -2))


def _inv3_sym(m: Tensor) -> Tensor:
    """Closed-form inverse of symmetric 3x3 (batched) via the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e = m[..., 1, 1], m[..., 1, 2]
    f = m[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1e-30)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    adj = torch.stack([A, B, C, B, D, E, C, E, F], dim=-1)
    return adj.reshape(m.shape) * inv_det[..., None, None]


def sym3_min_eig(m: Tensor) -> tuple[Tensor, Tensor]:
    """(smallest eigenvalue, p2) of symmetric 3x3 (batched), by the
    trigonometric closed form; p2 = |A - tr(A)/3 I|_F^2, 0 for an isotropic
    matrix. No LAPACK call, so nothing waits on the host."""
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a11, a12, a22 = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=1e-30) / 6.0)
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    # 0/0 where p^3 underflows (a nearly isotropic matrix): any angle will
    # do, take 0
    r = torch.clamp(torch.nan_to_num(detb / (2.0 * p * p * p), nan=0.0),
                    -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    return q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0), p2


def _smallest_eigvec_sym3(m: Tensor) -> Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric 3x3
    (batched): trigonometric eigenvalues + null-space cross products."""
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a11, a12, a22 = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    lam_min, p2 = sym3_min_eig(m)

    r0 = torch.stack([a00 - lam_min, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam_min, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam_min], dim=-1)
    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1, keepdim=True)
    n02 = torch.sum(c02 * c02, dim=-1, keepdim=True)
    n12 = torch.sum(c12 * c12, dim=-1, keepdim=True)
    best = torch.where(n01 > n02, c01, c02)
    bestn = torch.maximum(n01, n02)
    best = torch.where(bestn > n12, best, c12)
    bestn = torch.maximum(bestn, n12)
    ez = torch.zeros_like(best)
    ez.select(-1, 2).fill_(1.0)
    ok = (bestn[..., 0] > 1e-20) & (p2 > 1e-20)
    v = torch.where(ok[..., None], best, ez)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def radius_covariances(xyz: Tensor, valid: Tensor, radius: float = 0.5,
                       chunk: int = 1024):
    """Plane covariances from Gaussian radius-weighted neighbourhoods (the
    default ``cov_engine``): weighted moments as chunked f32 matmuls, the
    normal from the smallest eigenvector, PLANE regularisation, and the
    density proxy 2 sigma^2 / (effective neighbour count).

    Returns (covs (N, 6), density ())."""
    n = xyz.shape[0]
    if n % chunk:
        chunk = n
    w_valid = valid.to(torch.float32)
    cnt = torch.clamp(w_valid.sum(), min=1.0)
    c = torch.sum(xyz * w_valid[:, None], dim=0) / cnt
    xc = (xyz - c) * w_valid[:, None]
    sig2 = (radius * 0.5) ** 2

    xx = torch.sum(xc * xc, dim=-1)
    feats = torch.cat([
        torch.ones((n, 1), dtype=xyz.dtype, device=xyz.device), xc,
        torch.stack([xc[:, 0] * xc[:, 0], xc[:, 0] * xc[:, 1],
                     xc[:, 0] * xc[:, 2], xc[:, 1] * xc[:, 1],
                     xc[:, 1] * xc[:, 2], xc[:, 2] * xc[:, 2]], dim=-1),
        xx[:, None]], dim=-1) * w_valid[:, None]            # (N, 11)

    mom = torch.empty((n, 11), dtype=xyz.dtype, device=xyz.device)
    for q0 in range(0, n, chunk):
        qx, qxx = xc[q0:q0 + chunk], xx[q0:q0 + chunk]
        d2 = qxx[:, None] - 2.0 * (qx @ xc.T) + xx[None, :]
        w = torch.exp(-d2 / (2.0 * sig2)) * w_valid[None, :]
        mom[q0:q0 + chunk] = w @ feats

    s = torch.clamp(mom[:, 0], min=1e-6)
    mu = mom[:, 1:4] / s[:, None]
    S6 = mom[:, 4:10] / s[:, None]
    mumu = torch.stack([mu[:, 0] * mu[:, 0], mu[:, 0] * mu[:, 1],
                        mu[:, 0] * mu[:, 2], mu[:, 1] * mu[:, 1],
                        mu[:, 1] * mu[:, 2], mu[:, 2] * mu[:, 2]], dim=-1)
    cov = sym6_to_mat(S6 - mumu)

    nrm = _smallest_eigvec_sym3(cov)
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    reg = eye - (1.0 - 1e-3) * nrm[..., :, None] * nrm[..., None, :]
    reg = torch.where(valid[:, None, None], reg, eye)

    per_point = 2.0 * sig2 / torch.clamp(mom[:, 0], min=1.0)
    density = torch.sum(per_point * w_valid) / cnt
    return mat_to_sym6(reg), density


def plane_covariances(xyz: Tensor, valid: Tensor, k: int = 16,
                      use_grid: bool = False, cell: float = 1.0):
    """Per-point plane-regularised covariances from the k nearest
    neighbours within the same cloud (self included): the neighbour
    covariance's smallest eigenvector n gives I - (1 - 1e-3) n n^T; the
    density is the mean over valid points of sum(sqd[1:]) /
    ((k-1)(k+2)/2). Neighbours from the brute-force kNN
    (``neighbors.knn``) or, with ``use_grid``, from a ``cell`` grid over
    the cloud (``gridnn.grid_knn``), where a neighbour beyond the 27 cells
    is replaced by the point itself and counts 0 in the density.

    Returns (covs (N, 6), density ())."""
    if use_grid:
        grid = gridnn.build_grid(xyz, valid, cell)
        idx, sqd = gridnn.grid_knn(xyz, grid, k, max_per_cell=MAX_PER_CELL)
        found = torch.isfinite(sqd)
        idx = torch.where(found, idx, 0).long()
        nb = torch.where(found[..., None], xyz[idx], xyz[:, None, :])
        sqd = torch.where(found, sqd, 0.0)
    else:
        idx, sqd = neighbors.knn(xyz, xyz, k)
        nb = xyz[idx]                                      # (N, k, 3)
    d = nb - torch.mean(nb, dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", d, d) / k
    n = _smallest_eigvec_sym3(cov)
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    reg = eye - (1.0 - 1e-3) * n[..., :, None] * n[..., None, :]
    reg = torch.where(valid[:, None, None], reg, eye)
    per_point = torch.sum(sqd[:, 1:], dim=-1) / (((k - 1) * (2 + k)) / 2.0)
    w = valid.to(xyz.dtype)
    density = torch.sum(per_point * w) / torch.clamp(w.sum(), min=1.0)
    return mat_to_sym6(reg), density


# ---------------------------------------------------------------------------
# Correspondences + linearization
# ---------------------------------------------------------------------------

class Correspondences(NamedTuple):
    tgt_idx: Tensor   # (N,) target index
    tgt_rows: Tensor  # (N, 3) the target rows at tgt_idx
    maha: Tensor      # (N, 3, 3) Mahalanobis weight (0 for rejected pairs)
    weight: Tensor    # (N,) 1.0 accepted else 0.0
    count: Tensor     # () accepted pairs


def _transform(xyz: Tensor, T: Tensor) -> Tensor:
    return xyz @ T[:3, :3].T + T[:3, 3]


def update_correspondences(src_xyz: Tensor, src_valid: Tensor,
                           src_cov6: Tensor, tgt_xyz: Tensor,
                           tgt_cov6: Tensor, T: Tensor,
                           max_corr_dist: Tensor,
                           target_count: Tensor | None = None,
                           target_grid: gridnn.Grid | None = None
                           ) -> Correspondences:
    """NN correspondences (capped at the correspondence distance) and
    their Mahalanobis weights at transform T (4x4): kernel A, or the grid
    search when ``target_grid`` (a grid over ``tgt_xyz`` whose cell is at
    least the correspondence distance) is given."""
    transed = _transform(src_xyz, T)
    if target_grid is not None:
        idx, sqd = gridnn.grid_nn1(transed, target_grid,
                                   max_per_cell=MAX_PER_CELL)
        hit = torch.isfinite(sqd)
        idx = torch.where(hit, idx, 0)
        sqd = torch.where(hit, sqd, 1e30)
    else:
        idx, sqd = neighbors.nn1(transed, tgt_xyz, target_count,
                                 max_dist=max_corr_dist)
    idx = idx.long()
    accept = src_valid & (sqd < max_corr_dist * max_corr_dist)
    R = T[:3, :3]
    cov_a = sym6_to_mat(src_cov6)
    cov_b = sym6_to_mat(tgt_cov6[idx])
    rcr = cov_b + R @ cov_a @ R.T
    w = accept.to(src_xyz.dtype)
    maha = _inv3_sym(rcr) * w[:, None, None]
    return Correspondences(idx, tgt_xyz[idx], maha, w, accept.sum())


def linearize(src_xyz: Tensor, corr: Correspondences, T: Tensor):
    """Masked H (6x6), b (6) and error at T: J = [skew(T p) | -I],
    H = Σ J^T M J, b = Σ J^T M e, e = p_tgt - T p_src."""
    transed = _transform(src_xyz, T)
    e = corr.tgt_rows - transed
    eye = torch.eye(3, dtype=src_xyz.dtype, device=src_xyz.device)
    J = torch.cat([skew(transed), -eye.expand(transed.shape + (3,))],
                  dim=-1)                                  # (N, 3, 6)
    MJ = corr.maha @ J
    H = torch.einsum("nij,nik->jk", J, MJ)
    Me = torch.einsum("nij,ni->nj", corr.maha, e)
    b = torch.einsum("nij,ni->j", J, Me)
    err = torch.einsum("ni,ni->", e, Me)
    return H, b, err


def compute_error(src_xyz: Tensor, corr: Correspondences, T: Tensor
                  ) -> Tensor:
    """Σ e^T M e at T with fixed correspondences, summed as the LM search
    sums (``lm_kernel.error_sums``)."""
    return error_sums(src_xyz, corr.tgt_rows, corr.maha, T)


# ---------------------------------------------------------------------------
# Levenberg-Marquardt loop
# ---------------------------------------------------------------------------

class AlignResult(NamedTuple):
    T: Tensor            # (4, 4) final transformation
    H: Tensor            # (6, 6) final Hessian
    error: Tensor        # () final cost
    iterations: Tensor   # () outer iterations executed
    converged: Tensor    # () bool
    num_corr: Tensor     # () correspondences at the last linearization


def gicp_align(src_xyz: Tensor, src_valid: Tensor, src_cov6: Tensor,
               tgt_xyz: Tensor, tgt_cov6: Tensor, cfg: GicpConfig,
               max_corr_dist=None, guess: Tensor | None = None,
               target_count: Tensor | None = None,
               syncs: HostSyncs | None = None,
               target_grid: gridnn.Grid | None = None) -> AlignResult:
    """Full GICP alignment: LM over SE(3) with a correspondence refresh per
    outer iteration (NanoGICP computeTransformation + step_lm);
    correspondences from ``target_grid`` when given
    (``update_correspondences``). Each outer iteration's parts are the
    spans ``odometry.gicp.correspond``, ``.linearize`` and ``.lm``."""
    dev, dtype = src_xyz.device, src_xyz.dtype
    syncs = HostSyncs() if syncs is None else syncs
    x = (torch.eye(4, dtype=dtype, device=dev) if guess is None
         else guess.to(dtype))
    mcd = torch.as_tensor(cfg.max_corr_dist if max_corr_dist is None
                          else max_corr_dist, dtype=dtype, device=dev)
    lam = torch.full((), -1.0, dtype=dtype, device=dev)
    H = torch.eye(6, dtype=dtype, device=dev)
    err = torch.zeros((), dtype=dtype, device=dev)
    ncorr = torch.zeros((), dtype=torch.int64, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    iters = 0
    while iters < cfg.max_iterations:
        with span("odometry.gicp.correspond"):
            corr = update_correspondences(src_xyz, src_valid, src_cov6,
                                          tgt_xyz, tgt_cov6, x, mcd,
                                          target_count, target_grid)
        with span("odometry.gicp.linearize"):
            H, b, y0 = linearize(src_xyz, corr, x)
        with span("odometry.gicp.lm"):
            lm = lm_search(cfg, src_xyz, corr.tgt_rows, corr.maha, H, b, y0,
                           x, lam)
        x, lam, err, converged = lm.x, lm.lam, lm.y, lm.converged
        ncorr = corr.count
        iters += 1
        if syncs.read(lm.stop):
            break
    return AlignResult(x, H, err,
                       torch.full((), iters, dtype=torch.int64, device=dev),
                       converged, ncorr)
