"""Keyframe pose graph with loop closure (port of
``noetic_slam_tpu.models.posegraph``).

Same design as the JAX module: fixed-capacity node and edge arrays,
Gauss-Newton over SO(3) x R^3 with left-multiplicative perturbations, the
gauge fixed by a strong prior on node 0, a dense (6K, 6K) normal system
solved by LU or a matrix-free block-Jacobi preconditioned CG, loop
candidates by keyframe proximity, GICP verification, and the rigid map
deformation of ``apply_pose_update``.

Porting notes:
- every function returns a new graph, as the JAX ones do (nothing is
  updated in place); ``mode="drop"`` scatters write through one spare row
  that is cut off afterwards;
- ``jnp.linalg.solve`` is ``torch.linalg.solve_ex`` and ``jnp.linalg.inv``
  ``inv_ex``: ``solve``/``inv`` check LAPACK's ``info`` on the host, a
  hidden device sync. ``fori_loop``s are Python loops of a fixed count,
  with no host read;
- ``verify_loop``'s ``eigvalsh`` of a 3x3 is the closed form of
  ``ops.gicp.sym3_min_eig`` (``eigvalsh`` on CUDA goes through cuSOLVER and
  waits on the host). Its GICP is the port's ``gicp_align``, so the
  correspondence search is kernel A on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from noetic_slam_tpu_torch import resolve_device
from noetic_slam_tpu_torch.config import GicpConfig
from noetic_slam_tpu_torch.ops import gicp as gicp_ops
from noetic_slam_tpu_torch.ops.gicp import HostSyncs
from noetic_slam_tpu_torch.utils.geometry import (
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    skew,
    so3_exp_quat,
    so3_log_quat,
)
from noetic_slam_tpu_torch.utils.host import to_device

Tensor = torch.Tensor


class PoseGraph(NamedTuple):
    node_q: Tensor       # (K, 4)
    node_p: Tensor       # (K, 3)
    n_nodes: Tensor      # () int32
    edge_i: Tensor       # (E,) int32
    edge_j: Tensor       # (E,) int32
    edge_dq: Tensor      # (E, 4) measured q_i^-1 * q_j
    edge_dp: Tensor      # (E, 3) measured R_i^T (p_j - p_i)
    edge_w_rot: Tensor   # (E,)
    edge_w_trans: Tensor # (E,)
    edge_valid: Tensor   # (E,) bool
    n_edges: Tensor      # () int32


def _ident(n: int, device) -> Tensor:
    q = torch.zeros((n, 4), dtype=torch.float32, device=device)
    q[:, 0] = 1.0
    return q


def init_graph(max_nodes: int, max_edges: int, device=None) -> PoseGraph:
    """An empty graph on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return PoseGraph(
        node_q=_ident(max_nodes, device),
        node_p=torch.zeros((max_nodes, 3), **f32),
        n_nodes=torch.zeros((), **i32),
        edge_i=torch.zeros((max_edges,), **i32),
        edge_j=torch.zeros((max_edges,), **i32),
        edge_dq=_ident(max_edges, device),
        edge_dp=torch.zeros((max_edges, 3), **f32),
        edge_w_rot=torch.zeros((max_edges,), **f32),
        edge_w_trans=torch.zeros((max_edges,), **f32),
        edge_valid=torch.zeros((max_edges,), dtype=torch.bool, device=device),
        n_edges=torch.zeros((), **i32),
    )


def _set_row(buf: Tensor, idx: Tensor, value, ok: Tensor) -> Tensor:
    """A copy of ``buf`` with row ``idx`` (0-dim) set to ``value`` where
    ``ok``, else unchanged."""
    out = buf.clone()
    i = idx.reshape(1).long()
    old = out.index_select(0, i)[0]
    new = torch.as_tensor(value, dtype=buf.dtype, device=buf.device)
    out.index_copy_(0, i, torch.where(ok, new, old).unsqueeze(0))
    return out


def add_node(g: PoseGraph, q: Tensor, p: Tensor) -> PoseGraph:
    K = g.node_q.shape[0]
    i = torch.clamp(g.n_nodes, max=K - 1)
    ok = g.n_nodes < K
    return g._replace(
        node_q=_set_row(g.node_q, i, q, ok),
        node_p=_set_row(g.node_p, i, p, ok),
        n_nodes=(g.n_nodes + ok.to(torch.int32)).to(torch.int32))


def add_edge(g: PoseGraph, i, j, dq: Tensor, dp: Tensor, w_rot=1.0,
             w_trans=1.0, enabled=True) -> PoseGraph:
    E = g.edge_i.shape[0]
    e = torch.clamp(g.n_edges, max=E - 1)
    ok = torch.as_tensor(enabled, device=g.n_edges.device) & (g.n_edges < E)
    return g._replace(
        edge_i=_set_row(g.edge_i, e, i, ok),
        edge_j=_set_row(g.edge_j, e, j, ok),
        edge_dq=_set_row(g.edge_dq, e, dq, ok),
        edge_dp=_set_row(g.edge_dp, e, dp, ok),
        edge_w_rot=_set_row(g.edge_w_rot, e, w_rot, ok),
        edge_w_trans=_set_row(g.edge_w_trans, e, w_trans, ok),
        edge_valid=_set_row(g.edge_valid, e, True, ok),
        n_edges=(g.n_edges + ok.to(torch.int32)).to(torch.int32))


def grow(g: PoseGraph, max_nodes: int | None = None,
         max_edges: int | None = None) -> PoseGraph:
    """A graph with enlarged node/edge capacity, contents preserved
    (``add_node``/``add_edge`` saturate, so callers that must never lose
    a node grow ahead of saturation)."""
    K, E = g.node_q.shape[0], g.edge_i.shape[0]
    nK = max(max_nodes or K, K)
    nE = max(max_edges or E, E)
    if nK == K and nE == E:
        return g

    def pad(a, n, fill=0):
        if n == a.shape[0]:
            return a
        return torch.cat([a, a.new_full((n - a.shape[0],) + a.shape[1:],
                                        fill)])

    dev = g.node_q.device
    node_q = g.node_q if nK == K else torch.cat([g.node_q,
                                                 _ident(nK - K, dev)])
    edge_dq = g.edge_dq if nE == E else torch.cat([g.edge_dq,
                                                   _ident(nE - E, dev)])
    return PoseGraph(
        node_q=node_q, node_p=pad(g.node_p, nK), n_nodes=g.n_nodes,
        edge_i=pad(g.edge_i, nE), edge_j=pad(g.edge_j, nE),
        edge_dq=edge_dq, edge_dp=pad(g.edge_dp, nE),
        edge_w_rot=pad(g.edge_w_rot, nE),
        edge_w_trans=pad(g.edge_w_trans, nE),
        edge_valid=pad(g.edge_valid, nE, False), n_edges=g.n_edges)


def relative_pose(qi, pi, qj, pj):
    """Measured relative transform (dq, dp) of j in i's frame."""
    dq = quat_normalize(quat_mul(quat_conj(qi), qj))
    dp = quat_rotate(quat_conj(qi), pj - pi)
    return dq, dp


def _scatter_rows(buf: Tensor, idx: Tensor, rows: Tensor) -> Tensor:
    """A copy of ``buf`` with ``rows`` written at ``idx``; an index at or
    beyond ``len(buf)`` drops its row (JAX's ``mode="drop"``)."""
    n = buf.shape[0]
    out = torch.cat([buf, buf[:1]])
    out.index_copy_(0, torch.clamp(idx.long(), max=n), rows.to(buf.dtype))
    return out[:n]


def _add_chain(g: PoseGraph, qs: Tensor, ps: Tensor, count: int,
               prev_q: Tensor, prev_p: Tensor, have_prev: bool
               ) -> PoseGraph:
    """Body of add_nodes_chain (``qs``/``ps`` padded to m rows)."""
    K = g.node_q.shape[0]
    E = g.edge_i.shape[0]
    m = qs.shape[0]
    dev = qs.device
    ks = torch.arange(m, device=dev)
    valid = ks < count
    start = g.n_nodes.long()
    nidx = torch.where(valid, start + ks, K)
    node_q = _scatter_rows(g.node_q, nidx, qs)
    node_p = _scatter_rows(g.node_p, nidx, ps)
    # chain edges: node (start+k-1) -> (start+k); the first links to the
    # previous tail when there is one
    src_q = torch.cat([prev_q[None], qs[:-1]])
    src_p = torch.cat([prev_p[None], ps[:-1]])
    dq, dp = relative_pose(src_q, src_p, qs, ps)
    # an edge is valid only if both its endpoints exist (a node dropped at
    # capacity must not leave a phantom edge)
    evalid = valid if have_prev else (valid & (ks > 0))
    evalid = evalid & (start + ks < K)
    k0 = 0 if have_prev else 1
    eidx = torch.where(evalid, g.n_edges.long() + ks - k0, E)
    ones = torch.ones((m,), dtype=torch.float32, device=dev)
    return g._replace(
        node_q=node_q, node_p=node_p,
        n_nodes=torch.clamp(start + count, max=K).to(torch.int32),
        edge_i=_scatter_rows(g.edge_i, eidx, start + ks - 1),
        edge_j=_scatter_rows(g.edge_j, eidx, start + ks),
        edge_dq=_scatter_rows(g.edge_dq, eidx, dq),
        edge_dp=_scatter_rows(g.edge_dp, eidx, dp),
        edge_w_rot=_scatter_rows(g.edge_w_rot, eidx, ones),
        edge_w_trans=_scatter_rows(g.edge_w_trans, eidx, ones),
        edge_valid=_scatter_rows(g.edge_valid, eidx, evalid),
        n_edges=torch.clamp(g.n_edges + evalid.sum(), max=E
                            ).to(torch.int32))


def add_nodes_chain(g: PoseGraph, qs, ps, count: int, prev_q=None,
                    prev_p=None) -> PoseGraph:
    """Append ``count`` nodes and their odometry-chain edges. ``qs (count,
    4)``/``ps (count, 3)`` are host arrays, padded to a power-of-two row
    count as in JAX; ``prev_q/prev_p`` (pose of node ``n_nodes - 1``) chain
    the first new node to the tail, None on the first keyframe ever.
    Saturates at capacity (callers grow ahead of it)."""
    count = int(count)
    if count == 0:
        return g
    m = max(1, 1 << (count - 1).bit_length())
    qs_p = np.zeros((m, 4), np.float32)
    qs_p[:, 0] = 1.0
    ps_p = np.zeros((m, 3), np.float32)
    qs_p[:count] = np.asarray(qs, np.float32)[:count]
    ps_p[:count] = np.asarray(ps, np.float32)[:count]
    have_prev = prev_q is not None
    pq = (np.asarray(prev_q, np.float32) if have_prev
          else np.array([1.0, 0, 0, 0], np.float32))
    pp = (np.asarray(prev_p, np.float32) if have_prev
          else np.zeros(3, np.float32))
    dev = g.node_q.device
    return _add_chain(g, to_device(qs_p, dev), to_device(ps_p, dev), count,
                      to_device(pq, dev), to_device(pp, dev), have_prev)


def _edge_terms(g: PoseGraph):
    """Per-edge residuals + first-order Jacobian blocks:
    r_R = Log(dq_meas^-1 q_i^-1 q_j), r_t = R_i^T (p_j - p_i) - dp_meas;
    dr/d(w_j, v_j) = R_i^T, dr/d(w_i, v_i) = -R_i^T,
    dr_t/dw_i = R_i^T skew(p_j - p_i)."""
    ei, ej = g.edge_i.long(), g.edge_j.long()
    qi, pi = g.node_q[ei], g.node_p[ei]
    qj, pj = g.node_q[ej], g.node_p[ej]
    q_rel = quat_mul(quat_conj(qi), qj)
    r_R = so3_log_quat(quat_mul(quat_conj(g.edge_dq), q_rel))
    r_t = quat_rotate(quat_conj(qi), pj - pi) - g.edge_dp
    Ri_T = quat_to_mat(qi).transpose(-1, -2)               # (E, 3, 3)
    J_t_wi = Ri_T @ skew(pj - pi)                          # (E, 3, 3)
    return r_R, r_t, Ri_T, J_t_wi


def _edge_jacobian_blocks(g: PoseGraph):
    """Per-edge stacked Jacobian (E, 6res, 12vars) with vars [w_i v_i w_j
    v_j], weights (E, 6) and residuals (E, 6)."""
    r_R, r_t, A, J_t_wi = _edge_terms(g)
    z = torch.zeros_like(A)
    Jr = torch.cat([torch.cat([-A, z, A, z], dim=-1),
                    torch.cat([J_t_wi, -A, z, A], dim=-1)], dim=-2)
    E = g.edge_i.shape[0]
    wvec = torch.cat([
        (g.edge_w_rot * g.edge_valid)[:, None].expand(E, 3),
        (g.edge_w_trans * g.edge_valid)[:, None].expand(E, 3)], dim=-1)
    return Jr, wvec, torch.cat([r_R, r_t], dim=-1)


def _edge_normal_blocks(g: PoseGraph):
    """(edge_i, edge_j, Hblk (E, 12, 12), bblk (E, 12)): each edge's
    J^T W J and J^T W r."""
    Jr, wvec, r = _edge_jacobian_blocks(g)
    JW = Jr * wvec[:, :, None]
    Hblk = torch.einsum("eri,erj->eij", JW, Jr)
    bblk = torch.einsum("eri,er->ei", JW, r)
    return g.edge_i.long(), g.edge_j.long(), Hblk, bblk


def _assemble(g: PoseGraph, K: int):
    """Dense H (6K, 6K), b (6K,) from all valid edges by scatter-adds."""
    ei, ej, Hblk, bblk = _edge_normal_blocks(g)
    E = ei.shape[0]
    base = torch.stack([ei * 6, ei * 6 + 3, ej * 6, ej * 6 + 3], dim=-1)
    rows = (base[:, :, None] + torch.arange(3, device=ei.device)
            ).reshape(E, 12)
    flat = (rows[:, :, None] * (6 * K) + rows[:, None, :]).reshape(-1)
    H = torch.zeros((6 * K) ** 2, dtype=torch.float32, device=ei.device)
    H.index_add_(0, flat, Hblk.reshape(-1))
    b = torch.zeros(6 * K, dtype=torch.float32, device=ei.device)
    b.index_add_(0, rows.reshape(-1), bblk.reshape(-1))
    return H.reshape(6 * K, 6 * K), b


def _gn_system_matfree(g: PoseGraph, K: int, damping: float):
    """Matrix-free normal system for CG: (matvec, b, apply_prec), where
    matvec(x) = (H + diag) x is computed edge-wise (gather the two 6-blocks
    of x per edge, apply the edge's 12x12 block, scatter-add back) and the
    preconditioner is the per-node 6x6 block Jacobi from the same pass."""
    ei, ej, Hblk, bblk = _edge_normal_blocks(g)
    dev = Hblk.device
    active = torch.arange(K, device=dev) < g.n_nodes
    diag_all = torch.where(active, damping, 1.0)
    diag_all[0] += 1e6                                     # gauge prior

    b = torch.zeros((K, 6), dtype=torch.float32, device=dev)
    b.index_add_(0, ei, bblk[:, :6])
    b.index_add_(0, ej, bblk[:, 6:])

    def matvec(x):
        ye = torch.einsum("eij,ej->ei", Hblk, torch.cat([x[ei], x[ej]],
                                                        dim=-1))
        y = torch.zeros_like(x)
        y.index_add_(0, ei, ye[:, :6])
        y.index_add_(0, ej, ye[:, 6:])
        return y + diag_all[:, None] * x

    Pblk = torch.zeros((K, 6, 6), dtype=torch.float32, device=dev)
    Pblk.index_add_(0, ei, Hblk[:, :6, :6])
    Pblk.index_add_(0, ej, Hblk[:, 6:, 6:])
    Pblk = Pblk + diag_all[:, None, None] * torch.eye(6, device=dev)
    Pinv = torch.linalg.inv_ex(Pblk)[0]

    def apply_prec(x):
        return torch.einsum("kij,kj->ki", Pinv, x)

    return matvec, b, apply_prec


def _pcg(matvec, b: Tensor, apply_prec, iters: int, tol: float = 1e-8
         ) -> Tensor:
    """Preconditioned conjugate gradient on the (K, 6) layout, a fixed
    number of iterations; the RHS is normalised first so that the
    breakdown guards are scale-invariant."""
    bn = torch.sqrt(torch.sum(b * b))
    scale = torch.where(bn > 0, bn, 1.0)
    b = b / scale
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = apply_prec(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(torch.abs(denom) > tol, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_prec(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > tol, rz_new / torch.clamp(rz, min=tol), 0.0)
        p = z + beta * p
        rz = rz_new
    return x * scale


def optimize(g: PoseGraph, iters: int = 10, k_static: int | None = None,
             damping: float = 1e-6, method: str = "auto",
             cg_iters: int = 100) -> PoseGraph:
    """Gauss-Newton over all node poses; node 0 gauge-fixed by a prior.

    ``method``: "dense" builds H (6K, 6K) and LU-solves it; "cg" solves each
    step by matrix-free block-Jacobi PCG (``cg_iters`` iterations); "auto"
    takes CG above 192 nodes. ``k_static``: solve over the first k_static
    node slots only (>= n_nodes; every edge must reference nodes below
    it)."""
    K = g.node_q.shape[0] if k_static is None else k_static
    if method == "auto":
        method = "cg" if K > 192 else "dense"
    dev = g.node_q.device
    ok = (torch.arange(K, device=dev) < g.n_nodes)[:, None]
    for _ in range(iters):
        if method == "dense":
            H, b = _assemble(g, K)
            active = (torch.arange(6 * K, device=dev) // 6) < g.n_nodes
            diag = torch.where(active, damping, 1.0)
            diag[:6] = 1e6
            dx = torch.linalg.solve_ex(H + torch.diag(diag),
                                       -b)[0].reshape(K, 6)
        else:
            matvec, b, apply_prec = _gn_system_matfree(g, K, damping)
            dx = _pcg(matvec, -b, apply_prec, cg_iters)
        dw = torch.where(ok, dx[:, :3], 0.0)
        dv = torch.where(ok, dx[:, 3:], 0.0)
        q_head = quat_normalize(quat_mul(so3_exp_quat(dw), g.node_q[:K]))
        p_head = g.node_p[:K] + dv
        if K == g.node_q.shape[0]:
            g = g._replace(node_q=q_head, node_p=p_head)
        else:
            g = g._replace(node_q=torch.cat([q_head, g.node_q[K:]]),
                           node_p=torch.cat([p_head, g.node_p[K:]]))
    return g


def graph_cost(g: PoseGraph) -> Tensor:
    r_R, r_t, _, _ = _edge_terms(g)
    return torch.sum((g.edge_w_rot * torch.sum(r_R ** 2, -1)
                      + g.edge_w_trans * torch.sum(r_t ** 2, -1))
                     * g.edge_valid)


# ---------------------------------------------------------------------------
# Loop closure
# ---------------------------------------------------------------------------

def detect_loop_candidate(kf_pos: Tensor, kf_count: Tensor, cur_idx,
                          radius: float, min_gap: int,
                          kf_seq: Tensor | None = None):
    """Nearest keyframe at least ``min_gap`` insertions older than slot
    ``cur_idx`` and within ``radius`` (age by ``kf_seq`` when given, else
    slot order). Returns (slot, ok) as device tensors."""
    K = kf_pos.shape[0]
    slots = torch.arange(K, device=kf_pos.device)
    cur = torch.as_tensor(cur_idx, device=kf_pos.device).reshape(1).long()
    d = torch.linalg.vector_norm(kf_pos - kf_pos.index_select(0, cur),
                                 dim=-1)
    if kf_seq is None:
        eligible = (slots < kf_count) & (slots <= cur[0] - min_gap)
    else:
        eligible = ((slots < kf_count) & (kf_seq > 0)
                    & (kf_seq <= kf_seq.index_select(0, cur)[0] - min_gap))
    d = torch.where(eligible, d, torch.inf)
    best = torch.argmin(d)
    return best, d.index_select(0, best.reshape(1))[0] < radius


def detect_loop_candidate_np(kf_pos, kf_seq, kf_count, cur_idx: int,
                             radius: float, min_gap: int):
    """Host-numpy form of ``detect_loop_candidate`` (kf_seq branch), for
    callers that already hold the keyframe metadata on the host."""
    K = kf_pos.shape[0]
    slots = np.arange(K)
    d = np.linalg.norm(kf_pos - kf_pos[cur_idx][None, :], axis=-1)
    eligible = ((slots < kf_count) & (kf_seq > 0)
                & (kf_seq <= kf_seq[cur_idx] - min_gap))
    d = np.where(eligible, d, np.inf)
    best = int(np.argmin(d))
    return best, bool(d[best] < radius)


def verify_loop(src_xyz, src_valid, src_cov, tgt_xyz, tgt_cov,
                cfg: GicpConfig, max_corr_dist: float = 1.5,
                max_error: float = 1.5, min_trans_eig: float = 5.0,
                guess=None, syncs: HostSyncs | None = None):
    """GICP-verify a candidate: align the two keyframe clouds (both in the
    world frame) and accept iff the alignment converged, fits (mean
    Mahalanobis residual per correspondence below ``max_error``) and is
    observable (the smallest eigenvalue of the translation block of the
    final normal matrix, per correspondence, at least ``min_trans_eig``).
    Thresholds and their calibration: the JAX function's docstring.
    ``guess``: optional (4, 4) initial transform. Returns (T_corr,
    accepted) as device tensors; GICP's outer-loop reads are counted in
    ``syncs``."""
    if guess is not None:
        guess = torch.as_tensor(guess, dtype=torch.float32,
                                device=src_xyz.device)
    res = gicp_ops.gicp_align(src_xyz, src_valid, src_cov, tgt_xyz, tgt_cov,
                              cfg, max_corr_dist=max_corr_dist, guess=guess,
                              syncs=syncs)
    ncorr = torch.clamp(res.num_corr.to(torch.float32), min=1.0)
    mean_err = res.error / ncorr
    trans_eig = gicp_ops.sym3_min_eig(res.H[3:, 3:] / ncorr)[0]
    ok = (res.converged & (res.num_corr > 3 * cfg.min_num_points)
          & (mean_err < max_error) & (trans_eig >= min_trans_eig))
    return res.T, ok


def apply_pose_update(kf_quat, kf_pos, kf_xyz, kf_valid, kf_cov, new_q,
                      new_p, kf_count):
    """Map deformation: move each resident keyframe cloud rigidly from its
    old pose to its optimised one (T_new T_old^-1 per keyframe), in full
    f32. Returns (q, p, xyz, cov), new tensors."""
    K = kf_quat.shape[0]
    ok = torch.arange(K, device=kf_quat.device) < kf_count
    dq = quat_normalize(quat_mul(new_q, quat_conj(kf_quat)))
    R = quat_to_mat(dq)                                    # (K, 3, 3)
    t = new_p - torch.einsum("kij,kj->ki", R, kf_pos)
    xyz = torch.einsum("kij,knj->kni", R, kf_xyz) + t[:, None, :]
    keep = (ok[:, None] & kf_valid)[..., None]
    xyz = torch.where(keep, xyz, kf_xyz)
    cov = torch.where(keep, gicp_ops.rotate_sym6(kf_cov, R[:, None]), kf_cov)
    return (torch.where(ok[:, None], new_q, kf_quat),
            torch.where(ok[:, None], new_p, kf_pos), xyz, cov)
