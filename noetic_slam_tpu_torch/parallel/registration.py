"""GICP registration with the target sharded over ranks (port of
``noetic_slam_tpu.parallel.registration``).

The scan-to-map NN search and the normal-equation reduction are split
across the ranks of a ``parallel.mesh.Mesh`` axis:

- the target (submap points and covariances) arrives as this rank's shard
  along the axis; the query set is replicated;
- each rank searches every query against its shard with kernel A
  (``neighbors.nn1``, uncapped, no target count: sentinel rows are far);
- the global nearest neighbour is picked by the (min, argmin, payload)
  reduction of the JAX module: ``all_reduce MIN`` of the candidate
  distance, ``all_reduce MIN`` of the winning rank (the lowest rank among
  equal distances), then ``all_reduce SUM`` of the winner-masked payload
  (point and covariance, one (N, 9) tensor): exactly one rank
  contributes per query, so every collective is an all-reduce of a size
  flat in the rank count;
- each rank linearises its 1/D slice of the queries, and H, b, the error
  and the correspondence count are summed in one ``all_reduce``.

The LM lambda search is ``ops.cuda.lm_kernel.lm_search`` (kernel D on
the card), on the full query set's gathered payload rows. Every value a
branch reads on the host comes out of an all-reduce or from replicated
inputs, so every rank takes the same branch and leaves the outer loop at
the same iteration.
"""

from __future__ import annotations

import torch

from noetic_slam_tpu_torch.config import GicpConfig
from noetic_slam_tpu_torch.ops import neighbors
from noetic_slam_tpu_torch.ops.cuda.lm_kernel import lm_search
from noetic_slam_tpu_torch.ops.gicp import (
    AlignResult,
    Correspondences,
    HostSyncs,
    _inv3_sym,
    _transform,
    linearize,
    sym6_to_mat,
)
from noetic_slam_tpu_torch.runtime.profiling import span

Tensor = torch.Tensor


def _weights(valid: Tensor, src_cov6: Tensor, tgt_rows: Tensor,
             tgt_cov6: Tensor, d: Tensor, T: Tensor, mcd: Tensor
             ) -> Correspondences:
    """Mahalanobis weights of fixed pairs (query i with payload row i:
    ``tgt_rows[i]``, ``tgt_cov6[i]``)."""
    accept = valid & (d < mcd * mcd)
    R = T[:3, :3]
    rcr = sym6_to_mat(tgt_cov6) + R @ sym6_to_mat(src_cov6) @ R.T
    w = accept.to(src_cov6.dtype)
    idx = torch.arange(valid.shape[0], device=valid.device)
    return Correspondences(idx, tgt_rows, _inv3_sym(rcr) * w[:, None, None],
                           w, accept.sum())


def sharded_gicp_align(mesh, src_xyz: Tensor, src_valid: Tensor,
                       src_cov6: Tensor, tgt_xyz: Tensor, tgt_cov6: Tensor,
                       cfg: GicpConfig, max_corr_dist=None,
                       axis: str = "map",
                       syncs: HostSyncs | None = None) -> AlignResult:
    """GICP alignment with ``tgt_*`` this rank's shard along ``axis`` of
    ``mesh`` and ``src_*`` replicated (the query count must divide the
    axis). Every rank returns the same result. Host reads of the outer
    loop are counted in ``syncs``."""
    ndev, my = mesh.size(axis), mesh.index(axis)
    nq = src_xyz.shape[0]
    if nq % ndev:
        raise ValueError(f"{nq} queries do not divide {ndev} ranks")
    cq = nq // ndev
    sl = slice(my * cq, (my + 1) * cq)
    dev, dtype = src_xyz.device, src_xyz.dtype
    syncs = HostSyncs() if syncs is None else syncs
    mcd = torch.as_tensor(cfg.max_corr_dist if max_corr_dist is None
                          else max_corr_dist, dtype=dtype, device=dev)

    def global_winner(T):
        """(d_min (Nq,), payload (Nq, 9): point and covariance of the
        winning rank's candidate), the same on every rank."""
        idx, d = neighbors.nn1(_transform(src_xyz, T), tgt_xyz)
        idx = idx.long()
        d_min = mesh.all_reduce(d, "min", axis)
        win = torch.where(d <= d_min, my, ndev).to(torch.int32)
        mine = mesh.all_reduce(win, "min", axis) == my
        payload = torch.cat([tgt_xyz[idx], tgt_cov6[idx]], dim=1)
        payload = mesh.all_reduce(torch.where(mine[:, None], payload, 0.0),
                                  "sum", axis)
        return d_min, payload

    def relinearize(T):
        with span("odometry.gicp.correspond"):
            d, payload = global_winner(T)
        with span("odometry.gicp.linearize"):
            pt, cv = payload[:, :3], payload[:, 3:]
            # this rank's query slice, its terms summed over the ranks
            corr = _weights(src_valid[sl], src_cov6[sl], pt[sl], cv[sl],
                            d[sl], T, mcd)
            H, b, err = linearize(src_xyz[sl], corr, T)
            red = mesh.all_reduce(torch.cat([
                H.reshape(-1), b, err[None], corr.count.to(dtype)[None]]),
                "sum", axis)
            # the full query set's weights (replicated), for the
            # fixed-pair errors of the LM lambda search
            full = _weights(src_valid, src_cov6, pt, cv, d, T, mcd)
        return (full, red[:36].reshape(6, 6), red[36:42], red[42],
                red[43].to(torch.int64))

    x = torch.eye(4, dtype=dtype, device=dev)
    lam = torch.full((), -1.0, dtype=dtype, device=dev)
    H = torch.eye(6, dtype=dtype, device=dev)
    err = torch.zeros((), dtype=dtype, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    iters = 0
    while iters < cfg.max_iterations:
        full, H, b, y0, n = relinearize(x)
        with span("odometry.gicp.lm"):
            lm = lm_search(cfg, src_xyz, full.tgt_rows, full.maha, H, b, y0,
                           x, lam)
        x, lam, err, converged = lm.x, lm.lam, lm.y, lm.converged
        iters += 1
        if syncs.read(lm.stop):
            break
    return AlignResult(x, H, err,
                       torch.full((), iters, dtype=torch.int64, device=dev),
                       converged, n)


def make_sharded_align(mesh, axis: str = "map"):
    """An ``align_fn`` for ``models.odometry.make_odometry_step`` (and
    ``OdometryPipeline``): the step's replicated submap is cut to this
    rank's shard and registered with ``sharded_gicp_align``. The grid
    index and the target count are not used (the JAX package's sharded
    step ignores them too): kernel A searches the whole shard."""
    def align(src_xyz, src_valid, src_cov, tgt_xyz, tgt_cov, cfg,
              max_corr_dist=None, target_grid=None, target_count=None,
              syncs=None):
        return sharded_gicp_align(
            mesh, src_xyz, src_valid, src_cov, mesh.shard(tgt_xyz, axis),
            mesh.shard(tgt_cov, axis), cfg, max_corr_dist=max_corr_dist,
            axis=axis, syncs=syncs)
    return align


def collective_traffic_per_align(cfg: GicpConfig, nq: int, ndev: int,
                                 outer_iters: int | None = None) -> dict:
    """Analytical per-rank collective traffic of one sharded_gicp_align
    (a copy of the JAX function; tests/test_torch_copies.py holds it to
    the original).

    Per relinearize (outer iteration) each rank all-reduces:
    - the candidate distance (MIN, nq * 4 B) and the winning rank (MIN,
      nq * 4 B);
    - the winner-masked payload (SUM: point 12 B + covariance 24 B per
      query);
    - the reduced normal equations (SUM: H 36 + b 6 + err 1 + n 1 values,
      176 B).

    A ring all-reduce of M bytes moves 2 * (ndev-1)/ndev * M < 2*M bytes
    through each rank, so the traffic of an align is flat in the rank
    count. ``per_relinearize_reduce_elements`` is what the ranks hand to
    ``all_reduce`` per relinearize (``Mesh.reduce_bytes`` counts it:
    tests/test_torch_parallel.py).
    """
    it = cfg.max_iterations if outer_iters is None else outer_iters
    per_query_reduce_bytes = 4 + 4 + 12 + 24          # d, win id, pt, cov
    ring = 2.0 * (ndev - 1) / max(ndev, 1)
    reduce_recv = int(ring * nq * per_query_reduce_bytes)
    psum_bytes = int(ring * (36 + 6 + 1 + 1) * 4)
    return {
        "per_relinearize_reduce_elements": nq * (1 + 1 + 3 + 6) + 44,
        "per_relinearize_reduce_recv_bytes": reduce_recv,
        "per_relinearize_psum_bytes": psum_bytes,
        "max_outer_iters": it,
        "per_align_recv_bytes_max": it * (reduce_recv + psum_bytes),
        "flat_in_devices": True,
    }
