"""Pose-graph (bundle-adjustment) solve with the edges sharded over ranks
(port of ``noetic_slam_tpu.parallel.bundle_adjustment``).

Edges (factors) are sharded along an axis of a ``parallel.mesh.Mesh``;
nodes are replicated. Each rank assembles the normal-equation terms of
its edge shard only, ``all_reduce SUM`` combines them, and every rank
computes the same node update. Two solver paths, as in
``models.posegraph.optimize``:

- ``dense``: the summed H (6K x 6K) and b, LU-solved on every rank; right
  up to a few hundred nodes (O(K^2) collective payload);
- ``cg``: matrix-free block-Jacobi PCG whose matvec applies this rank's
  per-edge 12x12 blocks and sums the (K, 6) node accumulator over the
  ranks (``_gn_system_matfree`` with ``reduce``): O(E/D) work per rank
  and O(K) payload per CG iteration, nothing of size (6K)^2. The
  kilometre-scale graphs (> 2,000 nodes) are solvable on this path only.

``auto`` takes CG above 192 nodes, as the one-device solver does. No
branch reads the host.
"""

from __future__ import annotations

from noetic_slam_tpu_torch.models.posegraph import PoseGraph, optimize

EDGE_FIELDS = ("edge_i", "edge_j", "edge_dq", "edge_dp", "edge_w_rot",
               "edge_w_trans", "edge_valid")


def sharded_optimize(mesh, g: PoseGraph, iters: int = 10,
                     damping: float = 1e-6, axis: str = "map",
                     method: str = "auto", cg_iters: int = 100) -> PoseGraph:
    """Gauss-Newton identical to ``models.posegraph.optimize``, with the
    edge assembly sharded over ``axis`` and summed over its ranks. ``g``
    is replicated (every rank passes the same graph); the edge capacity
    must divide the axis. Every rank returns the same graph."""
    E = g.edge_i.shape[0]
    if E % mesh.size(axis):
        raise ValueError(f"edge capacity {E} does not divide the {axis!r} "
                         f"axis ({mesh.size(axis)} ranks)")
    local = g._replace(**{f: mesh.shard(getattr(g, f), axis)
                          for f in EDGE_FIELDS})
    out = optimize(local, iters=iters, damping=damping, method=method,
                   cg_iters=cg_iters,
                   reduce=lambda x: mesh.all_reduce(x, "sum", axis))
    return g._replace(node_q=out.node_q, node_p=out.node_p)
