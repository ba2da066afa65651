"""Distribution over ranks (port of ``noetic_slam_tpu.parallel``).

- ``mesh``: rank meshes over ``torch.distributed`` (one process per rank;
  ``make_mesh``, ``make_mesh_2d``) and ``launch``, which spawns the ranks;
- ``registration``: GICP with the submap sharded over the ranks
  (``sharded_gicp_align``; ``make_sharded_align`` plugs it into the
  odometry step), kernel A on every rank's shard;
- ``bundle_adjustment``: the pose-graph solve with the edges sharded;
- ``tsdf``: TSDF fusion with the blocks sharded by key, kernel B on every
  rank;
- ``batch``: the multi-sequence odometry step of ``runtime.multi``.
"""

from noetic_slam_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from noetic_slam_tpu_torch.parallel.registration import (  # noqa: F401
    sharded_gicp_align,
)
