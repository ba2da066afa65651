"""Data parallelism over sequences (port of ``noetic_slam_tpu.parallel``).

Only ``batch`` is ported so far: the multi-sequence odometry step of
``runtime.multi``. The sharded GICP, pose-graph and TSDF modules
(``mesh``, ``registration``, ``bundle_adjustment``, ``tsdf``) wait for
``torch.distributed`` (ROADMAP Queue 1 item 8).
"""
