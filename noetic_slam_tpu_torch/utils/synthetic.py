"""The synthetic LiDAR+IMU world simulator, shared with the JAX package
(``noetic_slam_tpu.utils.synthetic`` is numpy only)."""

from noetic_slam_tpu.utils.synthetic import Sim, ate_rmse, make_sim  # noqa: F401
