"""The MulRan dataset reader, shared with the JAX package
(``noetic_slam_tpu.io.mulran`` is numpy only)."""

from noetic_slam_tpu.io.mulran import MulranDataset  # noqa: F401
