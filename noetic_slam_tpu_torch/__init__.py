"""noetic_slam_tpu_torch — the PyTorch/CUDA port of ``noetic_slam_tpu``.

The layout mirrors the JAX package, so each module's counterpart sits at
the same path:

- ``utils.geometry``       — quaternion / SO(3) / SE(3) maths.
- ``ops``                  — scan intake, deskew, IMU integration,
                             nearest neighbours, GICP.
- ``ops.cuda``             — the hand-written Hopper kernels (CUDA C++
                             sources in ``csrc/``) and their build.
- ``models``               — the odometry step, the fused SLAM step and the
                             TSDF backend.
- ``runtime.pipeline``     — the host-side ``OdometryPipeline``.
- ``io.replay``            — dataset replay over the port's pipeline.
- ``convert``              — state carried across from / to the JAX package.

The JAX package stays the reference. The port imports ``torch`` and numpy,
never ``jax``; the only modules of the JAX package it reuses are its
JAX-free ones (``config.params``, ``utils.synthetic``, ``io.mulran``).

Every coordinate product in the JAX package runs at full f32
(``precision=HIGHEST``). On Hopper the same trap is TF32, so it is turned
off here for the whole process.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def device() -> torch.device:
    """The CUDA device the port runs on. Raises when there is none: the
    port never falls back to the CPU silently (tests pass ``"cpu"``
    explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError("noetic_slam_tpu_torch.device(): no CUDA device")
    return torch.device("cuda")
