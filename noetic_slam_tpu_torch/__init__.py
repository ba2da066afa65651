"""noetic_slam_tpu_torch — the PyTorch/CUDA port of ``noetic_slam_tpu``.

The layout mirrors the JAX package, so each module's counterpart sits at
the same path:

- ``utils.geometry``       — quaternion / SO(3) / SE(3) maths.
- ``ops``                  — scan intake, deskew, IMU integration,
                             nearest neighbours, GICP.
- ``ops.cuda``             — the hand-written Hopper kernels (CUDA C++
                             sources in ``csrc/``) and their build.
- ``models``               — the odometry step, the fused SLAM step, the
                             TSDF and occupancy backends, the ESDF and the
                             sparse keyframe map.
- ``models.posegraph``, ``models.placedesc`` — the keyframe pose graph
                             (GN, PCG, loop verification) and the place
                             descriptors.
- ``runtime.pipeline``     — the host-side ``OdometryPipeline``.
- ``runtime.slam``         — ``SlamSystem``: odometry, map, pose graph, loop
                             closure, the keyframe archive
                             (``runtime.archive``) and checkpoints
                             (``runtime.checkpoint``).
- ``io``                   — dataset replay, the MulRan reader, the PLY /
                             PCD / TUM writers and surface-nets meshing.
- ``config``, ``utils.synthetic`` — the configuration dataclasses and the
                             synthetic world simulator.
- ``convert``              — state carried across from / to the JAX package.

The JAX package stays the reference. The port imports ``torch`` and numpy,
never ``jax`` and nothing of the JAX package: where it needs one of that
package's numpy-only code (``config.params``, ``utils.synthetic``,
``io.mulran``, ``io.export``, ``runtime.poseext``, ``StageTimer`` of
``runtime.profiling``, ``ring_descriptor`` of ``models.placedesc``) it keeps
its own copy, which ``tests/test_torch_copies.py`` holds to the original.

Entry points (``SlamSystem``, ``OdometryPipeline``, the ``init_*``
functions) run on the card unless the caller names another device: a
``device`` argument left at ``None`` means ``device()``, which raises where
there is no card (the tests pass ``"cpu"``).

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


def resolve_device(dev=None) -> torch.device:
    """``dev`` as a ``torch.device``; ``None`` means the card (``device()``)."""
    return device() if dev is None else torch.device(dev)


def __getattr__(name):
    # ``SlamSystem`` at the package root, imported on first use (the
    # runtime imports this module for ``resolve_device``)
    if name == "SlamSystem":
        from noetic_slam_tpu_torch.runtime.slam import SlamSystem

        return SlamSystem
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
