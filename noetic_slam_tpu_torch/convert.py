"""State carried across between the JAX package and the port.

The odometry and map states (TSDF or occupancy) are this system's
"weights": the tests run JAX steps to a mid-run state, fetch it as numpy
arrays, carry it into the port with ``*_state_from_numpy``, and run one
step of both implementations from the same state. ``*_to_numpy`` is
the reverse. Fields are matched by name; JAX fields the port does not
carry (the grid-NN index) are ignored. The pose graph carries across the
same way; the keyframe archive and the descriptor store carry across
through their numpy ``pack`` / ``unpack``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from noetic_slam_tpu_torch.models.occupancy import OccupancyState
from noetic_slam_tpu_torch.models.odometry import OdomState
from noetic_slam_tpu_torch.models.posegraph import PoseGraph
from noetic_slam_tpu_torch.models.tsdf import TsdfState


def _fields(state) -> Mapping:
    return state._asdict() if hasattr(state, "_asdict") else state


def _from_numpy(cls, state, device):
    src = _fields(state)
    return cls(**{name: torch.from_numpy(np.array(src[name])).to(device)
                  for name in cls._fields})


def _to_numpy(state) -> dict:
    return {name: value.detach().cpu().numpy()
            for name, value in state._asdict().items()}


def odom_state_from_numpy(state, device) -> OdomState:
    """An ``OdomState`` on ``device`` from a JAX ``OdomState`` (or any
    mapping / NamedTuple of arrays with its field names)."""
    return _from_numpy(OdomState, state, device)


def tsdf_state_from_numpy(state, device) -> TsdfState:
    """A ``TsdfState`` on ``device`` from a JAX ``TsdfState`` (or any
    mapping / NamedTuple of arrays with its field names)."""
    return _from_numpy(TsdfState, state, device)


def odom_state_to_numpy(state: OdomState) -> dict:
    """{field: ndarray} of a port ``OdomState``."""
    return _to_numpy(state)


def tsdf_state_to_numpy(state: TsdfState) -> dict:
    """{field: ndarray} of a port ``TsdfState``."""
    return _to_numpy(state)


def occupancy_state_from_numpy(state, device) -> OccupancyState:
    """An ``OccupancyState`` on ``device`` from a JAX ``OccupancyState``
    (or any mapping / NamedTuple of arrays with its field names)."""
    return _from_numpy(OccupancyState, state, device)


def occupancy_state_to_numpy(state: OccupancyState) -> dict:
    """{field: ndarray} of a port ``OccupancyState``."""
    return _to_numpy(state)


def posegraph_from_numpy(graph, device) -> PoseGraph:
    """A ``PoseGraph`` on ``device`` from a JAX ``PoseGraph`` (or any
    mapping / NamedTuple of arrays with its field names)."""
    return _from_numpy(PoseGraph, graph, device)


def posegraph_to_numpy(graph: PoseGraph) -> dict:
    """{field: ndarray} of a port ``PoseGraph``."""
    return _to_numpy(graph)
