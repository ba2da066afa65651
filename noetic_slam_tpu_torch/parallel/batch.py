"""Multi-sequence odometry (port of ``noetic_slam_tpu.parallel.batch``).

The JAX module ``vmap``s the pure odometry step over a stacked state, so B
independent sequences advance in one program. The port's step branches on
the host (``models/odometry.py``: the skip, bootstrap and re-gather reads,
and GICP's outer loop), so a ``vmap`` has no counterpart here: the batched
step runs the one-sequence step on each sequence in order, which keeps the
vmapped step's semantics (independent sequences, each advanced by exactly
one step per call). Each sequence's GICP launches kernel A on its own.

``stack_states`` / ``unstack_state`` convert between per-sequence states
and the stacked layout (the JAX package's batch checkpoint and tests); the
runtime keeps one state per sequence and never stacks per round: at the
default capacities a state is ~172 MB and a stacked copy would double it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from noetic_slam_tpu_torch.config import DlioConfig
from noetic_slam_tpu_torch.models.odometry import (
    OdomState,
    StepInput,
    init_state,
    make_odometry_step,
)
from noetic_slam_tpu_torch.ops.gicp import HostSyncs


def stack_states(states: Sequence[OdomState]) -> OdomState:
    """Stack per-sequence states along a new leading batch axis (on the
    first state's device)."""
    dev = states[0].q.device
    return OdomState(*(torch.stack([x.to(dev) for x in xs])
                       for xs in zip(*states)))


def unstack_state(batched: OdomState, i: int) -> OdomState:
    """Sequence ``i`` of a stacked state, as its own tensors."""
    return OdomState(*(x[i].clone() for x in batched))


def init_batched_state(cfg: DlioConfig, batch: int, device=None,
                       **kw) -> OdomState:
    return stack_states([init_state(cfg, device, **kw)
                         for _ in range(batch)])


def make_batched_odometry_step(cfg: DlioConfig, syncs: HostSyncs | None = None):
    """``step(states, inputs) -> (states, outs)`` over lists of B
    per-sequence states and inputs: the one-sequence step on each in order
    (each state updated in place, as the one-sequence step does). Host
    reads are counted in ``syncs``."""
    one = make_odometry_step(cfg, syncs)

    def step(states: List[OdomState], inputs: Sequence[StepInput]):
        assert len(states) == len(inputs)
        outs = []
        for j, inp in enumerate(inputs):
            states[j], out = one(states[j], inp)
            outs.append(out)
        return states, outs

    return step
