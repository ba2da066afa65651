"""Device -> host transfers of several tensors at once."""

from __future__ import annotations

import numpy as np
import torch


def to_host(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """numpy copies of ``tensors``: every copy is queued before one wait,
    so a batch of CUDA tensors costs one stream synchronisation, not one
    each."""
    out = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    return tuple(t.numpy() for t in out)
