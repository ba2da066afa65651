"""Transfers between the host and the device that do not stall the card
more than they must."""

from __future__ import annotations

import numpy as np
import torch


def to_device(a, device) -> torch.Tensor:
    """A copy of the numpy array ``a`` on ``device``. To the card it goes
    through pinned memory without a wait (a copy from pageable memory
    synchronises the stream)."""
    device = torch.device(device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


def to_host(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """numpy copies of ``tensors``: every copy is queued before one wait
    (``PendingFetch``), so a batch of CUDA tensors costs one wait, not one
    each."""
    out = PendingFetch(dict(enumerate(tensors))).wait()
    return tuple(out[i] for i in range(len(tensors)))


class PendingFetch:
    """Copies of a dict of tensors to the host, queued now and read later.

    On the card each copy is a non-blocking device->host copy into pinned
    memory, queued on the current stream behind the work that produces the
    tensor, and an event recorded after the last; ``wait()`` blocks on that
    event alone, so the copies overlap whatever the host queues meanwhile.
    A CPU tensor is cloned at once (the port updates state tensors in
    place, so a later step must not change what was fetched)."""

    def __init__(self, tensors: dict):
        self._out = {}
        self._event = None
        for name, t in tensors.items():
            t = t.detach()
            self._out[name] = (t.to("cpu", non_blocking=True) if t.is_cuda
                               else t.clone())
            if t.is_cuda and self._event is None:
                self._event = torch.cuda.Event()
        if self._event is not None:
            self._event.record()

    def wait(self) -> dict:
        """{name: ndarray}, after the copies have landed."""
        if self._event is not None:
            self._event.synchronize()
        return {name: t.numpy() for name, t in self._out.items()}
