"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``): the same numpy inputs go through
both, and the outputs are compared as numpy arrays."""

import dataclasses

import numpy as np
import pytest
import torch

from noetic_slam_tpu.config import params as jax_params

# small-size parity runs share the machine with other test workers
torch.set_num_threads(1)

# Elementwise ops, same formula in both: float32 rounding only
# (reassociation, XLA's fused multiply-adds).
RTOL, ATOL = 1e-5, 1e-6


def to_torch(x, device="cpu"):
    return torch.from_numpy(np.array(x)).to(device)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=rtol, atol=atol)


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test where there is none (the kernels
    build and run only on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel test)")
    return torch.device("cuda")


def jax_cfg(cfg):
    """The JAX package's config equal to the port's ``cfg``, field by field:
    a ``DlioConfig`` through the JAX ``load_config`` overrides, any other
    (flat) config dataclass as its JAX class of the same name."""
    fields = dataclasses.asdict(cfg)
    if type(cfg).__name__ == "DlioConfig":
        return jax_params.load_config(overrides=fields)
    return getattr(jax_params, type(cfg).__name__)(**fields)
