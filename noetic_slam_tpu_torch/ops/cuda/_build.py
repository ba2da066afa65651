"""Build and load the hand-written CUDA kernels of ``noetic_slam_tpu_torch/csrc``.

Route: ``nvcc`` by hand into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/libnst_kernels_<hash>.so \\
         noetic_slam_tpu_torch/csrc/*.cu

The library is built at first use into ``build/torch_kernels/`` at the
repository root, named by a content hash of the sources, so an edited
source rebuilds and an unchanged one loads the existing file. A failed
build raises with nvcc's output; nothing falls back to a plain version.
Every C entry point takes its pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: name -> argtypes (every function returns int cudaError_t)
_SIGNATURES = {
    # q, nq, t, nt, t_count*, cap2*, vlist, vlb, vcnt, ntt, q_tile, t_tile,
    # out_idx, out_d, stream
    "nst_nn1_launch": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                       _P, _P, _P],
    # weight, wsum, C, rows, starts, cnts, A, ivox, w, wd, S, max_weight,
    # no_clamp, stream
    "nst_tsdf_accum_launch": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                              _F, _I, _P],
    # logodds, C, rows, starts, cnts, A, ivox, delta, S, l_min, l_max, stream
    "nst_logodds_accum_launch": [_P, _I, _P, _P, _P, _I, _P, _P, _I, _F, _F,
                                 _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None     # wall time of this process's build


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("CUDA kernels: nvcc not found (CUDA_HOME unset "
                           "and nvcc not on PATH)")
    return found


def library_path() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libnst_kernels_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builders never see
                                  # a half-written library


def load() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises on a failed build."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not os.path.exists(out):
            t0 = time.perf_counter()
            _compile(out)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(out)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
