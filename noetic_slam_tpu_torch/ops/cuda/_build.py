"""Build and load the hand-written CUDA kernels of ``noetic_slam_tpu_torch/csrc``.

Route: ``nvcc`` by hand into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds). One
``nvcc`` per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <source>.o noetic_slam_tpu_torch/csrc/<source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/torch_kernels/libnst_kernels_<hash>.so *.o

The library is built at first use into ``build/torch_kernels/`` at the
repository root, named by a content hash of the sources, so an edited
source rebuilds and an unchanged one loads the existing file. A failed
build raises with nvcc's output; nothing falls back to a plain version.
Every C entry point that launches takes its pointers and the CUDA stream
as ``c_void_p`` and returns ``cudaGetLastError()`` after its launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from noetic_slam_tpu_torch.runtime.profiling import span

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
DEFAULT_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                                 "torch_kernels")
BUILD_DIR = DEFAULT_BUILD_DIR    # runtime.compile_cache.enable may move it
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: name -> argtypes (every function returns int cudaError_t)
_SIGNATURES = {
    # t, nt, t_count* (or null), t_count_host, tbox, stream
    "nst_nn1_boxes_launch": [_P, _I, _P, _I, _P, _P],
    # q, nq, t, nt, t_count* (or null), t_count_host, max_dist* (or null),
    # cap2_host, tbox, out_idx, out_d, stream
    "nst_nn1_walk_launch": [_P, _I, _P, _I, _P, _I, _P, _F, _P, _P, _P, _P],
    # kernel A's shape: target rows a tile, queries a group, warps a CTA,
    # most target rows a call takes; no arguments
    "nst_nn1_tile": [],
    "nst_nn1_group": [],
    "nst_nn1_warps": [],
    "nst_nn1_max_rows": [],
    # weight, wsum, C, rows, starts, cnts, A, ivox, w, wd, S, max_weight,
    # no_clamp, stream
    "nst_tsdf_accum_launch": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                              _F, _I, _P],
    # logodds, C, rows, starts, cnts, A, ivox, delta, S, l_min, l_max, stream
    "nst_logodds_accum_launch": [_P, _I, _P, _P, _P, _I, _P, _P, _I, _F, _F,
                                 _P],
    # the entry cut of kernels B and C: most warps per entry, samples one
    # warp takes alone, samples per part; no arguments
    "nst_block_accum_warps": [],
    "nst_block_accum_short": [],
    "nst_block_accum_part": [],
    # src, tgt_rows, maha, n, H, b, y0, x0, lam_in, K, init_lambda_factor,
    # rotation_epsilon, transformation_epsilon, partials, ticket, tally,
    # out, stream
    "nst_lm_search_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _F, _F,
                             _F, _P, _P, _P, _P, _P],
    # kernel D's shape: the most candidates, the pairs a block; no arguments
    "nst_lm_search_kmax": [],
    "nst_lm_search_block_pairs": [],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


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


def _run(cmd: list[str], proc: subprocess.Popen) -> None:
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{out}\n{err}")


def compile_library(srcs: list[str], out: str) -> None:
    """Builds the shared library ``out`` from the CUDA sources ``srcs``:
    one nvcc per source, all started together, then one link. Raises with
    nvcc's output on a failed build."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    for src in srcs:
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        for _, cmd, proc in jobs:
            _run(cmd, proc)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
               *(obj for obj, _, _ in jobs)]
        _run(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True))
    finally:
        for obj, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)          # atomic: concurrent builders never see
                                  # a half-written library


def open_library(path: str, names=tuple(_SIGNATURES)) -> ctypes.CDLL:
    """The library at ``path`` with the C signatures of ``names`` bound."""
    lib = ctypes.CDLL(path)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use (the ``setup.kernels_load``
    span: the build, if any, and the load). Raises on a failed build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with span("setup.kernels_load"):
            out = library_path()
            if not os.path.exists(out):
                compile_library(sources(), out)
            _lib = open_library(out)
        return _lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
