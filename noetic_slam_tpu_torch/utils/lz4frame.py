"""LZ4 frame (de)compression via ctypes on the system liblz4.

rosbag v2.0 "lz4" chunk compression is the LZ4 frame format (roslz4's
lz4s.c implements the same framing spec the lz4frame API reads/writes),
so binding liblz4 directly covers lz4 bags without a Python lz4 package.

The port's own copy of ``noetic_slam_tpu.utils.lz4frame`` (it imports
nothing of the JAX package); ``tests/test_torch_ingest.py`` holds it to the
original.
"""

from __future__ import annotations

import ctypes as C

_LZ4F_VERSION = 100


class _Lib:
    _lib = None
    _checked = False

    @classmethod
    def get(cls):
        if not cls._checked:
            cls._checked = True
            try:
                lib = C.CDLL("liblz4.so.1")
                for sym in ("LZ4F_createDecompressionContext",
                            "LZ4F_decompress", "LZ4F_compressFrame",
                            "LZ4F_compressFrameBound", "LZ4F_isError",
                            "LZ4F_freeDecompressionContext"):
                    getattr(lib, sym)
                lib.LZ4F_isError.restype = C.c_uint
                lib.LZ4F_isError.argtypes = [C.c_size_t]
                lib.LZ4F_compressFrameBound.restype = C.c_size_t
                lib.LZ4F_compressFrameBound.argtypes = [C.c_size_t,
                                                        C.c_void_p]
                lib.LZ4F_compressFrame.restype = C.c_size_t
                lib.LZ4F_compressFrame.argtypes = [
                    C.c_void_p, C.c_size_t, C.c_void_p, C.c_size_t,
                    C.c_void_p]
                lib.LZ4F_createDecompressionContext.restype = C.c_size_t
                lib.LZ4F_createDecompressionContext.argtypes = [
                    C.POINTER(C.c_void_p), C.c_uint]
                lib.LZ4F_freeDecompressionContext.restype = C.c_size_t
                lib.LZ4F_freeDecompressionContext.argtypes = [C.c_void_p]
                lib.LZ4F_decompress.restype = C.c_size_t
                lib.LZ4F_decompress.argtypes = [
                    C.c_void_p, C.c_void_p, C.POINTER(C.c_size_t),
                    C.c_void_p, C.POINTER(C.c_size_t), C.c_void_p]
                cls._lib = lib
            except OSError:
                cls._lib = None
        return cls._lib


def available() -> bool:
    return _Lib.get() is not None


def compress(data: bytes) -> bytes:
    lib = _Lib.get()
    if lib is None:
        raise RuntimeError("liblz4 unavailable")
    bound = lib.LZ4F_compressFrameBound(len(data), None)
    dst = C.create_string_buffer(bound)
    n = lib.LZ4F_compressFrame(dst, bound, data, len(data), None)
    if lib.LZ4F_isError(n):
        raise RuntimeError(f"LZ4F_compressFrame error {n}")
    return dst.raw[:n]


def decompress(data: bytes) -> bytes:
    lib = _Lib.get()
    if lib is None:
        raise RuntimeError("liblz4 unavailable")
    ctx = C.c_void_p()
    err = lib.LZ4F_createDecompressionContext(C.byref(ctx), _LZ4F_VERSION)
    if lib.LZ4F_isError(err):
        raise RuntimeError(f"LZ4F context error {err}")
    try:
        out = []
        src = (C.c_char * len(data)).from_buffer_copy(data)
        src_pos = 0
        chunk = 1 << 20
        dst = C.create_string_buffer(chunk)
        while src_pos < len(data):
            dst_size = C.c_size_t(chunk)
            src_size = C.c_size_t(len(data) - src_pos)
            hint = lib.LZ4F_decompress(
                ctx, dst, C.byref(dst_size),
                C.byref(src, src_pos), C.byref(src_size), None)
            if lib.LZ4F_isError(hint):
                raise RuntimeError(f"LZ4F_decompress error {hint}")
            out.append(dst.raw[:dst_size.value])
            src_pos += src_size.value
            if hint == 0 and src_pos < len(data):
                # frame ended early; trailing garbage is an error for bags
                raise RuntimeError("trailing data after LZ4 frame")
        return b"".join(out)
    finally:
        lib.LZ4F_freeDecompressionContext(ctx)
