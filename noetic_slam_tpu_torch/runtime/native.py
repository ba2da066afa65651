"""ctypes bindings for the native runtime library.

The port's own copy of ``noetic_slam_tpu.runtime.native``, built from the
port's own copy of the C++ sources (``noetic_slam_tpu_torch/native/``,
``Makefile`` and ``src/*.cpp``). It builds on demand with ``make`` (g++) the
first time it is needed, into ``build/native/`` beside the package (a
git-ignored directory); all consumers degrade gracefully to pure-Python
paths when the toolchain or the library is unavailable
(``load(required=False)``). ``tests/test_torch_ingest.py`` holds it to the
original.

Components (see native/src/*.cpp):
- RingBuffer: thread-safe fixed-slot ring (driver backpressure,
  ~ reference thread_safe_ring_buffer.h semantics)
- parse_lidar_packets: batch packet -> field-image parser
- UdpSource: dual-socket UDP receiver thread (~ reference client.cpp
  poll/read loop)
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG, "native")
_LIB_PATH = os.path.join(os.path.dirname(_PKG), "build", "native",
                         "libnoetic_slam_native.so")

_lib = None
_lock = threading.Lock()


def load(required: bool = False):
    """Load (building if necessary) the native library; returns the CDLL or
    None."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            # built under a private name, then moved into place: another
            # process never loads a half-written library
            os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
            tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR, f"OUT={tmp}"],
                               check=True, capture_output=True, timeout=240)
                os.replace(tmp, _LIB_PATH)
            except Exception as e:  # toolchain missing / build failure
                if required:
                    raise RuntimeError(f"native build failed: {e}") from e
                return None
        try:
            lib = C.CDLL(_LIB_PATH)
        except OSError as e:
            if required:
                raise
            return None
        _declare(lib)
        _lib = lib
        return _lib


def _declare(lib):
    lib.nst_ring_create.restype = C.c_void_p
    lib.nst_ring_create.argtypes = [C.c_size_t, C.c_size_t]
    lib.nst_ring_destroy.argtypes = [C.c_void_p]
    lib.nst_ring_size.restype = C.c_size_t
    lib.nst_ring_size.argtypes = [C.c_void_p]
    lib.nst_ring_write.restype = C.c_int
    lib.nst_ring_write.argtypes = [C.c_void_p, C.c_char_p]
    lib.nst_ring_write_overwrite.restype = C.c_int
    lib.nst_ring_write_overwrite.argtypes = [C.c_void_p, C.c_char_p]
    lib.nst_ring_read.restype = C.c_int
    lib.nst_ring_read.argtypes = [C.c_void_p, C.c_char_p, C.c_long]

    lib.nst_parse_lidar_packets.restype = C.c_int
    lib.nst_parse_lidar_packets.argtypes = [
        C.c_char_p, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        np.ctypeslib.ndpointer(np.uint64), np.ctypeslib.ndpointer(np.uint16),
        np.ctypeslib.ndpointer(np.uint8), np.ctypeslib.ndpointer(np.uint16),
        np.ctypeslib.ndpointer(np.uint32), np.ctypeslib.ndpointer(np.uint16),
        np.ctypeslib.ndpointer(np.uint16), np.ctypeslib.ndpointer(np.uint16)]

    lib.nst_udp_create.restype = C.c_void_p
    lib.nst_udp_create.argtypes = [C.c_int, C.c_int, C.c_size_t, C.c_size_t,
                                   C.c_size_t]
    lib.nst_udp_create_mtp.restype = C.c_void_p
    lib.nst_udp_create_mtp.argtypes = [C.c_int, C.c_int, C.c_size_t,
                                       C.c_size_t, C.c_size_t, C.c_char_p]
    lib.nst_udp_destroy.argtypes = [C.c_void_p]
    lib.nst_udp_read_lidar.restype = C.c_int
    lib.nst_udp_read_lidar.argtypes = [C.c_void_p, C.c_char_p, C.c_long]
    lib.nst_udp_read_lidar_many.restype = C.c_int
    lib.nst_udp_read_lidar_many.argtypes = [C.c_void_p, C.c_char_p,
                                            C.c_int, C.c_long]
    lib.nst_udp_read_imu.restype = C.c_int
    lib.nst_udp_read_imu.argtypes = [C.c_void_p, C.c_char_p, C.c_long]
    lib.nst_udp_lidar_dropped.restype = C.c_uint64
    lib.nst_udp_lidar_dropped.argtypes = [C.c_void_p]


class RingBuffer:
    def __init__(self, item_size: int, capacity: int):
        self._lib = load(required=True)
        self.item_size = item_size
        self._h = self._lib.nst_ring_create(item_size, capacity)

    def __len__(self):
        return self._lib.nst_ring_size(self._h)

    def write(self, item: bytes) -> None:
        assert len(item) == self.item_size
        self._lib.nst_ring_write(self._h, item)

    def write_overwrite(self, item: bytes) -> bool:
        """Returns True if an old item was dropped."""
        assert len(item) == self.item_size
        return bool(self._lib.nst_ring_write_overwrite(self._h, item))

    def read(self, timeout_ms: int = -1) -> Optional[bytes]:
        buf = C.create_string_buffer(self.item_size)
        if self._lib.nst_ring_read(self._h, buf, timeout_ms):
            return None
        return buf.raw

    def close(self):
        if self._h:
            self._lib.nst_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def parse_lidar_packets(buf: bytes, n_packets: int, pf) -> dict:
    """Batch-parse packets with the native parser; ``pf`` is an
    io.ouster.PacketFormat. Falls back to the Python parser when the native
    lib is unavailable."""
    lib = load()
    total_cols = n_packets * pf.cols
    out = {
        "ts": np.empty(total_cols, np.uint64),
        "m_id": np.empty(total_cols, np.uint16),
        "status": np.empty(total_cols, np.uint8),
        "frame_id": np.empty(total_cols, np.uint16),
        "range": np.empty((pf.h, total_cols), np.uint32),
        "signal": np.empty((pf.h, total_cols), np.uint16),
        "reflectivity": np.empty((pf.h, total_cols), np.uint16),
        "near_ir": np.empty((pf.h, total_cols), np.uint16),
    }
    if lib is not None:
        lib.nst_parse_lidar_packets(
            buf, n_packets, pf.lidar_packet_size, int(pf.legacy), pf.h,
            pf.cols, pf.chan, out["ts"], out["m_id"], out["status"],
            out["frame_id"], out["range"], out["signal"],
            out["reflectivity"], out["near_ir"])
        return out
    # Python fallback
    for p in range(n_packets):
        pkt = buf[p * pf.lidar_packet_size:(p + 1) * pf.lidar_packet_size]
        ts, m_id, status, rng, sig, refl, nir = pf.parse_lidar_packet(pkt)
        sl = slice(p * pf.cols, (p + 1) * pf.cols)
        out["ts"][sl] = ts
        out["m_id"][sl] = m_id
        out["status"][sl] = status
        if pf.legacy:
            fid = np.frombuffer(pkt, np.uint16, 1, offset=10)[0]
        else:
            fid = np.frombuffer(pkt, np.uint16, 1, offset=2)[0]
        out["frame_id"][sl] = fid
        out["range"][:, sl] = rng
        out["signal"][:, sl] = sig
        out["reflectivity"][:, sl] = refl
        out["near_ir"][:, sl] = nir
    return out


class UdpSource:
    """Live UDP ingest (lidar + imu ports) backed by the native receiver
    thread."""

    def __init__(self, lidar_port: int, imu_port: int, lidar_packet_size: int,
                 imu_packet_size: int = 48, depth: int = 640,
                 mtp_group: str | None = None):
        """``mtp_group``: dotted-quad multicast group to join (the SDK's
        MTP mode, client.cpp mtp_init_client — several hosts subscribing
        to one sensor stream); None for unicast."""
        self._lib = load(required=True)
        self.lidar_packet_size = lidar_packet_size
        self.imu_packet_size = imu_packet_size
        if mtp_group:
            self._h = self._lib.nst_udp_create_mtp(
                lidar_port, imu_port, lidar_packet_size, imu_packet_size,
                depth, mtp_group.encode())
        else:
            self._h = self._lib.nst_udp_create(lidar_port, imu_port,
                                               lidar_packet_size,
                                               imu_packet_size, depth)
        if not self._h:
            raise OSError("failed to bind UDP ports "
                          f"{lidar_port}/{imu_port}"
                          + (f" (mtp {mtp_group})" if mtp_group else ""))

    def read_lidar(self, timeout_ms: int = 100) -> Optional[bytes]:
        buf = C.create_string_buffer(self.lidar_packet_size)
        n = self._lib.nst_udp_read_lidar(self._h, buf, timeout_ms)
        return buf.raw[:n] if n else None

    def read_lidar_many(self, max_n: int = 64,
                        timeout_ms: int = 100):
        """Drain up to ``max_n`` lidar packets in ONE native call.
        Returns (contiguous buffer, n_packets) — stride = packet size,
        short datagrams zero-padded. (0 packets -> (b"", 0).)"""
        sz = self.lidar_packet_size
        buf = C.create_string_buffer(sz * max_n)
        n = self._lib.nst_udp_read_lidar_many(self._h, buf, max_n,
                                              timeout_ms)
        return (buf.raw[: n * sz], n) if n > 0 else (b"", 0)

    def read_imu(self, timeout_ms: int = 100) -> Optional[bytes]:
        buf = C.create_string_buffer(self.imu_packet_size)
        n = self._lib.nst_udp_read_imu(self._h, buf, timeout_ms)
        return buf.raw[:n] if n else None

    @property
    def lidar_dropped(self) -> int:
        return int(self._lib.nst_udp_lidar_dropped(self._h))

    def close(self):
        if self._h:
            self._lib.nst_udp_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
