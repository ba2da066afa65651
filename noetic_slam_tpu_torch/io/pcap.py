"""Pcap/pcapng packet capture reader/writer (pure Python, no libpcap).

Parity with the reference's ouster_pcap package (ouster-sdk/ouster_pcap/):
recorded UDP captures replayed through the parsing stack are the SDK's only
hardware-free end-to-end path (SURVEY.md §4, pcap_test.cpp). This reader
handles classic pcap files (magic 0xa1b2c3d4 / 0xd4c3b2a1, micro- and
nanosecond variants) and pcapng captures (SHB/IDB/EPB/SPB blocks, per-
interface if_tsresol) with Ethernet/IPv4/UDP framing, yielding
(timestamp, dst_port, payload) tuples; the writer produces classic
captures the reader (and tcpdump) can consume.

The port's own copy of ``noetic_slam_tpu.io.pcap`` (it imports nothing of
the JAX package); ``tests/test_torch_ingest.py`` holds it to the original.
``replay_pcap_scans`` batches through the port's own ``io.ouster``.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional

MAGIC_US = 0xA1B2C3D4
MAGIC_NS = 0xA1B23C4D
MAGIC_PCAPNG = 0x0A0D0D0A  # SHB block type


def read_pcap(path: str, port: Optional[int] = None) -> Iterator[tuple]:
    """Yield (ts_seconds: float, dst_port: int, payload: bytes) for each UDP
    packet (optionally filtered by destination port). Dispatches on the
    file magic between classic pcap and pcapng."""
    with open(path, "rb") as f:
        first = f.read(4)
        if len(first) < 4:
            return
        f.seek(0)
        if struct.unpack("<I", first)[0] == MAGIC_PCAPNG:
            frames = _read_pcapng(f)
        else:
            frames = _read_classic(f)
        for ts, data in frames:
            pkt = _parse_udp(data)
            if pkt is None:
                continue
            dst, payload = pkt
            if port is not None and dst != port:
                continue
            yield ts, dst, payload


def _read_classic(f) -> Iterator[tuple]:
    hdr = f.read(24)
    if len(hdr) < 24:
        return
    magic = struct.unpack("<I", hdr[:4])[0]
    if magic in (MAGIC_US, MAGIC_NS):
        endian = "<"
    else:
        magic = struct.unpack(">I", hdr[:4])[0]
        if magic not in (MAGIC_US, MAGIC_NS):
            raise ValueError("not a pcap file")
        endian = ">"
    ns = magic == MAGIC_NS
    while True:
        ph = f.read(16)
        if len(ph) < 16:
            return
        ts_sec, ts_frac, incl, _orig = struct.unpack(endian + "IIII", ph)
        data = f.read(incl)
        if len(data) < incl:
            return
        yield ts_sec + ts_frac * (1e-9 if ns else 1e-6), data


def _pcapng_tsresol(options: bytes, endian: str) -> float:
    """Scan IDB options for if_tsresol (code 9); default 1e-6."""
    off = 0
    while off + 4 <= len(options):
        code, olen = struct.unpack_from(endian + "HH", options, off)
        off += 4
        if code == 0:  # opt_endofopt
            break
        if code == 9 and olen >= 1:
            v = options[off]
            return 2.0 ** -(v & 0x7F) if v & 0x80 else 10.0 ** -v
        off += (olen + 3) & ~3
    return 1e-6


def _read_pcapng(f) -> Iterator[tuple]:
    """Walk pcapng blocks (SHB 0x0A0D0D0A, IDB 1, EPB 6, SPB 3)."""
    endian = "<"
    tsresols: list[float] = []
    while True:
        head = f.read(8)
        if len(head) < 8:
            return
        btype = struct.unpack(endian + "I", head[:4])[0]
        if btype == MAGIC_PCAPNG:
            # new section: byte-order magic decides endianness
            body = f.read(4)
            bom = struct.unpack("<I", body)[0]
            endian = "<" if bom == 0x1A2B3C4D else ">"
            blen = struct.unpack(endian + "I", head[4:8])[0]
            f.read(blen - 12)  # rest of SHB incl. trailing length
            tsresols = []
            continue
        blen = struct.unpack(endian + "I", head[4:8])[0]
        if blen < 12:
            raise ValueError("corrupt pcapng block")
        body = f.read(blen - 12)
        f.read(4)  # trailing block length
        if len(body) < blen - 12:
            return
        if btype == 1:  # IDB: u16 linktype, u16 reserved, u32 snaplen, opts
            tsresols.append(_pcapng_tsresol(body[8:], endian))
        elif btype == 6:  # EPB
            if_id, ts_hi, ts_lo, cap_len, _orig = struct.unpack_from(
                endian + "IIIII", body, 0)
            data = body[20:20 + cap_len]
            res = tsresols[if_id] if if_id < len(tsresols) else 1e-6
            yield ((ts_hi << 32) | ts_lo) * res, data
        elif btype == 3:  # SPB: orig len, then data (no timestamp)
            (orig,) = struct.unpack_from(endian + "I", body, 0)
            yield 0.0, body[4:4 + orig]
        # other block types (NRB, ISB, custom) are skipped


def _parse_udp(frame: bytes):
    """Ethernet/IPv4/UDP -> (dst_port, payload) or None."""
    if len(frame) < 14:
        return None
    ethertype = struct.unpack(">H", frame[12:14])[0]
    off = 14
    if ethertype == 0x8100:       # 802.1Q VLAN tag
        ethertype = struct.unpack(">H", frame[16:18])[0]
        off = 18
    if ethertype != 0x0800:       # IPv4 only
        return None
    if len(frame) < off + 20:
        return None
    ihl = (frame[off] & 0x0F) * 4
    proto = frame[off + 9]
    if proto != 17:               # UDP
        return None
    uoff = off + ihl
    if len(frame) < uoff + 8:
        return None
    dst_port, length = struct.unpack(">HH", frame[uoff + 2:uoff + 6])
    payload = frame[uoff + 8:uoff + length]
    return dst_port, payload


def write_pcap(path: str, packets, src_port: int = 7502) -> int:
    """Write (ts_seconds, dst_port, payload) tuples as a classic pcap
    (microsecond, little-endian, Ethernet linktype). Returns packet count."""
    n = 0
    with open(path, "wb") as f:
        f.write(struct.pack("<IHHiIII", MAGIC_US, 2, 4, 0, 0, 65535, 1))
        for ts, dst_port, payload in packets:
            frame = _build_frame(src_port, dst_port, payload)
            sec = int(ts)
            usec = int(round((ts - sec) * 1e6))
            f.write(struct.pack("<IIII", sec, usec, len(frame), len(frame)))
            f.write(frame)
            n += 1
    return n


def _build_frame(src_port: int, dst_port: int, payload: bytes) -> bytes:
    eth = b"\x02" * 6 + b"\x04" * 6 + b"\x08\x00"
    udp_len = 8 + len(payload)
    ip_len = 20 + udp_len
    ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, ip_len, 0, 0, 64, 17, 0,
                     bytes([127, 0, 0, 1]), bytes([127, 0, 0, 1]))
    udp = struct.pack(">HHHH", src_port, dst_port, udp_len, 0)
    return eth + ip + udp + payload


def replay_pcap_scans(path: str, info, lidar_port: int = 7502,
                      imu_port: int = 7503):
    """Replay a capture through the parsing stack: yields
    ("scan", ts, LidarScan) and ("imu", ts_ns, accel, gyro) events in file
    order — the role of the reference's OusterReplay + pcap reader."""
    from noetic_slam_tpu_torch.io.ouster import PacketFormat, ScanBatcher

    pf = PacketFormat(info)
    batcher = ScanBatcher(info)
    for ts, port, payload in read_pcap(path):
        if port == lidar_port and len(payload) >= pf.lidar_packet_size:
            done = batcher.push(payload)
            if done is not None:
                yield ("scan", ts, done)
        elif port == imu_port and len(payload) >= pf.imu_packet_size:
            sys_ts, accel, gyro = pf.parse_imu_packet(payload)
            yield ("imu", sys_ts, accel, gyro)
    done = batcher.flush()
    if done is not None:
        yield ("scan", None, done)
