"""ROS1 bag (v2.0) reader/writer — no ROS dependency.

The reference's validation data are rosbags (src/dlio/README.md "Test
Data"; scripts/rosbag-replay.sh). This module implements the subset of the
bag format needed to replay LiDAR-inertial logs and to export results:

- record/chunk structure per the rosbag v2.0 spec (op 0x03 bag header,
  0x05 chunk [none|bz2|lz4 compression], 0x07 connection, 0x02 message data);
- binary deserialization of ``sensor_msgs/Imu`` and
  ``sensor_msgs/PointCloud2`` (vectorized field extraction via NumPy
  strided views — the role of pcl::fromROSMsg in getScanFromROS,
  odom.cc:492-494), including the per-point time channel under any of the
  reference's three conventions (``t`` ns / ``time`` s / ``timestamp`` abs,
  odom.cc:506-517);
- a minimal writer (uncompressed, one chunk) for exporting Odometry-style
  results and synthesizing test bags.

The port's own copy of ``noetic_slam_tpu.io.rosbag`` (it imports nothing of
the JAX package); ``tests/test_torch_ingest.py`` holds it to the original.
``replay_bag`` raises and catches the port's own ``NeedMoreImu``.
"""

from __future__ import annotations

import bz2
import struct
from typing import Iterator, Optional

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

# PointField datatypes (sensor_msgs/PointField)
_PF_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
              5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def _parse_header(buf: bytes) -> dict:
    out = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        eq = field.index(b"=")
        out[field[:eq].decode()] = field[eq + 1:]
    return out


def _read_record(f):
    lenb = f.read(4)
    if len(lenb) < 4:
        return None, None
    (hlen,) = struct.unpack("<I", lenb)
    header = _parse_header(f.read(hlen))
    (dlen,) = struct.unpack("<I", f.read(4))
    data = f.read(dlen)
    return header, data


def _iter_records(buf: bytes):
    off = 0
    while off + 4 <= len(buf):
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


class Connection:
    def __init__(self, cid: int, topic: str, data: bytes):
        self.id = cid
        self.topic = topic
        h = _parse_header(data)
        self.type = h.get("type", b"").decode()
        self.md5sum = h.get("md5sum", b"").decode()


def _read_string(buf, off):
    (n,) = struct.unpack_from("<I", buf, off)
    return buf[off + 4:off + 4 + n].decode(errors="replace"), off + 4 + n


def parse_imu(data: bytes) -> dict:
    """sensor_msgs/Imu -> {stamp, frame_id, orientation wxyz, ang_vel,
    lin_accel}."""
    off = 4  # header.seq
    sec, nsec = struct.unpack_from("<II", data, off)
    off += 8
    frame_id, off = _read_string(data, off)
    qx, qy, qz, qw = struct.unpack_from("<4d", data, off)
    off += 32 + 72          # orientation + its covariance
    wx, wy, wz = struct.unpack_from("<3d", data, off)
    off += 24 + 72
    ax, ay, az = struct.unpack_from("<3d", data, off)
    return {"stamp": sec + nsec * 1e-9, "frame_id": frame_id,
            "orientation": np.array([qw, qx, qy, qz]),
            "ang_vel": np.array([wx, wy, wz]),
            "lin_accel": np.array([ax, ay, az])}


def parse_odometry(data: bytes) -> dict:
    """nav_msgs/Odometry -> {stamp, frame_id, child_frame_id, p, q wxyz}."""
    off = 4
    sec, nsec = struct.unpack_from("<II", data, off)
    off += 8
    frame_id, off = _read_string(data, off)
    child, off = _read_string(data, off)
    px, py, pz = struct.unpack_from("<3d", data, off)
    off += 24
    qx, qy, qz, qw = struct.unpack_from("<4d", data, off)
    return {"stamp": sec + nsec * 1e-9, "frame_id": frame_id,
            "child_frame_id": child, "p": np.array([px, py, pz]),
            "q": np.array([qw, qx, qy, qz])}


def parse_image(data: bytes) -> dict:
    """sensor_msgs/Image (mono8/mono16) -> {stamp, frame_id, img (H, W)}."""
    off = 4
    sec, nsec = struct.unpack_from("<II", data, off)
    off += 8
    frame_id, off = _read_string(data, off)
    h, w = struct.unpack_from("<II", data, off)
    off += 8
    enc, off = _read_string(data, off)
    _be, step = struct.unpack_from("<BI", data, off)
    off += 5
    (nbytes,) = struct.unpack_from("<I", data, off)
    off += 4
    dt = {"mono8": np.uint8, "mono16": np.uint16}[enc]
    img = np.frombuffer(data, dt, count=h * w, offset=off).reshape(h, w)
    return {"stamp": sec + nsec * 1e-9, "frame_id": frame_id, "img": img}


def parse_pointcloud2(data: bytes) -> dict:
    """sensor_msgs/PointCloud2 -> {stamp, frame_id, xyz (N,3) f32,
    point_time (N,) f64 rel seconds | None, time_field}.

    Per-point time convention detection mirrors getScanFromROS
    (odom.cc:506-517): 't' (uint32 ns, Ouster), 'time' (float32 s,
    Velodyne), 'timestamp' (float64 abs s, Hesai — rebased by caller).
    """
    off = 4
    sec, nsec = struct.unpack_from("<II", data, off)
    off += 8
    frame_id, off = _read_string(data, off)
    height, width = struct.unpack_from("<II", data, off)
    off += 8
    (nfields,) = struct.unpack_from("<I", data, off)
    off += 4
    fields = []
    for _ in range(nfields):
        name, off = _read_string(data, off)
        foff, dtype, count = struct.unpack_from("<IBI", data, off)
        off += 9
        fields.append((name, foff, dtype, count))
    is_bigendian = data[off]
    off += 1
    point_step, row_step = struct.unpack_from("<II", data, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", data, off)
    off += 4
    raw = np.frombuffer(data, np.uint8, count=dlen, offset=off)
    n = dlen // point_step
    raw = raw[: n * point_step].reshape(n, point_step)

    def column(name):
        for fname, foff, dt, _cnt in fields:
            if fname == name:
                np_dt = _PF_DTYPES[dt]
                w = np.dtype(np_dt).itemsize
                return raw[:, foff:foff + w].copy().view(np_dt)[:, 0]
        return None

    xyz = np.stack([column("x"), column("y"), column("z")],
                   axis=-1).astype(np.float32)
    stamp = sec + nsec * 1e-9
    time_field = None
    pt = None
    if column("t") is not None:
        time_field = "t"
        pt = column("t").astype(np.float64) * 1e-9
    elif column("time") is not None:
        time_field = "time"
        pt = column("time").astype(np.float64)
    elif column("timestamp") is not None:
        time_field = "timestamp"
        pt = column("timestamp").astype(np.float64) - stamp
    return {"stamp": stamp, "frame_id": frame_id, "xyz": xyz,
            "point_time": pt, "time_field": time_field,
            "width": width, "height": height}


class BagReader:
    """Stream (topic, type, stamp, raw_bytes) message records from a v2.0
    bag (none/bz2/lz4 chunk compression)."""

    def __init__(self, path: str):
        self.path = path
        self.connections: dict[int, Connection] = {}

    def messages(self, topics=None) -> Iterator[tuple]:
        with open(self.path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError("not a ROS1 v2.0 bag")
            while True:
                header, data = _read_record(f)
                if header is None:
                    return
                op = header["op"][0]
                if op == OP_CHUNK:
                    comp = header.get("compression", b"none").decode()
                    if comp == "bz2":
                        data = bz2.decompress(data)
                    elif comp == "lz4":
                        from noetic_slam_tpu_torch.utils import lz4frame

                        data = lz4frame.decompress(data)
                    yield from self._chunk_messages(data, topics)
                elif op == OP_CONNECTION:
                    self._add_connection(header, data)

    def _add_connection(self, header, data):
        cid = struct.unpack("<I", header["conn"])[0]
        topic = header["topic"].decode()
        self.connections[cid] = Connection(cid, topic, data)

    def _chunk_messages(self, chunk: bytes, topics):
        for header, data in _iter_records(chunk):
            op = header["op"][0]
            if op == OP_CONNECTION:
                self._add_connection(header, data)
            elif op == OP_MSG:
                cid = struct.unpack("<I", header["conn"])[0]
                conn = self.connections.get(cid)
                if conn is None:
                    continue
                if topics and conn.topic not in topics:
                    continue
                sec, nsec = struct.unpack("<II", header["time"])
                yield (conn.topic, conn.type, sec + nsec * 1e-9, data)


def read_lidar_imu(path: str, pointcloud_topic: Optional[str] = None,
                   imu_topic: Optional[str] = None) -> Iterator[tuple]:
    """High-level: yields ("scan", dict) / ("imu", dict) events in bag
    order, auto-detecting topics by message type when not given."""
    reader = BagReader(path)
    for topic, mtype, _recv_t, data in reader.messages():
        if mtype == "sensor_msgs/PointCloud2":
            if pointcloud_topic is None or topic == pointcloud_topic:
                yield ("scan", parse_pointcloud2(data))
        elif mtype == "sensor_msgs/Imu":
            if imu_topic is None or topic == imu_topic:
                yield ("imu", parse_imu(data))


# ---------------------------------------------------------------------------
# Minimal writer
# ---------------------------------------------------------------------------

def _mk_header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _mk_record(fields: dict, data: bytes) -> bytes:
    h = _mk_header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


class BagWriter:
    """Minimal single-chunk v2.0 writer (readable by this module and by
    rosbag). ``compression`` in {"none", "bz2", "lz4"}; lz4 uses the
    LZ4 frame format, the same framing roslz4 reads."""

    def __init__(self, path: str, compression: str = "none"):
        if compression not in ("none", "bz2", "lz4"):
            raise ValueError(f"unknown compression {compression!r}")
        self.path = path
        self.compression = compression
        self._conns: dict[str, int] = {}
        self._conn_records: list[bytes] = []
        self._msgs: list[bytes] = []

    def _conn(self, topic: str, mtype: str, md5: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        cid = len(self._conns)
        self._conns[topic] = cid
        conn_data = _mk_header({"topic": topic.encode(),
                                "type": mtype.encode(),
                                "md5sum": md5.encode(),
                                "message_definition": b""})
        self._conn_records.append(_mk_record(
            {"op": bytes([OP_CONNECTION]),
             "conn": struct.pack("<I", cid),
             "topic": topic.encode()}, conn_data))
        return cid

    def write_raw(self, topic: str, mtype: str, md5: str, stamp: float,
                  payload: bytes) -> None:
        cid = self._conn(topic, mtype, md5)
        sec = int(stamp)
        nsec = int(round((stamp - sec) * 1e9))
        self._msgs.append(_mk_record(
            {"op": bytes([OP_MSG]), "conn": struct.pack("<I", cid),
             "time": struct.pack("<II", sec, nsec)}, payload))

    def write_imu(self, topic, stamp, ang_vel, lin_accel,
                  orientation=(1.0, 0, 0, 0), frame_id="imu"):
        fid = frame_id.encode()
        qw, qx, qy, qz = orientation
        sec = int(stamp)
        nsec = int(round((stamp - sec) * 1e9))
        payload = struct.pack("<III", 0, sec, nsec)
        payload += struct.pack("<I", len(fid)) + fid
        payload += struct.pack("<4d", qx, qy, qz, qw) + b"\0" * 72
        payload += struct.pack("<3d", *ang_vel) + b"\0" * 72
        payload += struct.pack("<3d", *lin_accel) + b"\0" * 72
        self.write_raw(topic, "sensor_msgs/Imu",
                       "6a62c6daae103f4ff57a132d6f95cec2", stamp, payload)

    def write_pointcloud2(self, topic, stamp, xyz, point_time_ns=None,
                          frame_id="lidar"):
        """xyz (N,3) f32; optional per-point uint32 ns offsets ('t' field,
        Ouster convention)."""
        xyz = np.asarray(xyz, np.float32)
        n = len(xyz)
        fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1)]
        step = 12
        if point_time_ns is not None:
            fields.append(("t", 12, 6, 1))
            step = 16
        fid = frame_id.encode()
        sec = int(stamp)
        nsec = int(round((stamp - sec) * 1e9))
        payload = struct.pack("<III", 0, sec, nsec)
        payload += struct.pack("<I", len(fid)) + fid
        payload += struct.pack("<II", 1, n)           # height, width
        payload += struct.pack("<I", len(fields))
        for name, foff, dt, cnt in fields:
            nb = name.encode()
            payload += struct.pack("<I", len(nb)) + nb
            payload += struct.pack("<IBI", foff, dt, cnt)
        payload += struct.pack("<B", 0)               # is_bigendian
        payload += struct.pack("<II", step, step * n)
        buf = np.zeros((n, step), np.uint8)
        buf[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
        if point_time_ns is not None:
            buf[:, 12:16] = np.asarray(point_time_ns, np.uint32).reshape(
                n, 1).view(np.uint8).reshape(n, 4)
        payload += struct.pack("<I", step * n) + buf.tobytes()
        payload += struct.pack("<B", 1)               # is_dense
        self.write_raw(topic, "sensor_msgs/PointCloud2",
                       "1158d486dd51d683ce2f1be655c3c181", stamp, payload)

    def write_odometry(self, topic, stamp, p, q_wxyz, frame_id="map",
                       child_frame_id="base_link"):
        """nav_msgs/Odometry (pose only; twist/covariances zero) — the
        ground-truth export record of the reference's SaveRosbag
        (file_player ROSThread.cpp:743-780: global_pose.csv rows -> /gt)."""
        fid = frame_id.encode()
        cid = child_frame_id.encode()
        qw, qx, qy, qz = q_wxyz
        sec = int(stamp)
        nsec = int(round((stamp - sec) * 1e9))
        payload = struct.pack("<III", 0, sec, nsec)
        payload += struct.pack("<I", len(fid)) + fid
        payload += struct.pack("<I", len(cid)) + cid
        payload += struct.pack("<3d", *p)
        payload += struct.pack("<4d", qx, qy, qz, qw)
        payload += b"\0" * (36 * 8)                   # pose covariance
        payload += struct.pack("<6d", 0, 0, 0, 0, 0, 0)
        payload += b"\0" * (36 * 8)                   # twist covariance
        self.write_raw(topic, "nav_msgs/Odometry",
                       "cd5e73d190d741a2f92e81eda573aca7", stamp, payload)

    def write_image(self, topic, stamp, img, frame_id="radar"):
        """sensor_msgs/Image from a (H, W) uint8/uint16 array (mono8 /
        mono16) — the radar-polar export record (ROSThread.cpp:704-741)."""
        img = np.asarray(img)
        assert img.ndim == 2 and img.dtype in (np.uint8, np.uint16)
        enc = b"mono8" if img.dtype == np.uint8 else b"mono16"
        h, w = img.shape
        step = w * img.itemsize
        fid = frame_id.encode()
        sec = int(stamp)
        nsec = int(round((stamp - sec) * 1e9))
        payload = struct.pack("<III", 0, sec, nsec)
        payload += struct.pack("<I", len(fid)) + fid
        payload += struct.pack("<II", h, w)
        payload += struct.pack("<I", len(enc)) + enc
        payload += struct.pack("<BI", 0, step)        # little-endian, step
        data = img.tobytes()
        payload += struct.pack("<I", len(data)) + data
        self.write_raw(topic, "sensor_msgs/Image",
                       "060021388200f6f0f447d0fcd9c64743", stamp, payload)

    def close(self) -> None:
        chunk = b"".join(self._conn_records) + b"".join(self._msgs)
        raw_size = len(chunk)
        if self.compression == "bz2":
            chunk = bz2.compress(chunk)
        elif self.compression == "lz4":
            from noetic_slam_tpu_torch.utils import lz4frame

            chunk = lz4frame.compress(chunk)
        with open(self.path, "wb") as f:
            f.write(_MAGIC)
            f.write(_mk_record(
                {"op": bytes([OP_BAG_HEADER]),
                 "index_pos": struct.pack("<Q", 0),
                 "conn_count": struct.pack("<I", len(self._conns)),
                 "chunk_count": struct.pack("<I", 1)},
                b"\x20" * 4096))
            f.write(_mk_record(
                {"op": bytes([OP_CHUNK]),
                 "compression": self.compression.encode(),
                 "size": struct.pack("<I", raw_size)}, chunk))


def replay_bag(path: str, pipeline, pointcloud_topic=None, imu_topic=None,
               max_scans=None, tsdf_integrator=None) -> dict:
    """Drive an OdometryPipeline/SlamSystem from a bag (the
    rosbag-replay.sh role). Handles Hesai absolute timestamps by rebasing
    to the scan stamp."""
    from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu

    n_scans = n_imu = 0
    pending = None
    for kind, msg in read_lidar_imu(path, pointcloud_topic, imu_topic):
        if kind == "imu":
            pipeline.push_imu(msg["stamp"], msg["ang_vel"], msg["lin_accel"])
            n_imu += 1
            if pending is not None and pipeline.calibrated:
                try:
                    out = pipeline.process_scan(*pending)
                    if tsdf_integrator is not None:
                        tsdf_integrator(out)
                    n_scans += 1
                    pending = None
                except NeedMoreImu:
                    pass
        else:
            if not pipeline.calibrated:
                continue
            args = (msg["stamp"], msg["xyz"], msg["point_time"])
            try:
                out = pipeline.process_scan(*args)
                if tsdf_integrator is not None:
                    tsdf_integrator(out)
                n_scans += 1
            except NeedMoreImu:
                pending = args
        if max_scans is not None and n_scans >= max_scans:
            break
    return {"n_scans": n_scans, "n_imu": n_imu}
