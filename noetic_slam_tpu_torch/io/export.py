"""Map/trajectory export: PLY, PCD, TUM trajectory.

The port's own copy of the writers of ``noetic_slam_tpu/io/export.py``
(numpy only); ``tests/test_torch_copies.py`` holds each to identical
bytes. ``export_mulran_bag`` waits for the port of the rosbag writer.

Covers the reference's map outputs:
- dliomapping's rolling PLY shards (src/dliomapping/dliomapping.cpp:64-86)
- the MapNode save_pcd service (src/dlio/src/dlio/map.cc:81-110,
  src/dlio/srv/save_pcd.srv) — voxel-downsampled PCD write
"""

from __future__ import annotations

import struct

import numpy as np


def write_ply(path: str, xyz: np.ndarray, intensity: np.ndarray | None = None,
              binary: bool = True) -> int:
    """Write a point cloud PLY (binary little-endian by default).

    Returns the number of points written.
    """
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    props = ["property float x", "property float y", "property float z"]
    cols = [xyz]
    if intensity is not None:
        props.append("property float intensity")
        cols.append(np.asarray(intensity, np.float32).reshape(-1, 1))
    data = np.hstack(cols).astype("<f4")

    fmt = "binary_little_endian" if binary else "ascii"
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {n}\n"
              + "\n".join(props) + "\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")
    return n


def write_ply_mesh(path: str, vertices: np.ndarray,
                   faces: np.ndarray) -> int:
    """Write a triangle mesh PLY (binary). Returns the face count."""
    vertices = np.asarray(vertices, "<f4")
    faces = np.asarray(faces, "<i4")
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(vertices)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(faces)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(vertices.tobytes())
        body = b"".join(
            struct.pack("<B3i", 3, *face) for face in faces)
        f.write(body)
    return len(faces)


def write_pcd(path: str, xyz: np.ndarray,
              intensity: np.ndarray | None = None) -> int:
    """Binary PCD v0.7 writer (pcl::io::savePCDFileBinary equivalent,
    map.cc:104)."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    fields = "x y z" + (" intensity" if intensity is not None else "")
    count = 4 if intensity is not None else 3
    header = ("# .PCD v0.7 - Point Cloud Data file format\n"
              "VERSION 0.7\n"
              f"FIELDS {fields}\n"
              f"SIZE {' '.join(['4'] * count)}\n"
              f"TYPE {' '.join(['F'] * count)}\n"
              f"COUNT {' '.join(['1'] * count)}\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {n}\nDATA binary\n")
    cols = [xyz]
    if intensity is not None:
        cols.append(np.asarray(intensity, np.float32).reshape(-1, 1))
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.hstack(cols).astype("<f4").tobytes())
    return n


def read_ply(path: str) -> np.ndarray:
    """Minimal binary/ascii PLY point reader (for tests/round-trips)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode().splitlines()
        n = next(int(l.split()[-1]) for l in lines
                 if l.startswith("element vertex"))
        props = [l.split()[-1] for l in lines if l.startswith("property float")]
        binary = any("binary" in l for l in lines)
        if binary:
            data = np.frombuffer(f.read(n * 4 * len(props)),
                                 dtype="<f4").reshape(n, len(props))
        else:
            data = np.loadtxt(f, max_rows=n).reshape(n, len(props))
    return data


def write_tum_trajectory(path: str, traj: np.ndarray) -> int:
    """TUM format: stamp x y z qx qy qz qw (traj rows: stamp p(3) q_wxyz(4))."""
    traj = np.asarray(traj)
    out = np.column_stack([traj[:, 0], traj[:, 1:4],
                           traj[:, 5:8], traj[:, 4]])
    np.savetxt(path, out, fmt="%.9f")
    return len(out)
