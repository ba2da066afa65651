"""Checkpoint/resume of the full SLAM state (port of
``noetic_slam_tpu.runtime.checkpoint``).

The same on-disk layout as the JAX module, so that a checkpoint written by
either package loads in the other: one compressed ``.npz`` with keys
``odom/<field>``, ``tsdf/<field>`` (whichever dense map is active: the
``tsdf/logodds`` key marks the occupancy backend), ``graph/<field>``,
``host/json`` (the host bookkeeping as UTF-8 JSON bytes) and
``extra/<name>`` (host arrays such as the keyframe archive). Fields are
matched by name, the grid-NN index of ``nn_engine="grid"`` among them.
Tensors load onto the caller's device.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from noetic_slam_tpu_torch.models.occupancy import OccupancyState
from noetic_slam_tpu_torch.models.odometry import OdomState, init_state
from noetic_slam_tpu_torch.models.posegraph import PoseGraph
from noetic_slam_tpu_torch.models.tsdf import TsdfState
from noetic_slam_tpu_torch.utils.host import to_host


def _pack(prefix: str, tree, out: dict) -> None:
    if tree is None:
        return
    for name, arr in zip(type(tree)._fields, to_host(*tree)):
        out[f"{prefix}/{name}"] = arr


def _unpack(prefix: str, cls, data, device, defaults=None
            ) -> Optional[object]:
    """Rebuild one state from the flat archive. Fields absent from the
    file fall back to ``defaults`` (an init-shaped instance of ``cls``)
    when given; otherwise they are reported by name."""
    if not any(k.startswith(prefix + "/") for k in data.files):
        return None
    fields, missing = {}, []
    for name in cls._fields:
        key = f"{prefix}/{name}"
        if key in data.files:
            fields[name] = torch.from_numpy(np.array(data[key])).to(device)
        elif defaults is not None:
            fields[name] = getattr(defaults, name)
        else:
            missing.append(name)
    if missing:
        raise ValueError(
            f"checkpoint is missing {prefix} fields {missing}: load it "
            f"through load_pipeline (which fills init-shaped defaults) or "
            f"re-create it")
    return cls(**fields)


def save_checkpoint(path: str, odom_state: OdomState, tsdf_state=None,
                    graph: PoseGraph | None = None, host: dict | None = None,
                    arrays: dict | None = None) -> None:
    """``arrays``: extra named host arrays saved under ``extra/<name>``."""
    out: dict = {}
    _pack("odom", odom_state, out)
    _pack("tsdf", tsdf_state, out)
    _pack("graph", graph, out)
    if host:
        out["host/json"] = np.frombuffer(json.dumps(host).encode(),
                                         dtype=np.uint8)
    for name, arr in (arrays or {}).items():
        out[f"extra/{name}"] = np.asarray(arr)
    np.savez_compressed(path, **out)


def load_checkpoint(path: str, device, odom_defaults: OdomState | None = None):
    """(odom_state, map_state | None, graph | None, host dict), tensors on
    ``device``. The map's class follows the payload field present
    (``logodds`` -> OccupancyState, else TsdfState)."""
    with np.load(path, allow_pickle=False) as data:
        odom = _unpack("odom", OdomState, data, device, odom_defaults)
        map_cls = (OccupancyState if "tsdf/logodds" in data.files
                   else TsdfState)
        tsdf = _unpack("tsdf", map_cls, data, device)
        graph = _unpack("graph", PoseGraph, data, device)
        host = {}
        if "host/json" in data.files:
            host = json.loads(bytes(data["host/json"]).decode())
    return odom, tsdf, graph, host


def load_extra_arrays(path: str) -> dict:
    """The ``extra/<name>`` host arrays of a checkpoint (empty if none)."""
    with np.load(path, allow_pickle=False) as data:
        return {k[len("extra/"):]: data[k] for k in data.files
                if k.startswith("extra/")}


def save_pipeline(path: str, pipeline, tsdf_state=None, graph=None,
                  extra_host: dict | None = None,
                  extra_arrays: dict | None = None) -> None:
    """Checkpoint an OdometryPipeline (+ optional map/graph) with its host
    bookkeeping so a replay can resume mid-sequence."""
    host = {
        "prev_header": pipeline.prev_header,
        "headers": pipeline.headers,
        "first_scan_stamp": pipeline.first_scan_stamp,
        "flushed_scans": pipeline._flushed_scans,
        "calibrated": pipeline.calibrated,
        "imu_stamps": np.asarray(pipeline._imu_stamps).tolist(),
        "imu_ang": np.asarray(pipeline._imu_ang).tolist(),
        "imu_acc": np.asarray(pipeline._imu_acc).tolist(),
    }
    if extra_host:
        host.update(extra_host)
    save_checkpoint(path, pipeline.state, tsdf_state, graph, host,
                    arrays=extra_arrays)


def load_pipeline(path: str, pipeline):
    """Restore a checkpoint into an OdometryPipeline built with the same
    config, on its device. Returns (map_state | None, graph | None).
    Fields the file predates restore to init defaults."""
    odom, tsdf, graph, host = load_checkpoint(
        path, pipeline.device,
        odom_defaults=init_state(pipeline.cfg, pipeline.device))
    pipeline.state = odom
    pipeline.prev_header = host.get("prev_header")
    pipeline.headers = list(host.get("headers", []))
    pipeline.first_scan_stamp = host.get("first_scan_stamp")
    pipeline._flushed_scans = int(host.get("flushed_scans", 0))
    pipeline.calibrated = bool(host.get("calibrated", True))
    pipeline._imu_stamps = np.asarray(host.get("imu_stamps", []), np.float64)
    pipeline._imu_ang = np.asarray(host.get("imu_ang", []),
                                   np.float64).reshape(-1, 3)
    pipeline._imu_acc = np.asarray(host.get("imu_acc", []),
                                   np.float64).reshape(-1, 3)
    return tsdf, graph
