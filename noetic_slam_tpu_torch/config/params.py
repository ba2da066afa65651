"""Typed configuration surface of the framework.

The port's own copy of ``noetic_slam_tpu/config/params.py`` (the port
imports nothing of the JAX package); ``tests/test_torch_copies.py`` holds
the two to the same fields, defaults and loaded values.

This is the re-design of the reference's layered rosparam config
(reference src/dlio/cfg/dlio.yaml:1-45, src/dlio/cfg/params.yaml:1-65, read by
src/dlio/src/dlio/odom.cc:165-302). Every tunable the reference exposes has a
field here with the same default; TPU-specific capacity/padding policies live
in ``CapacityConfig`` (the reference has dynamic containers instead).

Configs are frozen dataclasses so they can be closed over by jitted functions
as static values; ``load_config`` layers YAML overrides onto the defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ImuConfig:
    """IMU intrinsics + calibration (dlio.yaml imu section; odom.cc:191-250)."""
    calibrate_gyro: bool = True
    calibrate_accel: bool = True
    approximate_gravity: bool = False
    gravity_align: bool = True
    calib_time: float = 3.0            # seconds of static calibration
    buffer_size: int = 5000            # reference circular buffer depth
    accel_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    gyro_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Row-major 3x3 accel scale/misalignment matrix (odom.cc:224-238).
    accel_sm: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


@dataclass(frozen=True)
class ExtrinsicsConfig:
    """baselink<-imu / baselink<-lidar extrinsics (dlio.yaml; odom.cc:252-302)."""
    baselink2imu_t: Tuple[float, float, float] = (0.006253, -0.011775, 0.007645)
    baselink2imu_R: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    baselink2lidar_t: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    baselink2lidar_R: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


@dataclass(frozen=True)
class PreprocConfig:
    """Scan preprocessing (params.yaml preprocessing; odom.cc:178-189)."""
    deskew: bool = True
    crop_size: float = 1.0             # crop-box half-extent around sensor [m]
    voxelize: bool = True
    voxel_res: float = 0.25            # voxel-grid leaf size [m]
    quantized_wire: bool = True        # int16+f16 host->device scan format
                                       # (adaptive scale, <=2 mm worst-case;
                                       # False -> exact float32)


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframing thresholds (params.yaml keyframe; odom.cc:154-156)."""
    thresh_dist: float = 1.0           # [m], adaptive when adaptive=True
    thresh_rot: float = 45.0           # [deg]


@dataclass(frozen=True)
class SubmapConfig:
    """Submap keyframe selection (params.yaml submap; odom.cc:158-161)."""
    knn: int = 10
    kcv: int = 10                      # convex-hull kNN
    kcc: int = 10                      # concave-hull kNN


@dataclass(frozen=True)
class GicpConfig:
    """GICP + LM solver (params.yaml gicp; odom.cc:263-280)."""
    min_num_points: int = 64
    k_correspondences: int = 16
    max_corr_dist: float = 0.5
    max_iterations: int = 32
    transformation_epsilon: float = 0.01
    rotation_epsilon: float = 0.01
    init_lambda_factor: float = 1e-9
    lm_max_iterations: int = 10        # inner LM lambda-search iterations
    # NN engine for correspondences/covariances: "brute" = tiled MXU
    # brute force (fastest on TPU: contiguous compute beats random gathers);
    # "grid" = bucketed grid index (fastest on CPU / very large targets).
    nn_engine: str = "brute"
    # Covariance estimator: "radius" = Gaussian radius-weighted moments via
    # matmuls (3x faster on TPU; identical normals, hence identical PLANE-
    # regularized covariances); "knn" = the reference's exact k-NN
    # neighborhoods (nano_gicp.cc:330-392).
    cov_engine: str = "radius"
    cov_radius: float = 0.5            # [m] neighborhood radius for "radius"
    # Per-scan registration sanity bound [m]: a scan-to-map correction
    # beyond this is a degenerate-geometry failure (on feature-poor
    # stretches the GICP cost is flat along the ground plane and LM can
    # slide meters sideways in one solve — measured 13-40 m/s estimate
    # jumps, then an observer velocity runaway to NaN), not information.
    # The step falls back to the IMU prior for that scan (the reference's
    # prior-only degradation role, odom.cc:677-685). At 10 Hz the honest
    # correction is centimeters; 1.0 m is ~100x margin. <= 0 disables.
    max_correction: float = 1.0


@dataclass(frozen=True)
class GeoConfig:
    """Geometric observer gains (params.yaml geo; odom.cc:282-291)."""
    Kp: float = 4.5
    Kv: float = 11.25
    Kq: float = 4.0
    Kab: float = 2.25
    Kgb: float = 1.0
    abias_max: float = 5.0
    gbias_max: float = 0.5
    # Observer velocity clamp [m/s]: with registration feedback lost
    # (degenerate geometry rejecting every scan via gicp.max_correction),
    # the velocity would integrate accel error unboundedly (measured: an
    # 80 m/s glide into km-scale estimate excursions). The clamp bounds
    # the failure radius so place recognition can still recover the pose.
    # <= 0 disables. The reference has no equivalent (its analogous
    # failure is unbounded).
    max_velocity: float = 30.0


@dataclass(frozen=True)
class MapConfig:
    """Sparse keyframe map node behavior (params.yaml map; map.cc:20-40)."""
    dense_filtered: bool = False
    sparse_frequency: float = 1.0
    sparse_leaf_size: float = 0.25
    wait_until_move: bool = True


@dataclass(frozen=True)
class TsdfConfig:
    """CHAD/Voxblox-class TSDF fusion backend (absent from the reference
    checkout — designed from the published behavior the README describes;
    data contract: world-frame deskewed clouds, cf. dliomapping.cpp:44)."""
    voxel_size: float = 0.1            # [m]
    block_size: int = 8                # voxels per block edge (8^3 blocks)
    truncation: float = 0.3            # truncation distance [m]
    max_weight: float = 100.0
    max_blocks: int = 65536            # capacity of the block hash table
    max_range: float = 60.0            # integration range clip [m]
    space_carving: bool = True         # integrate free-space samples along rays
    carving_samples: int = 16          # free-space samples per ray
    scan_block_cap: int = 4096         # max distinct blocks touched per scan
                                       # (per-scan work buffer; overflow
                                       # blocks are dropped and counted.
                                       # Kernel grid cost ~0.24 us/entry —
                                       # raise for long-range outdoor
                                       # carving, lower for indoor)


@dataclass(frozen=True)
class OccupancyConfig:
    """Octomap-class occupancy backend (the reference README's map-backend
    alternative to TSDF, README.md:30-40; package absent from the checkout).
    Inverse sensor model defaults = Octomap's (hit 0.7 -> L 0.85, miss 0.4
    -> L -0.4, clamps [0.12, 0.97] -> L [-2.0, 3.5])."""
    voxel_size: float = 0.1
    l_hit: float = 0.85
    l_miss: float = -0.4
    l_min: float = -2.0
    l_max: float = 3.5
    occ_thresh: float = 0.0            # occupied iff L > this (p > 0.5)
    max_range: float = 60.0
    miss_samples: int = 24             # free-space samples per ray
    max_blocks: int = 65536
    scan_block_cap: int = 4096


@dataclass(frozen=True)
class CapacityConfig:
    """Static-shape capacities (TPU padding policy; no reference equivalent —
    the reference uses dynamic std/PCL containers)."""
    max_points: int = 32768            # raw scan capacity after intake
    max_ds_points: int = 8192          # after voxel downsample (GICP source)
    max_deskew_frames: int = 2048      # unique-timestamp frames per sweep
    max_imu_window: int = 256          # IMU samples spanning one sweep
    max_keyframes: int = 512           # keyframe store capacity
    max_kf_points: int = 4096          # points stored per keyframe
    max_submap_kf: int = 32            # keyframes per submap (knn+kcv+kcc+pad)
    # submap point capacity = max_submap_kf * max_kf_points
    max_trajectory: int = 16384        # device trajectory ring (flush before
                                       # this many processed scans)
    outbox_slots: int = 64             # keyframe outbox ring (device->host
                                       # hand-off: every keyframe ever
                                       # created is written here regardless
                                       # of store eviction; the host must
                                       # sync at least once per this many
                                       # new keyframes for lossless
                                       # graph/archive accumulation)


@dataclass(frozen=True)
class DlioConfig:
    """Top-level config: the union of dlio.yaml + params.yaml surfaces."""
    version: str = "0.1.0"
    adaptive: bool = True
    gravity: float = 9.80665
    frames_odom: str = "odom"
    frames_baselink: str = "base_link"
    frames_lidar: str = "lidar"
    frames_imu: str = "imu"
    imu: ImuConfig = field(default_factory=ImuConfig)
    extrinsics: ExtrinsicsConfig = field(default_factory=ExtrinsicsConfig)
    preproc: PreprocConfig = field(default_factory=PreprocConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    submap: SubmapConfig = field(default_factory=SubmapConfig)
    gicp: GicpConfig = field(default_factory=GicpConfig)
    geo: GeoConfig = field(default_factory=GeoConfig)
    map: MapConfig = field(default_factory=MapConfig)
    # Dense-map backend selection (the reference README's MAP_BACKEND_IDX
    # role, README.md:30-40): "tsdf" (CHAD/Voxblox class) or "occupancy"
    # (Octomap class).
    map_backend: str = "tsdf"
    tsdf: TsdfConfig = field(default_factory=TsdfConfig)
    occupancy: OccupancyConfig = field(default_factory=OccupancyConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)

    def replace(self, **kw) -> "DlioConfig":
        return dataclasses.replace(self, **kw)


def _apply_overrides(obj, overrides: dict):
    kw = {}
    for k, v in overrides.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key {k!r} for {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kw[k] = _apply_overrides(cur, v)
        elif isinstance(v, list):
            kw[k] = tuple(v)
        else:
            kw[k] = v
    return dataclasses.replace(obj, **kw)


def load_config(path: str | None = None, overrides: dict | None = None) -> DlioConfig:
    """Build a DlioConfig from defaults, an optional YAML file, and overrides.

    YAML layout mirrors the dataclass tree, e.g.::

        gicp:
          max_corr_dist: 0.5
        capacity:
          max_points: 65536
    """
    cfg = DlioConfig()
    if path is not None:
        import yaml  # lazy: only needed when a file is given

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        cfg = _apply_overrides(cfg, data)
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    return cfg
