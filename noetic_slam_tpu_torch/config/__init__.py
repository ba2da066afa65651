"""The configuration surface. The JAX package's ``config.params`` is pure
Python (frozen dataclasses), so the port shares it rather than copying it."""

from noetic_slam_tpu.config.params import (  # noqa: F401
    CapacityConfig,
    DlioConfig,
    ExtrinsicsConfig,
    GeoConfig,
    GicpConfig,
    ImuConfig,
    KeyframeConfig,
    MapConfig,
    PreprocConfig,
    SubmapConfig,
    TsdfConfig,
    load_config,
)
