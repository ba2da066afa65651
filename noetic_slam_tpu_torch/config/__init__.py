"""The configuration surface: frozen dataclasses and ``load_config``
(``config.params``, the port's own copy of the JAX package's)."""

from noetic_slam_tpu_torch.config.params import (  # noqa: F401
    CapacityConfig,
    DlioConfig,
    ExtrinsicsConfig,
    GeoConfig,
    GicpConfig,
    ImuConfig,
    KeyframeConfig,
    MapConfig,
    OccupancyConfig,
    PreprocConfig,
    SubmapConfig,
    TsdfConfig,
    load_config,
)
