"""Sensor HTTP configuration client (no hardware required to test).

Re-implements the ouster-sdk's sensor HTTP interface
(ouster_client/src/sensor_http_imp.cpp:9-93, sensor_http.cpp:17-59) with
urllib — the configuration path of the driver nodelet (metadata fetch,
staged-config set, reinitialize/save) against the sensor's REST API:

- ``GET api/v1/system/firmware``                      firmware version
- ``GET api/v1/sensor/metadata[/<section>]``          metadata JSON
- ``GET api/v1/sensor/cmd/get_config_param?args=...`` active|staged config
- ``GET api/v1/sensor/cmd/set_config_param?args=k+v`` stage one param
- ``GET api/v1/sensor/cmd/reinitialize``              activate staged
- ``GET api/v1/sensor/cmd/save_config_params``        persist active
- ``GET api/v1/sensor/cmd/set_udp_dest_auto``         auto udp_dest

``configure_sensor`` composes them like sensor::set_config /
OusterSensor::configure_sensor: stage the differing params, reinitialize,
optionally persist. FW < 2.1 (TCP-only config, sensor_http.cpp:50-53) is
rejected like the SDK rejects FW < 2.0.

The port's own copy of ``noetic_slam_tpu.io.sensor_http`` (it imports
nothing of the JAX package): ``SensorInfo`` comes from the port's
``io.ouster``. ``tests/test_torch_live.py`` holds it to the original.
"""

from __future__ import annotations

import json
import re
import urllib.parse
import urllib.request
from typing import Optional

from noetic_slam_tpu_torch.io.ouster import SensorInfo


class SensorHttpError(RuntimeError):
    pass


class SensorHttp:
    """Minimal HTTP client for the sensor REST API."""

    def __init__(self, hostname: str, timeout_s: float = 10.0,
                 port: Optional[int] = None):
        netloc = hostname if port is None else f"{hostname}:{port}"
        self.base = f"http://{netloc}/"
        self.timeout = timeout_s

    # -- transport ---------------------------------------------------------
    def get(self, url: str) -> str:
        try:
            with urllib.request.urlopen(self.base + url,
                                        timeout=self.timeout) as r:
                return r.read().decode()
        except OSError as e:
            raise SensorHttpError(f"GET {url}: {e}") from e

    def get_json(self, url: str):
        text = self.get(url)
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise SensorHttpError(f"GET {url}: bad JSON {text[:80]!r}") from e

    def _execute(self, url: str, validation: str) -> None:
        result = self.get(url)
        if result != validation:
            raise SensorHttpError(
                f"{url}: unexpected response {result[:80]!r}")

    # -- endpoints (sensor_http_imp.cpp) ------------------------------------
    def firmware_version_string(self) -> str:
        return self.get("api/v1/system/firmware")

    def firmware_version(self) -> tuple:
        """(major, minor, patch) parsed from e.g.
        '{"fw": "ousteros-image-prod-aries-v2.4.0"}' or a bare string."""
        text = self.firmware_version_string()
        m = re.search(r"v?(\d+)\.(\d+)\.?(\d+)?", text)
        if not m:
            raise SensorHttpError(f"unparseable firmware {text[:80]!r}")
        return (int(m.group(1)), int(m.group(2)), int(m.group(3) or 0))

    def metadata(self) -> dict:
        return self.get_json("api/v1/sensor/metadata")

    def sensor_info(self) -> dict:
        return self.get_json("api/v1/sensor/metadata/sensor_info")

    def beam_intrinsics(self) -> dict:
        return self.get_json("api/v1/sensor/metadata/beam_intrinsics")

    def imu_intrinsics(self) -> dict:
        return self.get_json("api/v1/sensor/metadata/imu_intrinsics")

    def lidar_intrinsics(self) -> dict:
        return self.get_json("api/v1/sensor/metadata/lidar_intrinsics")

    def lidar_data_format(self) -> dict:
        return self.get_json("api/v1/sensor/metadata/lidar_data_format")

    def calibration_status(self) -> dict:
        return self.get_json("api/v1/sensor/metadata/calibration_status")

    def get_config_params(self, active: bool = True) -> dict:
        which = "active" if active else "staged"
        return self.get_json(
            f"api/v1/sensor/cmd/get_config_param?args={which}")

    def set_config_param(self, key: str, value) -> None:
        encoded = urllib.parse.quote(
            value if isinstance(value, str) else json.dumps(value))
        self._execute(
            f"api/v1/sensor/cmd/set_config_param?args={key}+{encoded}",
            '"set_config_param"')

    def set_udp_dest_auto(self) -> None:
        self._execute("api/v1/sensor/cmd/set_udp_dest_auto", "{}")

    def reinitialize(self) -> None:
        self._execute("api/v1/sensor/cmd/reinitialize", "{}")

    def save_config_params(self) -> None:
        self._execute("api/v1/sensor/cmd/save_config_params", "{}")


def fetch_metadata(hostname: str, **kw) -> SensorInfo:
    """Full metadata -> SensorInfo (the nodelet's startup metadata fetch,
    os_sensor_nodelet.cpp onInit)."""
    http = SensorHttp(hostname, **kw)
    return SensorInfo.from_json(json.dumps(http.metadata()))


def configure_sensor(hostname: str, config: dict, persist: bool = False,
                     udp_dest_auto: bool = False, **kw) -> dict:
    """Stage differing params, reinitialize, optionally persist
    (sensor::set_config flow). Returns the resulting active config."""
    http = SensorHttp(hostname, **kw)
    fw = http.firmware_version()
    if fw < (2, 1):
        raise SensorHttpError(
            f"firmware {fw} requires the TCP config path (unsupported); "
            "upgrade to FW >= 2.1")
    if udp_dest_auto:
        if "udp_dest" in config:
            raise ValueError("udp_dest_auto with explicit udp_dest")
        http.set_udp_dest_auto()
    staged = http.get_config_params(active=False)
    for key, value in config.items():
        if staged.get(key) != value:
            http.set_config_param(key, value)
    http.reinitialize()
    if persist:
        http.save_config_params()
    return http.get_config_params(active=True)
