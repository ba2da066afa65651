"""The port's live path on the CPU: the sensor HTTP client
(``io.sensor_http``) against a mock of the sensor's REST API, the live
driver (``runtime.live.LiveDriver``) over loopback UDP in its three stamp
modes with its self-reset and escalation, the interactive player's
controls (``io.player``), a 16 x 512 capture streamed over loopback into
the port's ``LiveDriver`` + ``SlamSystem(device="cpu")`` and into JAX's
(the same frames; poses within 5 cm at every stamp both processed), and
``cli live`` / ``cli player`` with ``--device cpu`` (the player's
trajectory held to the JAX CLI's).

The three modules are the port's own copies of numpy-only JAX modules:
each differs from its original only in the imports it rewires to the port,
and the live driver also in the frame it holds for its IMU.

UDP ports: 47971-47990, none shared with another test file (the JAX tests
bind 47857-47861, 47901-47916 and 47951)."""

import ast
import contextlib
import io
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch
import yaml

from noetic_slam_tpu_torch.io import ouster as ou
from noetic_slam_tpu_torch.io import sensor_http as sh
from noetic_slam_tpu_torch.io.player import InteractivePlayer
from noetic_slam_tpu_torch.runtime import native
from noetic_slam_tpu_torch.utils import fixtures
from tests.test_ouster import _build_packet
from tests.test_sensor_http import MockSensor, make_handler

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mulran_mini")
POSE_TOL = 0.05          # [m] per pose over a replay (ROADMAP Rules)
# the step at bench.py's whole-system capacities (8,192 points, 4,096
# kept, 16 submap keyframes; also scripts/bench_batch.py's), with a small
# TSDF (the live command fuses the map). At tests/test_torch_cli.py's
# 2,048 kept points the streamed capture is ill-conditioned near its end:
# JAX against itself, with 1 mm on one point of one scan, ends 4.9 cm
# apart (PERF.md section 6; scripts/torch_entry_parity.py).
LIVE_CFG = {"capacity": {
    "max_points": 8192, "max_ds_points": 4096, "max_deskew_frames": 1024,
    "max_imu_window": 128, "max_keyframes": 64, "max_submap_kf": 16,
    "max_trajectory": 512}, "tsdf": {"max_blocks": 8192}}


def _native_or_skip():
    if native.load() is None:
        pytest.skip("native toolchain unavailable")


# ---------------------------------------------------------------------------
# The copies
# ---------------------------------------------------------------------------

def _normalised(path):
    """The module's AST without its docstring, every import of the port's
    package written as the JAX package's."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    body = tree.body
    if isinstance(body[0], ast.Expr) and isinstance(body[0].value,
                                                    ast.Constant):
        body = body[1:]
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace("noetic_slam_tpu_torch",
                                              "noetic_slam_tpu")
    return [ast.dump(n) for n in body]


@pytest.mark.parametrize("rel", ["io/sensor_http.py", "io/player.py"])
def test_copy_differs_from_the_original_only_in_imports(rel):
    assert (_normalised(f"noetic_slam_tpu_torch/{rel}")
            == _normalised(f"noetic_slam_tpu/{rel}"))


def test_live_copy_departs_only_in_the_held_frame():
    """``runtime/live.py`` equals its original apart from the imports and
    the held frame (``__init__``'s counters, ``poll_once``'s retry,
    ``_process_frame`` / ``_submit``)."""
    changed = {"__init__", "poll_once", "_process_frame", "_submit"}

    def split(rel):
        tree = ast.parse(open(os.path.join(REPO, rel)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                node.module = node.module.replace("noetic_slam_tpu_torch",
                                                  "noetic_slam_tpu")
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef))
        methods = {m.name: ast.dump(m) for m in cls.body
                   if isinstance(m, ast.FunctionDef)
                   and m.name not in changed}
        rest = [ast.dump(n) for n in tree.body[1:]
                if not isinstance(n, (ast.ClassDef, ast.ImportFrom))]
        return methods, rest

    port, ref = (split(f"{pkg}/runtime/live.py")
                 for pkg in ("noetic_slam_tpu_torch", "noetic_slam_tpu"))
    assert port == ref
    assert set(port[0]) == {"_attempt_reset", "run", "close"}


# ---------------------------------------------------------------------------
# sensor_http against the mock sensor of tests/test_sensor_http.py
# ---------------------------------------------------------------------------

@pytest.fixture
def mock_sensor():
    from http.server import HTTPServer

    sensor = MockSensor()
    srv = HTTPServer(("127.0.0.1", 0), make_handler(sensor))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield sensor, srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def test_firmware_and_metadata(mock_sensor):
    sensor, port = mock_sensor
    http = sh.SensorHttp("127.0.0.1", port=port)
    assert http.firmware_version() == (2, 4, 0)
    assert http.metadata()["sensor_info"]["prod_sn"] == "99201234"
    assert http.lidar_data_format()["pixels_per_column"] == 32
    assert http.beam_intrinsics()["lidar_origin_to_beam_origin_mm"] > 0


def test_fetch_metadata_equals_jax(mock_sensor):
    from noetic_slam_tpu.io import sensor_http as jsh

    sensor, port = mock_sensor
    info = sh.fetch_metadata("127.0.0.1", port=port)
    assert isinstance(info, ou.SensorInfo)
    assert info.pixels_per_column == 32 and info.columns_per_frame == 1024
    assert info.udp_profile_lidar == "RNG19_RFL8_SIG16_NIR16"
    assert info.beam_to_lidar[0, 3] == pytest.approx(15.806)
    ref = jsh.fetch_metadata("127.0.0.1", port=port)
    assert info.to_json() == ref.to_json()


def test_configure_sensor_flow(mock_sensor):
    sensor, port = mock_sensor
    active = sh.configure_sensor(
        "127.0.0.1", {"lidar_mode": "2048x10", "udp_port_lidar": 7502,
                      "timestamp_mode": "TIME_FROM_PTP_1588"},
        persist=True, port=port)
    assert active["lidar_mode"] == "2048x10"
    assert active["timestamp_mode"] == "TIME_FROM_PTP_1588"
    assert sensor.reinit_count == 1 and sensor.saved


def test_configure_rejects_old_firmware(mock_sensor):
    sensor, port = mock_sensor
    sensor.fw = "ousteros-image-prod-aries-v2.0.9"
    with pytest.raises(sh.SensorHttpError, match="TCP config path"):
        sh.configure_sensor("127.0.0.1", {}, port=port)


def test_set_udp_dest_auto_conflict(mock_sensor):
    sensor, port = mock_sensor
    with pytest.raises(ValueError):
        sh.configure_sensor("127.0.0.1", {"udp_dest": "10.0.0.1"},
                            udp_dest_auto=True, port=port)
    active = sh.configure_sensor("127.0.0.1", {}, udp_dest_auto=True,
                                 port=port)
    assert active["udp_dest"] == "169.254.0.1"


# ---------------------------------------------------------------------------
# LiveDriver over loopback UDP (tests/test_pcap_live.py:81-192)
# ---------------------------------------------------------------------------

def _simple_info(h=4, w=32):
    return ou.SensorInfo(
        pixels_per_column=h, columns_per_frame=w, columns_per_packet=8,
        pixel_shift_by_row=np.zeros(h, int),
        beam_azimuth_angles=np.zeros(h),
        beam_altitude_angles=np.linspace(-10, 10, h),
        beam_to_lidar=np.eye(4), lidar_to_sensor=np.eye(4),
        udp_profile_lidar=ou.PROFILE_SINGLE)


class _SinkSlam:
    def __init__(self):
        self.imu = []
        self.scans = []

    def push_imu(self, stamp, gyro, accel):
        self.imu.append(stamp)

    def process_scan(self, header, xyz, pt):
        self.scans.append((header, xyz, pt))


def _send_frames(info, port, base, rng, imu_ts):
    pf = ou.PacketFormat(info)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for f in range(2):
            for p in range(info.columns_per_frame // 8):
                m_ids = np.arange(p * 8, p * 8 + 8)
                ts = base * (f + 1) + m_ids.astype(np.uint64) * 1000
                pkt = _build_packet(pf, f, m_ids, ts,
                                    rng.integers(500, 60_000, size=(pf.h, 8)))
                tx.sendto(pkt, ("127.0.0.1", port))
        imu = bytearray(48)
        imu[0:8] = int(imu_ts).to_bytes(8, "little")
        imu[24:48] = np.zeros(6, np.float32).tobytes()
        tx.sendto(bytes(imu), ("127.0.0.1", port + 1))
    finally:
        tx.close()


def test_live_driver_over_udp(rng):
    """Packets over loopback: the driver batches frames (frame 0 completes
    when frame 1's first packet arrives) and pushes IMU into the sink."""
    _native_or_skip()
    from noetic_slam_tpu_torch.runtime.live import LiveDriver

    info = _simple_info()
    sink = _SinkSlam()
    drv = LiveDriver(sink, info, lidar_port=47971, imu_port=47972)
    try:
        _send_frames(info, 47971, 10 ** 9, rng, 0)
        time.sleep(0.3)
        for _ in range(20):
            drv.poll_once(timeout_ms=50)
        assert drv.n_scans >= 1 and len(sink.scans) >= 1
        assert len(sink.imu) == 1
        header, xyz, pt = sink.scans[0]
        assert xyz.shape == (4 * 32, 3) and pt.dtype == np.float64
    finally:
        drv.close()


@pytest.mark.parametrize("mode", ["sensor", "ptp", "host"])
def test_live_driver_timestamp_modes(rng, mode):
    """Sensor clock, PTP with the TAI offset, host receive time
    extrapolated to column 0 (lidar_packet_handler.h:111-128)."""
    _native_or_skip()
    from noetic_slam_tpu_torch.runtime.live import LiveDriver

    info = _simple_info()
    sink = _SinkSlam()
    port = {"sensor": 47973, "ptp": 47975, "host": 47977}[mode]
    drv = LiveDriver(sink, info, lidar_port=port, imu_port=port + 1,
                     timestamp_mode=mode, ptp_utc_tai_offset_s=-37.0)
    t_wall0 = time.time()
    base = 100_000_000_000
    try:
        _send_frames(info, port, base, rng, base + 500)
        time.sleep(0.3)
        for _ in range(30):
            drv.poll_once(timeout_ms=50)
        assert len(sink.scans) >= 1 and len(sink.imu) == 1
        header = sink.scans[0][0]
        if mode == "sensor":
            assert abs(header - base * 1e-9) < 1e-6
            assert abs(sink.imu[0] - (base + 500) * 1e-9) < 1e-9
        elif mode == "ptp":
            assert abs(header - (base * 1e-9 - 37.0)) < 1e-6
            assert abs(sink.imu[0] - ((base + 500) * 1e-9 - 37.0)) < 1e-9
        else:
            assert t_wall0 - 1.0 < header < time.time() + 1.0
    finally:
        drv.close()


def test_live_driver_drops_frames_before_the_imu_covers_them(rng):
    """A frame the port's ``SlamSystem`` refuses with ``NeedMoreImu``
    (here: IMU calibration still running) is dropped, not raised."""
    _native_or_skip()
    from noetic_slam_tpu_torch.runtime.live import LiveDriver
    from noetic_slam_tpu_torch.runtime.slam import SlamSystem

    info = _simple_info()
    slam = SlamSystem(enable_loop_closure=False, enable_tsdf=False,
                      device="cpu")
    drv = LiveDriver(slam, info, lidar_port=47979, imu_port=47980)
    try:
        _send_frames(info, 47979, 10 ** 9, rng, 0)
        time.sleep(0.3)
        for _ in range(20):
            drv.poll_once(timeout_ms=50)
        assert drv.n_imu == 1 and drv.n_scans == 0
        assert not slam.calibrated and len(slam.flush()) == 0
    finally:
        drv.close()


class _LateImuSlam:
    """Refuses a frame until an IMU sample past its header is in (the
    ``NeedMoreImu`` rule of the port's pipeline), calibrated from the
    first sample on."""

    def __init__(self):
        self.imu, self.scans, self.calibrated = [], [], False

    def push_imu(self, stamp, gyro, accel):
        self.imu.append(stamp)
        self.calibrated = True

    def process_scan(self, header, xyz, pt):
        from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu

        if not self.imu or self.imu[-1] < header:
            raise NeedMoreImu(header)
        self.scans.append(header)


def test_live_driver_holds_a_frame_until_its_imu(rng):
    """A frame refused for want of IMU after calibration is held and
    submitted after the next IMU drain; a newer frame replaces a held one;
    before calibration the frame is dropped."""
    from noetic_slam_tpu_torch.runtime.live import LiveDriver

    info = _simple_info()
    slam = _LateImuSlam()
    drv = LiveDriver.__new__(LiveDriver)       # no sockets: frames by hand
    drv.slam, drv.n_scans = slam, 0
    drv._held, drv.n_held, drv.n_refused = None, 0, 0
    xyz, pt = np.zeros((4, 3), np.float32), np.zeros(4)
    drv._submit(1.0, xyz, pt)                  # calibration hold: dropped
    assert (drv._held, drv.n_refused) == (None, 1)
    slam.push_imu(0.5, None, None)
    drv._submit(1.0, xyz, pt)                  # IMU short of it: held
    assert drv._held[0] == 1.0 and drv.n_held == 1
    drv._submit(*drv._held)                    # still short: stays held
    assert drv._held[0] == 1.0 and drv.n_held == 1 and slam.scans == []
    slam.push_imu(1.5, None, None)
    drv._submit(*drv._held)                    # covered now
    assert drv._held is None and slam.scans == [1.0] and drv.n_scans == 1
    drv._submit(2.0, xyz, pt)
    assert drv._held[0] == 2.0
    drv.direction, drv.offset = ou.make_xyz_lut(info)
    drv.timestamper = ou.ScanTimestamper(info, 0)
    drv.ptp_offset_ns = 0
    scan = ou.ScanBatcher(info)
    pf = ou.PacketFormat(info)
    for p in range(info.columns_per_frame // 8):
        m_ids = np.arange(p * 8, p * 8 + 8)
        scan.push(_build_packet(pf, 0, m_ids, 3 * 10 ** 9
                                + m_ids.astype(np.uint64) * 1000,
                                rng.integers(500, 60_000, size=(pf.h, 8))))
    drv._process_frame(scan.flush(), None)     # replaces the held frame
    assert drv.n_refused == 2 and drv._held[0] == pytest.approx(3.0)


def _tiny_info():
    h = 16
    return ou.SensorInfo(
        pixels_per_column=h, columns_per_frame=64, columns_per_packet=16,
        pixel_shift_by_row=np.zeros(h, int),
        beam_azimuth_angles=np.zeros(h), beam_altitude_angles=np.zeros(h),
        beam_to_lidar=np.eye(4), lidar_to_sensor=np.eye(4),
        udp_profile_lidar=ou.PROFILE_SINGLE, lidar_mode="512x10")


def test_live_driver_self_reset_then_escalate():
    """tests/test_live_extras.py:64-89: sustained loss resets the source
    (through the port's SensorHttp, best effort) until the resets run out,
    then raises."""
    _native_or_skip()
    from noetic_slam_tpu_torch.runtime.live import LiveDriver

    drv = LiveDriver(_SinkSlam(), _tiny_info(), lidar_port=47981,
                     imu_port=0, max_read_errors=2,
                     sensor_hostname="127.0.0.1:1",  # refused: best effort
                     max_resets=2)
    try:
        first_source = drv.source
        drv.poll_once(timeout_ms=1)
        drv.poll_once(timeout_ms=1)
        assert drv.n_resets == 1
        assert drv.source is not first_source
        with pytest.raises(TimeoutError):
            for _ in range(10):
                drv.poll_once(timeout_ms=1)
        assert drv.n_resets == 2
    finally:
        drv.close()


def test_live_driver_no_hostname_raises():
    _native_or_skip()
    from noetic_slam_tpu_torch.runtime.live import LiveDriver

    drv = LiveDriver(_SinkSlam(), _tiny_info(), lidar_port=47983,
                     imu_port=0, max_read_errors=2)
    try:
        with pytest.raises(TimeoutError):
            for _ in range(5):
                drv.poll_once(timeout_ms=1)
    finally:
        drv.close()


# ---------------------------------------------------------------------------
# The player's controls (tests/test_player.py)
# ---------------------------------------------------------------------------

class FakeDataset:
    def __init__(self, n=50, dt=0.01):
        self.stamps = np.arange(n) * dt

    def events(self):
        return iter([(float(t), "scan", i)
                     for i, t in enumerate(self.stamps)])


def _collect(ds, **kw):
    got = []
    return InteractivePlayer(ds, lambda s, k, i: got.append((s, k, i)),
                             **kw), got


def test_player_unpaced_dispatch_order():
    p, got = _collect(FakeDataset(), rate=0.0)
    assert p.run()["n_events"] == 50
    assert [g[2] for g in got] == list(range(50))


def test_player_pacing_speed():
    p, _ = _collect(FakeDataset(n=20, dt=0.01), rate=4.0)
    t0 = time.perf_counter()
    p.run()
    el = time.perf_counter() - t0
    assert 0.02 < el < 0.15                  # paced, faster than real time


def test_player_pause_resume_thread():
    p, got = _collect(FakeDataset(n=30, dt=0.02), rate=1.0)
    p.controls.paused = True
    during = []

    def driver():
        time.sleep(0.15)
        during.append(len(got))
        p.controls.rate = 64.0
        p.controls.toggle_pause()            # resume fast

    th = threading.Thread(target=driver)
    th.start()
    stats = p.run()
    th.join(timeout=30)
    assert not th.is_alive()
    assert during == [0] and stats["n_events"] == 30


def test_player_seek_slider():
    seeks = []
    p = InteractivePlayer(FakeDataset(n=100, dt=0.01), lambda s, k, i: None,
                          rate=0.0, on_seek=seeks.append)
    p.controls.seek(0.5)
    assert p.run()["n_events"] in (50, 51)
    assert seeks and abs(seeks[0] - 0.495) < 0.02


def test_player_loop_mode():
    loops = []
    p = InteractivePlayer(FakeDataset(n=10, dt=0.001), lambda s, k, i: None,
                          rate=0.0, loop=True,
                          on_loop=lambda: loops.append(1))
    assert p.run(max_events=25)["n_events"] == 25
    assert len(loops) == 2


def test_player_skip_stop_region():
    p, got = _collect(FakeDataset(n=100, dt=0.01), rate=0.0,
                      skip_stop_region=(0.25, 0.50))
    p.run()
    assert not any(0.25 <= g[0] <= 0.50 for g in got)
    assert len(got) == 100 - 26


def test_player_quit_and_controls():
    p = InteractivePlayer(FakeDataset(n=1000, dt=0.0),
                          lambda s, k, i: (p.controls.stop()
                                           if i == 5 else None), rate=0.0)
    assert p.run()["n_events"] <= 7
    c = p.controls
    c.rate = 1.0
    for _ in range(8):
        c.speed_up()
    assert c.rate == 64.0
    for _ in range(14):
        c.slow_down()
    assert c.rate == 1.0 / 64.0
    c.toggle_loop()
    c.seek(1.7)
    assert c.loop and c.seek_frac == 1.0
    # without a TTY the keyboard thread is never started
    assert not InteractivePlayer(FakeDataset(), lambda *a: None,
                                 keyboard=True).keyboard


# ---------------------------------------------------------------------------
# A capture streamed over loopback into LiveDriver + SlamSystem, both
# packages
# ---------------------------------------------------------------------------

class _Counting:
    """The driver's UdpSource, counting the packets it hands over."""

    def __init__(self, src):
        self.src, self.lidar, self.imu = src, 0, 0

    def read_imu(self, timeout_ms=100):
        b = self.src.read_imu(timeout_ms)
        self.imu += b is not None
        return b

    def read_lidar_many(self, max_n=64, timeout_ms=100):
        buf, n = self.src.read_lidar_many(max_n, timeout_ms)
        self.lidar += n
        return buf, n

    @property
    def lidar_dropped(self):
        return self.src.lidar_dropped

    def close(self):
        self.src.close()


def stream_lossless(drv, pcap_path, lidar_port, imu_port):
    """Send the capture's packets over loopback in capture order, one at a
    time, polling the driver until it has taken each one: every frame
    reaches the system, in the order an offline replay has."""
    from noetic_slam_tpu_torch.io.pcap import read_pcap

    drv.source = src = _Counting(drv.source)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sent = {"lidar": 0, "imu": 0}
    try:
        for _ts, port, payload in read_pcap(pcap_path):
            kind = "lidar" if port == 7502 else "imu"
            tx.sendto(payload, ("127.0.0.1",
                                lidar_port if kind == "lidar" else imu_port))
            sent[kind] += 1
            t0 = time.monotonic()
            while (src.lidar, src.imu) != (sent["lidar"], sent["imu"]):
                drv.poll_once(timeout_ms=2)
                assert time.monotonic() - t0 < 120.0, "packet lost"
    finally:
        tx.close()
    assert src.lidar_dropped == 0
    return sent


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("live_capture"))
    meta = fixtures.write_pcap_fixture(d)          # 16 x 512, 74 frames
    cfg = os.path.join(d, "cfg.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(LIVE_CFG, f)
    meta["cfg"] = cfg
    return meta


def test_capture_streams_into_slam_like_jax(capture):
    """The 16 x 512 capture streamed losslessly into the port's
    ``LiveDriver`` + ``SlamSystem(pipelined=True, device="cpu")`` (the
    composition ``cli live`` builds) and into JAX's. Both drivers hand
    their systems the same frames; the port also processes the frames JAX
    drops for IMU that lands after the frame completes (it holds them, see
    ``runtime/live.py``). At every stamp JAX processed, the poses agree
    within 5 cm; ATE under tests/test_pcap_e2e.py:58's 0.15 m."""
    _native_or_skip()
    from noetic_slam_tpu.config.params import load_config as jload
    from noetic_slam_tpu.io import ouster as jou
    from noetic_slam_tpu.runtime.live import LiveDriver as JaxLive
    from noetic_slam_tpu.runtime.slam import SlamSystem as JaxSlam
    from noetic_slam_tpu_torch.config.params import load_config
    from noetic_slam_tpu_torch.runtime.live import LiveDriver
    from noetic_slam_tpu_torch.runtime.slam import SlamSystem
    from noetic_slam_tpu_torch.utils.synthetic import ate_rmse

    with open(capture["metadata"]) as f:
        text = f.read()
    runs = []
    for drv_cls, slam, info, ports in (
            (LiveDriver, SlamSystem(load_config(capture["cfg"]),
                                    pipelined=True, device="cpu"),
             ou.SensorInfo.from_json(text), (47985, 47986)),
            (JaxLive, JaxSlam(jload(capture["cfg"]), pipelined=True),
             jou.SensorInfo.from_json(text), (47987, 47988))):
        calls = []
        inner = slam.process_scan

        def recording(header, xyz, pt, inner=inner, calls=calls):
            calls.append((header, xyz, pt))
            return inner(header, xyz, pt)

        slam.process_scan = recording
        drv = drv_cls(slam, info, lidar_port=ports[0], imu_port=ports[1],
                      max_read_errors=10 ** 9)
        try:
            sent = stream_lossless(drv, capture["pcap"], *ports)
        finally:
            drv.close()
        runs.append((drv, calls, np.asarray(slam.flush())))
    (drv, calls, traj), (jdrv, jcalls, jtraj) = runs
    assert drv.n_imu == jdrv.n_imu == sent["imu"]
    # the same frames, in order (the port calls again for each held one)
    first = [c for i, c in enumerate(calls)
             if i == 0 or c[0] != calls[i - 1][0]]
    assert len(first) == len(jcalls) == capture["n_frames"] - 1
    for (h, x, p), (jh, jx, jp) in zip(first, jcalls):
        assert h == jh
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(p, jp)
    # every frame held after calibration ran later; JAX dropped them
    assert drv.n_held > 0 and len(traj) == drv.n_scans
    assert drv.n_scans == jdrv.n_scans + drv.n_held >= 40
    assert drv.n_refused == len(jcalls) - jdrv.n_scans - drv.n_held
    at = {s: i for i, s in enumerate(traj[:, 0])}
    assert set(jtraj[:, 0]) <= set(at)
    rows = [at[s] for s in jtraj[:, 0]]
    err = np.linalg.norm(traj[rows, 1:4] - jtraj[:, 1:4], axis=1)
    assert err.max() < POSE_TOL, err.max()
    gt = np.loadtxt(capture["gt"])
    for t in (traj, jtraj):
        ate = ate_rmse(t[:, 0] - fixtures.PCAP_BASE_NS * 1e-9, t[:, 1:4],
                       gt[:, 0], gt[:, 1:4])
        assert ate < 0.15, ate


# ---------------------------------------------------------------------------
# cli live / cli player
# ---------------------------------------------------------------------------

def _main(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def test_cli_live_on_the_cpu(capture, tmp_path):
    """``cli live --device cpu`` while a thread replays the capture to its
    ports at 5x the sensor's pace: exits 0 and reports its scans, IMU
    samples and drops."""
    _native_or_skip()
    from noetic_slam_tpu_torch import cli
    from noetic_slam_tpu_torch.io.pcap import read_pcap

    pkts = list(read_pcap(capture["pcap"]))
    done = threading.Event()

    def send():
        time.sleep(0.5)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        t0 = time.monotonic()
        for ts, port, payload in pkts:
            lag = t0 + (ts - pkts[0][0]) / 5.0 - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            tx.sendto(payload, ("127.0.0.1", 47989 if port == 7502
                                else 47990))
        tx.close()
        done.set()

    th = threading.Thread(target=send, daemon=True)
    th.start()
    rc, out = _main(cli, [
        "live", "--metadata", capture["metadata"], "--lidar-port", "47989",
        "--imu-port", "47990", "--duration", "4.0", "--config",
        capture["cfg"], "--pose-out", str(tmp_path / "pose.tum"),
        "--device", "cpu"])
    th.join(timeout=30)
    assert rc == 0 and done.is_set() and not th.is_alive()
    assert out.splitlines()[0] == "listening on udp 47989/47990 (16x512)"
    last = out.splitlines()[-1]
    assert last.startswith("scans=")
    n = dict(kv.split("=") for kv in last.split())
    assert int(n["imu"]) > 300 and int(n["scans"]) >= 1


@pytest.mark.skipif(not os.path.isdir(FIXTURE),
                    reason="mulran_mini fixture not present")
def test_cli_player_matches_jax(tmp_path):
    """``cli player`` unpaced over the MulRan fixture (no TTY: no keyboard
    thread): the port (``--device cpu``) and JAX dispatch the same events
    and write trajectories within 5 cm per pose."""
    from noetic_slam_tpu import cli as jcli
    from noetic_slam_tpu_torch import cli as tcli

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({"capacity": {
        "max_points": 2048, "max_ds_points": 1024, "max_deskew_frames": 128,
        "max_imu_window": 64, "max_keyframes": 64, "max_submap_kf": 32,
        "max_trajectory": 512}}))
    argv = ["player", "--mulran", FIXTURE, "--rate", "0", "--no-tsdf",
            "--config", str(cfg)]
    (rc, out), (jrc, jout) = (
        _main(tcli, argv + ["--out", str(tmp_path / "port"),
                            "--device", "cpu"]),
        _main(jcli, argv + ["--out", str(tmp_path / "jax")]))
    assert rc == jrc == 0
    stats, jstats = json.loads(out.splitlines()[0]), json.loads(
        jout.splitlines()[0])
    assert stats["n_events"] == jstats["n_events"] > 100
    assert stats["loops"] == jstats["loops"] == 0
    assert out.splitlines()[1:] == jout.splitlines()[1:]
    traj = np.loadtxt(tmp_path / "port" / "trajectory.tum")
    ref = np.loadtxt(tmp_path / "jax" / "trajectory.tum")
    assert traj.shape == ref.shape and len(ref) >= 20
    np.testing.assert_array_equal(traj[:, 0], ref[:, 0])
    err = np.linalg.norm(traj[:, 1:4] - ref[:, 1:4], axis=1)
    assert err.max() < POSE_TOL, err.max()
