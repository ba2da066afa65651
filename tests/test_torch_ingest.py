"""The port's own copies of the ingest layer, each held to its original on
the same seeded inputs: the LZ4 frame codec, the rosbag writer (bytes) and
reader, the seeded fixture writers (bytes), the pcap replay's events, the
native batch parser and ``ScanBatcher.push_many``, the Ouster XYZ
projection, the PNG writer and renders, ``SlamMetrics``, the MulRan
export to a bag, and the dataset replay's callbacks."""

import dataclasses
import filecmp
import os
import sys

import numpy as np
import pytest
import torch

from noetic_slam_tpu.io import export as jexport
from noetic_slam_tpu.io import mulran as jmulran
from noetic_slam_tpu.io import ouster as jou
from noetic_slam_tpu.io import pcap as jpcap
from noetic_slam_tpu.io import replay as jreplay
from noetic_slam_tpu.io import rosbag as jrosbag
from noetic_slam_tpu.io import viz as jviz
from noetic_slam_tpu.runtime import metrics as jmetrics
from noetic_slam_tpu.runtime import native as jnative
from noetic_slam_tpu.runtime.pipeline import NeedMoreImu as JNeedMoreImu
from noetic_slam_tpu.utils import lz4frame as jlz4
from noetic_slam_tpu_torch.io import export as texport
from noetic_slam_tpu_torch.io import mulran as tmulran
from noetic_slam_tpu_torch.io import ouster as tou
from noetic_slam_tpu_torch.io import pcap as tpcap
from noetic_slam_tpu_torch.io import replay as treplay
from noetic_slam_tpu_torch.io import rosbag as trosbag
from noetic_slam_tpu_torch.io import viz as tviz
from noetic_slam_tpu_torch.runtime import metrics as tmetrics
from noetic_slam_tpu_torch.runtime import native as tnative
from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu as TNeedMoreImu
from noetic_slam_tpu_torch.utils import fixtures
from noetic_slam_tpu_torch.utils import lz4frame as tlz4
from noetic_slam_tpu_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts import make_mulran_fixture, make_pcap_fixture  # noqa: E402

torch.set_num_threads(1)

FIXTURE = os.path.join(REPO, "tests", "fixtures", "mulran_mini")
# a short capture: 1 s of calibration hold, 0.5 s of motion
PCAP_KW = dict(hold=1.0, drive=0.5, seed=5, h=16, w=512)


def _need_lz4(compression):
    if compression == "lz4" and not (jlz4.available()
                                     and tlz4.available()):
        pytest.skip("liblz4 unavailable")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b):
    names = _files(a)
    assert names == _files(b)
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """The port's seeded capture and the script's, same arguments."""
    t = str(tmp_path_factory.mktemp("pcap_port"))
    j = str(tmp_path_factory.mktemp("pcap_script"))
    meta = fixtures.write_pcap_fixture(t, **PCAP_KW)
    make_pcap_fixture.write_fixture(j, **PCAP_KW)
    assert meta["n_frames"] > 10
    return t, j


# ------------------------------------------------------------------ lz4

def test_lz4_roundtrip_equal():
    _need_lz4("lz4")
    data = b"noetic" * 10_000 + bytes(range(256)) * 100
    comp = tlz4.compress(data)
    assert comp == jlz4.compress(data)
    assert comp[:4] == b"\x04\x22\x4d\x18"
    assert tlz4.decompress(comp) == data == jlz4.decompress(comp)


# --------------------------------------------------------------- rosbag

def _write_bag(mod, path, compression, sim, scans):
    """The same messages through ``mod``'s BagWriter: the simulator's IMU
    and scans (with per-point times), an odometry and two images."""
    w = mod.BagWriter(path, compression=compression)
    events = sorted([(t, 0, i) for i, t in enumerate(sim.imu_stamps)]
                    + [(t, 1, i) for i, t in enumerate(sim.scan_stamps)])
    for t, kind, i in events:
        if kind == 0:
            w.write_imu("/imu/data_raw", t + 1e9, sim.imu_ang[i],
                        sim.imu_acc[i])
        else:
            h, xyz, pt = scans[i]
            w.write_pointcloud2("/os1_points", h + 1e9, xyz,
                                (pt * 1e9).astype(np.uint32))
    w.write_odometry("/gt", 1e9 + 0.5, np.array([1.0, 2.0, 3.0]),
                     np.array([0.9, 0.1, -0.3, 0.3]) / np.linalg.norm(
                         [0.9, 0.1, -0.3, 0.3]))
    rng = np.random.default_rng(4)
    w.write_image("/radar", 1e9 + 0.6,
                  rng.integers(0, 255, (8, 12)).astype(np.uint8))
    w.write_image("/radar16", 1e9 + 0.7,
                  rng.integers(0, 65535, (8, 12)).astype(np.uint16))
    w.close()


@pytest.fixture(scope="module")
def small_sim():
    """A short simulated sequence and its scans (``scan`` draws noise, so
    the scans are drawn once)."""
    sim = synthetic.make_sim(duration=0.6, n_points=512, calib_time=0.2,
                             seed=12)
    return sim, [sim.scan(i) for i in range(len(sim.scan_stamps))]


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bag_writer_bytes_and_reader_equal(tmp_path, small_sim, compression):
    _need_lz4(compression)
    t, j = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
    _write_bag(trosbag, t, compression, *small_sim)
    _write_bag(jrosbag, j, compression, *small_sim)
    assert filecmp.cmp(t, j, shallow=False)
    got = list(trosbag.read_lidar_imu(t))
    want = list(jrosbag.read_lidar_imu(t))
    assert len(got) == len(want) > len(small_sim[1])
    for (tk, tm), (jk, jm) in zip(got, want):
        assert tk == jk and tm.keys() == jm.keys()
        for key in jm:
            np.testing.assert_array_equal(tm[key], jm[key], err_msg=key)
    topics = ["/gt", "/radar", "/radar16"]
    msgs = list(trosbag.BagReader(t).messages(topics))
    assert len(msgs) == 3
    assert msgs == list(jrosbag.BagReader(t).messages(topics))


def test_sim_bag_replays_through_port_need_more_imu(tmp_path, small_sim):
    """``write_sim_bag`` records each scan before the IMU sample that
    covers its sweep, so ``replay_bag`` holds every scan back through the
    port's ``NeedMoreImu`` and runs it on that sample."""
    sim = small_sim[0]
    path = str(tmp_path / "sim.bag")
    meta = fixtures.write_sim_bag(path, sim)
    assert meta["n_scans"] == len(sim.scan_stamps)

    class Pipe:
        calibrated = True
        starved = 0

        def __init__(self):
            self.imu, self.scans = [], []

        def push_imu(self, stamp, ang, acc):
            self.imu.append(stamp)

        def process_scan(self, stamp, xyz, pt):
            if not self.imu or self.imu[-1] < stamp + pt.max():
                self.starved += 1
                raise TNeedMoreImu(stamp)
            self.scans.append(stamp)

    pipe = Pipe()
    stats = trosbag.replay_bag(path, pipe)
    assert stats["n_scans"] == len(pipe.scans) == meta["n_scans"]
    assert pipe.starved == meta["n_scans"]
    np.testing.assert_allclose(np.asarray(pipe.scans) - fixtures.BAG_EPOCH,
                               sim.scan_stamps, atol=1e-6)


# ------------------------------------------------------------- fixtures

def test_pcap_fixture_bytes_equal(capture):
    _same_tree(*capture)


def test_mulran_fixture_bytes_equal(tmp_path):
    kw = dict(duration=1.0, hold=1.0, n_points=256, seed=8)
    fixtures.write_mulran_fixture(str(tmp_path / "t"), **kw)
    make_mulran_fixture.write_fixture(str(tmp_path / "j"), **kw)
    _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    pose = (lambda t: synthetic.loop_pose_of(t, period=20.0, radius=5.0))
    np.testing.assert_array_equal(
        fixtures.still_then(pose, 1.0)(1.7)[0],
        make_mulran_fixture.still_then(pose, 1.0)(1.7)[0])


# ----------------------------------------------------------- ouster, pcap

def _info(path):
    with open(path) as f:
        text = f.read()
    return tou.SensorInfo.from_json(text), jou.SensorInfo.from_json(text)


def _scans_equal(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if y is None or isinstance(y, int):
            assert x == y, f.name
        else:
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_replay_pcap_scans_events_equal(capture):
    root = capture[0]
    tinfo, jinfo = _info(os.path.join(root, "metadata.json"))
    path = os.path.join(root, "fixture.pcap")
    got = list(tpcap.replay_pcap_scans(path, tinfo))
    want = list(jpcap.replay_pcap_scans(path, jinfo))
    assert len(got) == len(want)
    kinds = [e[0] for e in want]
    assert kinds.count("scan") > 10 and kinds.count("imu") > 100
    for a, b in zip(got, want):
        assert a[0] == b[0] and a[1] == b[1]
        if b[0] == "imu":
            np.testing.assert_array_equal(a[2], b[2])
            np.testing.assert_array_equal(a[3], b[3])
        else:
            _scans_equal(a[2], b[2])
    assert list(tpcap.read_pcap(path, port=7503)) == list(
        jpcap.read_pcap(path, port=7503))


def _lidar_packets(root, info):
    pf = jou.PacketFormat(info)
    return [p for _, port, p in jpcap.read_pcap(
        os.path.join(root, "fixture.pcap"))
        if port == 7502 and len(p) >= pf.lidar_packet_size]


def test_native_parser_and_push_many_equal(capture):
    root = capture[0]
    tinfo, jinfo = _info(os.path.join(root, "metadata.json"))
    pkts = _lidar_packets(root, jinfo)
    # built from the port's own sources into the git-ignored build/
    assert tnative.load(required=True) is not None
    assert tnative._NATIVE_DIR == os.path.join(REPO, "noetic_slam_tpu_torch",
                                               "native")
    assert tnative._LIB_PATH == os.path.join(REPO, "build", "native",
                                             "libnoetic_slam_native.so")
    buf = b"".join(pkts[:96])
    got = tnative.parse_lidar_packets(buf, 96, tou.PacketFormat(tinfo))
    want = jnative.parse_lidar_packets(buf, 96, jou.PacketFormat(jinfo))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the native route against the port's own per-packet route
    tb, jb, pb = (tou.ScanBatcher(tinfo), jou.ScanBatcher(jinfo),
                  tou.ScanBatcher(tinfo))
    step = 40                       # runs that straddle frame changes
    for s in range(0, len(pkts), step):
        part = pkts[s:s + step]
        a = tb.push_many(b"".join(part), len(part))
        b = jb.push_many(b"".join(part), len(part))
        c = [d for d in (pb.push(p) for p in part) if d is not None]
        assert len(a) == len(b) == len(c)
        for x, y, z in zip(a, b, c):
            _scans_equal(x, y)
            _scans_equal(x, z)
    _scans_equal(tb.flush(), jb.flush())


def test_xyz_lut_and_scan_to_points_equal(capture):
    root = capture[0]
    tinfo, jinfo = _info(os.path.join(root, "metadata.json"))
    # a sensor with offsets, azimuths, shifts and a mounting transform
    rng = np.random.default_rng(3)
    h = tinfo.pixels_per_column
    b2l = np.eye(4)
    b2l[0, 3], b2l[2, 3] = 15.806, 3.1
    l2s = np.eye(4)
    l2s[:3, :3] = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                            [0.0, 0.0, 1.0]])
    l2s[:3, 3] = [0.0, 0.0, 36.18]
    kw = dict(beam_azimuth_angles=rng.uniform(-4.2, 4.2, h),
              pixel_shift_by_row=rng.integers(0, 24, h),
              beam_to_lidar=b2l, lidar_to_sensor=l2s)
    tinfo2 = dataclasses.replace(tinfo, **kw)
    jinfo2 = dataclasses.replace(jinfo, **kw)
    for ti, ji in ((tinfo, jinfo), (tinfo2, jinfo2)):
        tl, jl = tou.make_xyz_lut(ti), jou.make_xyz_lut(ji)
        np.testing.assert_array_equal(tl[0], jl[0])
        np.testing.assert_array_equal(tl[1], jl[1])
    scans = [e[2] for e in jpcap.replay_pcap_scans(
        os.path.join(root, "fixture.pcap"), jinfo) if e[0] == "scan"]
    for scan in (scans[2], scans[-2]):
        got = tou.scan_to_points(scan, *tou.make_xyz_lut(tinfo2))
        want = jou.scan_to_points(scan, *jou.make_xyz_lut(jinfo2))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tou.destagger(scan.range, tinfo2.pixel_shift_by_row),
            jou.destagger(scan.range, jinfo2.pixel_shift_by_row))


# ------------------------------------------------------- viz and metrics

def test_viz_png_bytes_and_renders_equal(tmp_path):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (37, 53, 3)).astype(np.uint8)
    tviz.write_png(str(tmp_path / "t.png"), img)
    jviz.write_png(str(tmp_path / "j.png"), img)
    assert filecmp.cmp(tmp_path / "t.png", tmp_path / "j.png",
                       shallow=False)
    cloud = rng.normal(0, 5, (3000, 3)).astype(np.float32)
    traj = np.cumsum(rng.normal(0, 0.1, (200, 3)), 0)
    np.testing.assert_array_equal(tviz.render_views(cloud, size=96),
                                  jviz.render_views(cloud, size=96))
    np.testing.assert_array_equal(tviz.render_trajectory(traj, size=128),
                                  jviz.render_trajectory(traj, size=128))
    tviz.write_html_viewer(str(tmp_path / "t.html"), cloud)
    jviz.write_html_viewer(str(tmp_path / "j.html"), cloud)
    assert filecmp.cmp(tmp_path / "t.html", tmp_path / "j.html",
                       shallow=False)


def test_slam_metrics_summary_equal():
    t, j = tmetrics.SlamMetrics(), jmetrics.SlamMetrics()
    for i in range(30):
        for m in (t, j):
            m.scan_done(100.0 + 0.1 * i, 0.01 + 0.001 * (i % 7),
                        [0.3 * i, 0.1 * i, 0.0], i % 4 == 0)
            m.imu_seen(100.0 + 0.01 * i)
    a, b = t.summary(), j.summary()
    assert a.keys() == b.keys()
    for key in ("scans", "keyframes", "distance_m", "comp_ms_avg",
                "comp_ms_max", "lidar_hz", "imu_hz"):
        assert a[key] == b[key], key
    assert t.dashboard().splitlines()[0] == j.dashboard().splitlines()[0]


# ---------------------------------------------------------------- export

@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_export_mulran_bag_equal(tmp_path, compression):
    """The port's bag against JAX's: every message byte-equal except the
    ground truth's quaternions, which come from the port's host helper
    (f64, then f32) where JAX runs its device ``mat_to_quat`` in f32;
    those are held to 1e-6."""
    t, j = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
    assert texport.export_mulran_bag(
        tmulran.MulranDataset.load(FIXTURE), t,
        compression=compression) == jexport.export_mulran_bag(
        jmulran.MulranDataset.load(FIXTURE), j, compression=compression)
    got = list(trosbag.BagReader(t).messages())
    want = list(jrosbag.BagReader(j).messages())
    assert len(got) == len(want) > 0
    n_quat = 0
    for (tt, tty, ts, td), (jt, jty, js, jd) in zip(got, want):
        assert (tt, tty, ts) == (jt, jty, js)
        if td == jd:
            continue
        assert tt == "/gt" and len(td) == len(jd)
        a, b = trosbag.parse_odometry(td), jrosbag.parse_odometry(jd)
        np.testing.assert_array_equal(a["p"], b["p"])
        np.testing.assert_allclose(a["q"], b["q"], rtol=0, atol=1e-6)
        # nothing else differs: with JAX's quaternion the message is JAX's
        off = (4 + 8 + 4 + len(a["frame_id"]) + 4
               + len(a["child_frame_id"]) + 24)
        assert td[:off] + jd[off:off + 32] + td[off + 32:] == jd
        n_quat += 1
    assert n_quat < len(got)
    if n_quat == 0:
        assert filecmp.cmp(t, j, shallow=False)


# ---------------------------------------------------------------- replay

class _Recorder:
    """A duck-typed pipeline: records every call and holds a scan back
    (``need``) until the IMU has passed its stamp by 40 ms."""

    calibrated = True

    def __init__(self, need):
        self.need, self.log, self.last_imu = need, [], -np.inf

    def push_imu(self, stamp, ang, acc):
        self.last_imu = stamp
        self.log.append(("imu", round(float(stamp), 9)))

    def process_scan(self, stamp, xyz, point_times=None):
        if self.last_imu < stamp + 0.04:
            raise self.need(stamp)
        self.log.append(("scan", round(float(stamp), 9), xyz.shape))
        return ("out", round(float(stamp), 9))


def test_replay_dataset_callbacks_equal():
    runs = []
    for replay, mulran, need in (
            (treplay, tmulran, TNeedMoreImu),
            (jreplay, jmulran, JNeedMoreImu)):
        ds = mulran.MulranDataset.load(FIXTURE)
        pipe, seen = _Recorder(need), []
        stats = replay.replay_dataset(
            ds, pipe, tsdf_integrator=lambda out: seen.append(("tsdf", out)),
            on_scan=lambda i, out: seen.append(("scan", i, out)),
            on_gps=lambda s, row: seen.append(("gps", s, tuple(row))),
            on_radar=lambda s, i: seen.append(("radar", s, i)),
            max_scans=25)
        runs.append((pipe.log, seen, stats["n_scans"], stats["n_imu"]))
    (tlog, tseen, tn, ti), (jlog, jseen, jn, ji) = runs
    assert (tn, ti) == (jn, ji) and tn == 25
    assert tlog == jlog
    assert tseen == jseen
    kinds = {e[0] for e in jseen}
    assert kinds == {"tsdf", "scan", "gps", "radar"}
