"""The port keeps its own copies of the JAX package's numpy-only code (it
imports nothing of that package). Each copy is held to its original: the
config dataclasses field by field, the simulator's arrays, the MulRan
reader's output, the writers' bytes, the pose extrapolator's poses, the
stage timer's tables, the ring descriptors, the host geometry helpers and
the sharded GICP's traffic model."""

import dataclasses
import os

import numpy as np
import pytest

from noetic_slam_tpu.config import params as jparams
from noetic_slam_tpu.io import export as jexport
from noetic_slam_tpu.io import mulran as jmulran
from noetic_slam_tpu.models import placedesc as jplacedesc
from noetic_slam_tpu.runtime import poseext as jposeext
from noetic_slam_tpu.runtime import profiling as jprofiling
from noetic_slam_tpu.utils import geometry as jgeom
from noetic_slam_tpu.utils import synthetic as jsyn
from noetic_slam_tpu_torch.config import params as tparams
from noetic_slam_tpu_torch.io import export as texport
from noetic_slam_tpu_torch.io import mulran as tmulran
from noetic_slam_tpu_torch.models import placedesc as tplacedesc
from noetic_slam_tpu_torch.runtime import poseext as tposeext
from noetic_slam_tpu_torch.runtime import profiling as tprofiling
from noetic_slam_tpu_torch.utils import geometry as tgeom
from noetic_slam_tpu_torch.utils import synthetic as tsyn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mulran_mini")


def _schema(cls):
    """{field: default or nested schema}, recursively."""
    out = {}
    for f in dataclasses.fields(cls):
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        out[f.name] = (_schema(type(default))
                       if dataclasses.is_dataclass(default) else default)
    return out


CONFIGS = sorted(n for n, c in vars(jparams).items()
                 if dataclasses.is_dataclass(c) and isinstance(c, type))


def test_every_config_class_is_copied():
    assert CONFIGS == sorted(
        n for n, c in vars(tparams).items()
        if dataclasses.is_dataclass(c) and isinstance(c, type))
    assert "OccupancyConfig" in CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_and_defaults_equal(name):
    assert _schema(getattr(tparams, name)) == _schema(getattr(jparams, name))


@pytest.mark.parametrize("yaml_name", ["default.yaml", "mulran.yaml"])
def test_load_config_equal(yaml_name):
    path = os.path.join(REPO, "cfg", yaml_name)
    t = tparams.load_config(path, overrides={"map_backend": "occupancy"})
    j = jparams.load_config(path, overrides={"map_backend": "occupancy"})
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_make_sim_bitwise_equal():
    t = tsyn.make_sim(seed=3)
    j = jsyn.make_sim(seed=3)
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    for s in (0, 7):
        for a, b in zip(t.scan(s), j.scan(s)):
            np.testing.assert_array_equal(a, b)
    traj = np.c_[t.gt_stamps, t.gt_pos]
    assert tsyn.ate_rmse(traj[:, 0], traj[:, 1:4] + 0.01, t.gt_stamps,
                         t.gt_pos) == jsyn.ate_rmse(
        traj[:, 0], traj[:, 1:4] + 0.01, j.gt_stamps, j.gt_pos)


@pytest.mark.skipif(not os.path.isdir(FIXTURE),
                    reason="mulran_mini fixture not present")
def test_mulran_reads_identically():
    t = tmulran.MulranDataset.load(FIXTURE)
    j = jmulran.MulranDataset.load(FIXTURE)
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray) or b is None:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    kinds = ("imu", "scan", "gps", "radar")
    events = list(t.events(kinds))
    assert events == list(j.events(kinds)) and len(events) > 100
    for i in (0, len(j.scan_stamps) - 1):
        np.testing.assert_array_equal(t.read_scan(i), j.read_scan(i))


def _write_all(mod, d):
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    inten = rng.random(50).astype(np.float32)
    faces = rng.integers(0, 50, (20, 3)).astype(np.int32)
    traj = np.c_[np.arange(6.0), rng.normal(size=(6, 3)),
                 rng.normal(size=(6, 4))]
    mod.write_ply(os.path.join(d, "a.ply"), xyz)
    mod.write_ply(os.path.join(d, "b.ply"), xyz, inten, binary=False)
    mod.write_ply_mesh(os.path.join(d, "m.ply"), xyz, faces)
    mod.write_pcd(os.path.join(d, "c.pcd"), xyz, inten)
    mod.write_tum_trajectory(os.path.join(d, "t.tum"), traj)
    return mod.read_ply(os.path.join(d, "b.ply"))


def test_writers_identical_bytes(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    rt = _write_all(texport, str(tmp_path / "t"))
    rj = _write_all(jexport, str(tmp_path / "j"))
    np.testing.assert_array_equal(rt, rj)
    for name in ("a.ply", "b.ply", "m.ply", "c.pcd", "t.tum"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


class _Pipe:
    """The pipeline attributes the extrapolator reads: the IMU buffer."""

    def __init__(self, sim):
        self._imu_stamps = sim.imu_stamps.astype(np.float64)
        self._imu_ang = sim.imu_ang.astype(np.float64)
        self._imu_acc = sim.imu_acc.astype(np.float64)


def test_pose_extrapolator_equal():
    sim = tsyn.make_sim(duration=1.0, seed=4)
    rng = np.random.default_rng(4)
    seed = (np.asarray([0.9, 0.1, -0.2, 0.3]) / np.linalg.norm(
        [0.9, 0.1, -0.2, 0.3]), rng.normal(size=3), rng.normal(size=3),
        rng.normal(scale=0.01, size=3), rng.normal(scale=0.05, size=3))
    out = []
    for mod, cfgmod in ((tposeext, tparams), (jposeext, jparams)):
        ext = mod.PoseExtrapolator(cfgmod.DlioConfig(), _Pipe(sim))
        assert ext.pose_at(0.5) is None
        ext.seed(0.2, *seed)
        # monotone queries, one backwards, past the last sample
        out.append([ext.pose_at(t) for t in (0.21, 0.4, 0.73, 0.3, 1.5)])
    for (qa, pa), (qb, pb) in zip(*out):
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(pa, pb)


def test_stage_timer_equal(monkeypatch):
    """Both timers on one fake clock: equal totals, counts, tables and
    deltas."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr("time.perf_counter", lambda: float(next(ticks)))
    timers = (tprofiling.StageTimer(), jprofiling.StageTimer())
    snaps = []
    for st in timers:
        for name in ("fetch", "fuse", "fetch"):
            with st(name):
                pass
        before = st.snapshot()
        with st("verify"):
            pass
        snaps.append((st.table(), st.mean_ms("fetch"),
                      type(st).delta(before, st.snapshot())))
    assert snaps[0] == snaps[1]


def test_ring_descriptor_equal():
    rng = np.random.default_rng(5)
    for n in (0, 5, 4000):
        xyz = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
        valid = rng.random(n) > 0.2
        np.testing.assert_array_equal(tplacedesc.ring_descriptor(xyz, valid),
                                      jplacedesc.ring_descriptor(xyz, valid))
    assert (tplacedesc.N_RINGS, tplacedesc.N_SECTORS) == (
        jplacedesc.N_RINGS, jplacedesc.N_SECTORS)


def test_host_geometry_equal():
    rng = np.random.default_rng(6)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        p = rng.normal(size=3)
        np.testing.assert_array_equal(tgeom.quat_to_mat_np(q),
                                      jgeom.quat_to_mat_np(q))
        T = tgeom.make_se3_np(q, p)
        np.testing.assert_array_equal(T, jgeom.make_se3_np(q, p))
        np.testing.assert_array_equal(tgeom.mat_to_quat_np(T[:3, :3]),
                                      jgeom.mat_to_quat_np(T[:3, :3]))


@pytest.mark.parametrize("nq,ndev,iters", [(8192, 1, None), (8192, 2, None),
                                           (8192, 4, 7), (1024, 8, 3),
                                           (100, 3, 0)])
def test_collective_traffic_per_align_equal(nq, ndev, iters):
    """``parallel.registration.collective_traffic_per_align``, a pure
    Python copy, gives the original's numbers."""
    from noetic_slam_tpu.parallel import registration as jreg
    from noetic_slam_tpu_torch.parallel import registration as treg

    for kw in ({}, {"max_iterations": 5}):
        j = jreg.collective_traffic_per_align(jparams.GicpConfig(**kw), nq,
                                              ndev, iters)
        t = treg.collective_traffic_per_align(tparams.GicpConfig(**kw), nq,
                                              ndev, iters)
        assert t == j
