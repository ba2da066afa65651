"""The fault-injection cases of tests/test_robustness.py, held between the
JAX ``OdometryPipeline`` and the port's (``device="cpu"``) through the
lockstep harness of ``tests/torch_lockstep.py`` (what it holds exactly,
and where the reference's own one-ulp noise lets a pose be held within
2 cm a step). The port's own run keeps the JAX test's bound. Most JAX
tests here are marked ``slow``; these run a shorter draw of each fault
(fewer scans)."""

import jax
import numpy as np
import pytest
import torch

from noetic_slam_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline
from noetic_slam_tpu_torch.config import ImuConfig
from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
from noetic_slam_tpu_torch.utils import synthetic
from tests.torch_lockstep import CPU, Trio, ate, run, small_cfg
from tests.torch_parity import jax_cfg, to_np

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_steps():
    """small_cfg's jitted JAX step, compiled once for the module."""
    return {}


def _feed_imu(trio, sim, through):
    imu_i = 0
    while (imu_i < len(sim.imu_stamps)
           and sim.imu_stamps[imu_i] <= through):
        trio.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                      sim.imu_acc[imu_i])
        imu_i += 1


def test_imu_dropout_degrades_gracefully(jax_steps):
    """tests/test_robustness.py:45 at 1.2 s: a 0.3 s IMU gap mid-run holds
    the scans it covers back until the IMU resumes (the same scans in
    both); tracking survives (ATE < 0.25 m)."""
    sim = synthetic.make_sim(duration=1.2, n_points=2048, calib_time=3.1,
                             seed=21)
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    trio = Trio(small_cfg(), jax_steps)
    assert run(sim, trio, scans, drop_imu_between=(0.55, 0.85)) == []
    traj, jtraj = trio.check(min_held=0.75)
    assert trio.own.num_processed == len(scans)
    assert trio.deferred > 0            # the gap is exercised
    for t in (traj, jtraj):
        assert np.all(np.isfinite(t[:, 1:4]))
        assert ate(sim, t) < 0.25


def test_out_of_order_imu_dropped():
    """tests/test_robustness.py:60: late and duplicate samples are
    dropped and counted, the same ones in both packages."""
    cfg = small_cfg(imu=ImuConfig(calibrate_gyro=False,
                                  calibrate_accel=False,
                                  gravity_align=False))
    pipes = (JaxPipeline(jax_cfg(cfg)), OdometryPipeline(cfg, device=CPU))
    for pipe in pipes:
        pipe.push_imu(1.0, [0, 0, 0], [0, 0, 9.8])
        pipe.push_imu(0.5, [0, 0, 0], [0, 0, 9.8])   # late
        pipe.push_imu(1.0, [0, 0, 0], [0, 0, 9.8])   # duplicate
        pipe.push_imu(1.1, [0, 0, 0], [0, 0, 9.8])
        assert pipe.imu_dropped == 2
        assert list(pipe._imu_stamps) == [1.0, 1.1]


def test_all_points_out_of_range_skipped(jax_steps):
    """tests/test_robustness.py:73: a scan whose points all sit inside
    the crop box is skipped in both (odom.cc:764-767)."""
    sim = synthetic.make_sim(duration=0.5, n_points=512, calib_time=3.1,
                             seed=22)
    trio = Trio(small_cfg(), jax_steps)
    _feed_imu(trio, sim, 0.3)
    tiny = np.random.default_rng(0).uniform(-0.5, 0.5, (512, 3)).astype(
        np.float32)
    trio.process_scan(0.1, tiny, np.zeros(512))
    trio.check(min_held=1.0)
    assert not trio.steps[0]["jax"]["processed"]
    assert trio.own.num_skipped == trio.jax.num_skipped == 1


def test_duplicate_scan_stamp_no_nan(jax_steps):
    """tests/test_robustness.py:92: the same scan twice (dt = 0 between
    scans) leaves the state finite in both."""
    sim = synthetic.make_sim(duration=0.5, n_points=2048, calib_time=3.1,
                             seed=23)
    trio = Trio(small_cfg(), jax_steps)
    header, xyz, pt = sim.scan(0)
    _feed_imu(trio, sim, header + pt.max() + 0.02)
    trio.process_scan(header, xyz, pt)
    trio.process_scan(header, xyz, pt)           # same stamp again
    trio.check(min_held=1.0)
    assert len(trio.steps) == 2


def test_degenerate_registration_gate_bounds_failure(jax_steps):
    """tests/test_robustness.py:116 at 2 s: a world of one ground plane
    (translation-degenerate in the plane); the max_correction gate rejects
    corrections in both packages' own runs, and the gate and the velocity
    clamp keep the state finite and bounded. The registration is
    unobservable along the plane: the reference against itself under one
    ulp moves by up to 1.2 m a step (scripts/torch_ulp_noise.py), and the
    gate decides on that noise-dominated correction, so no registration
    step and no gate decision is held (no one-ulp run)."""
    rng = np.random.default_rng(9)
    g = np.c_[rng.uniform(-60, 60, 30000), rng.uniform(-60, 60, 30000),
              np.zeros(30000)].astype(np.float32)
    sim = synthetic.make_sim(duration=2.0, n_points=1024, calib_time=3.1,
                             seed=24, imu_noise=0.003, world_pts=g)
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    cfg = small_cfg()
    trio = Trio(cfg, jax_steps, ulp=False)
    assert run(sim, trio, scans) == []
    trio.check(min_held=None)
    for st in (trio.own.state, jax.device_get(trio.jax.state)):
        assert int(to_np(st.reg_rejected)) > 0
        p, v = to_np(st.p), to_np(st.v)
        assert float(np.linalg.norm(v)) <= cfg.geo.max_velocity + 1.0
        assert float(np.linalg.norm(p)) < 150.0, p
