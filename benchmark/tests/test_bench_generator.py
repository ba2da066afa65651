"""The scene, scan and IMU generator (CPU)."""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from benchmark.gen.path import GRAVITY, Path  # noqa: E402
from benchmark.gen.producer import make_sensor  # noqa: E402
from benchmark.gen.sensor import column_transform  # noqa: E402

TRAFFIC = ("drive", "walk")


def _traffic(name):
    with open(os.path.join(REPO, "benchmark", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _sensor_cfg(name, **kw):
    with open(os.path.join(REPO, "benchmark", "configs", f"{name}.json")) as f:
        cfg = json.load(f)["sensor"]
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("name", TRAFFIC)
def test_imu_is_the_paths_derivative(name):
    """Gyro and specific force against central differences of the pose
    (a step of 2 ms: a turn's position is tabled at ~1 mm steps)."""
    p = Path(_traffic(name)["path"], 2 ** 31 + 5)
    t = np.linspace(0.2, 60.0, 1500)
    gyro, acc = p.imu(t)
    dt = 2e-3
    (R0, p0), (R1, p1), (R2, p2) = (p.pose(t - dt), p.pose(t),
                                    p.pose(t + dt))
    W = np.einsum("nji,njk->nik", R1, (R2 - R0) / (2 * dt))
    w = np.stack([W[:, 2, 1], W[:, 0, 2], W[:, 1, 0]], -1)
    f = np.einsum("nji,nj->ni", R1, (p2 - 2 * p1 + p0) / dt ** 2
                  + [0.0, 0.0, GRAVITY])
    np.testing.assert_allclose(gyro, w, atol=1e-3)
    np.testing.assert_allclose(acc, f, atol=5e-2)


def test_at_rest_before_the_start():
    p = Path(_traffic("walk")["path"], 3)
    gyro, acc = p.imu(np.linspace(-3.0, 0.0, 50))
    np.testing.assert_allclose(gyro, 0.0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(acc, axis=1), GRAVITY,
                               atol=1e-9)
    np.testing.assert_allclose(acc, acc[:1].repeat(50, 0), atol=1e-12)


def test_column_transform_matches_the_per_point_loop():
    """``Sim.scan``'s loop, ``xyz[k] = R(t_k)^T (w_k - p(t_k))`` one point
    at a time, on a few hundred points of the drive at its full speed."""
    from noetic_slam_tpu_torch.utils.synthetic import Sim

    path = Path(_traffic("drive")["path"], 11)
    rng = np.random.default_rng(0)
    cols = 512
    t0 = 30.0
    times = t0 + np.arange(cols) * (0.1 / cols)
    R_cols, p_cols = path.pose(times)
    col = rng.integers(0, cols, 300)
    world = p_cols[col] + rng.uniform(-40, 40, (300, 3))
    got = column_transform(R_cols, p_cols, col, world.T).T

    def pose_fn(t):
        R, p = path.pose(np.array([float(t)]))
        return R[0], p[0]

    sim = Sim(world=world.astype(np.float32), imu_stamps=None, imu_ang=None,
              imu_acc=None, scan_stamps=np.array([t0]), gt_stamps=None,
              gt_pos=None, gt_quat=None, duration=1.0, rng=None,
              sweep_time=0.1, n_points=300, max_range=1e9, pose_fn=pose_fn)
    want = np.empty((300, 3))
    for k in range(300):          # Sim.scan's per-point loop
        R, p = sim.pose(times[col[k]])
        want[k] = R.T @ (world[k] - p)
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("name,config", [("drive", "mulran_os1-64"),
                                         ("walk", "dlio_default_os1-64")])
def test_scans_follow_the_seed_not_the_order(name, config):
    cfg = _sensor_cfg(config, rows=8, cols=128)
    a = make_sensor(cfg, _traffic(name), 2 ** 31 + 77)
    b = make_sensor(cfg, _traffic(name), 2 ** 31 + 77)
    c = make_sensor(cfg, _traffic(name), 2 ** 31 + 78)
    late = b.scan(900)                # b makes the far scene first
    for i in (0, 3, 900):
        ha, xa, ta = a.scan(i)
        hb, xb, tb = (b.scan(i) if i != 900 else late)
        assert ha == hb
        np.testing.assert_array_equal(xa, xb)
        assert (ta is None) == (tb is None)
    assert not np.array_equal(a.scan(5)[1], c.scan(5)[1])


def test_points_in_view_and_times_in_the_sweep():
    cfg = _sensor_cfg("dlio_default_os1-64", rows=16, cols=128)
    s = make_sensor(cfg, _traffic("walk"), 1)
    header, xyz, pt = s.scan(40)
    assert header == pytest.approx(4.0)
    live = np.abs(xyz).sum(1) > 0
    r = np.linalg.norm(xyz[live], axis=1)
    elev = np.degrees(np.arcsin(xyz[live, 2] / r))
    assert live.mean() > 0.5
    assert r.max() < cfg["max_range"] and r.min() > cfg["min_range"]
    assert elev.min() >= -16.61 and elev.max() <= 16.61
    assert pt.min() >= 0.0 and pt.max() < 0.1
    assert np.all(np.diff(pt[live]) >= 0)


def test_staircase_never_comes_back():
    p = Path(_traffic("drive")["path"], 9)
    t = np.arange(0.0, 600.0, 0.5)
    _, pos = p.pose(t)
    d = np.linalg.norm(pos[:, None, :2] - pos[None, :, :2], axis=-1)
    gap = np.abs(t[:, None] - t[None, :]) > 30.0
    assert d[gap].min() > 30.0
