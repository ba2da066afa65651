#!/usr/bin/env python3
"""What one loop closure does to the map on the drifting loop
(tests/test_slam_system.py:139-191: a 100 m circle at 5 Hz, 2048 points, a
starved GICP, IMU noise), in both packages, on several draws of its drift.
CPU only:

    JAX_PLATFORMS=cpu python3 scripts/drift_draws.py

The starved registration turns any rounding difference into another drift,
so each draw is the loop with 0 or 1 mm added to one point of scan 1. For
each draw it prints, for the JAX ``SlamSystem``, the port's, and JAX
resumed from the port's checkpoint just before its closure (the reference's
closure on the port's draw): the ATE, whether the loop closed, the
correction, and the surface's median error against the world (and the
surface's point count) before and after one ``maybe_close_loop``; and the largest gap between JAX's
trajectories of the two draws (the odometry's, which a closure does not
rewrite). Then the same from rest
(``synthetic.ramp_start``) with the drift that chip_smoke.py's phase 10 adds
(``synthetic.linear_drift``)
through ``SlamSystem.set_keyframe_poses`` before the port's checkpoint.

It first prints the signed distances that one hit's band samples carry
in each package's TSDF fusion. Each run takes about a minute on one core;
the whole script about six."""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch
from scipy.spatial import cKDTree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from noetic_slam_tpu.runtime.slam import SlamSystem as JaxSlam  # noqa: E402
from noetic_slam_tpu_torch import SlamSystem  # noqa: E402
from noetic_slam_tpu_torch.utils import synthetic  # noqa: E402
from tests.torch_parity import jax_cfg  # noqa: E402

SYS = dict(loop_radius=5.0, loop_min_gap=15)


def _feed(slam, sim, scans, perturb_mm: float) -> None:
    i = 0
    for k, (h, xyz, pt) in enumerate(scans):
        if k == 1 and perturb_mm:
            xyz = xyz.copy()
            xyz[0, 0] += 1e-3 * perturb_mm
        while (i < len(sim.imu_stamps)
               and sim.imu_stamps[i] <= h + pt.max() + 0.02):
            slam.push_imu(sim.imu_stamps[i], sim.imu_ang[i], sim.imu_acc[i])
            i += 1
        slam.process_scan(h, xyz, pt)
    slam.sync_graph()


def _close(name: str, slam, sim, resumed: bool = False):
    """One maybe_close_loop with the surface median error around it, then
    the trajectory's ATE (not for a resumed run). Returns the trajectory."""
    tree = cKDTree(sim.world)

    def median():
        pts = slam.surface_points(2.0)
        return float(np.median(tree.query(pts)[0])), len(pts)

    m0, n0 = median()
    closed = slam.maybe_close_loop()
    m1, n1 = median()
    corr = slam.closure_log[-1]["correction_m"] if closed else 0.0
    traj = None if resumed else slam.flush()
    ate_s = "(resumed)" if resumed else f"{_ate(traj, sim):.4f} m"
    print(f"  {name:<26} ATE {ate_s:<10} closed {closed!s:<5} correction "
          f"{corr:.3f} m; surface median {m0:.3f} -> {m1:.3f} m "
          f"({100 * (m1 / m0 - 1):+.0f}%), of {n0} -> {n1} surface points",
          flush=True)
    return traj


def _ate(traj, sim) -> float:
    return synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                              sim.gt_pos)


def draw(tmp: str, from_rest: bool, mm: float):
    """One draw in both packages; returns JAX's trajectory (as the test
    has it) or None."""
    cfg = synthetic.drift_loop_cfg()
    sim = synthetic.drift_loop_sim(from_rest)
    # a scan draws fresh points from the sim's generator: every run of the
    # draw gets these, the ones the tests feed
    scans = [sim.scan(k) for k in range(len(sim.scan_stamps))]
    how = "from rest + drift" if from_rest else "as the test"
    print(f"{how}, +{mm:g} mm on one point of scan 1:", flush=True)
    jtraj = None
    if not from_rest:
        jslam = JaxSlam(jax_cfg(cfg), **SYS)
        _feed(jslam, sim, scans, mm)
        jtraj = _close("JAX", jslam, sim)
        del jslam
    slam = SlamSystem(cfg, device="cpu", **SYS)
    _feed(slam, sim, scans, mm)
    if from_rest:
        n = slam._synced_total
        q2, p2 = synthetic.linear_drift(slam.graph.node_q[:n].numpy(),
                                        slam.graph.node_p[:n].numpy(),
                                        synthetic.DRIFT_LOOP_YAW,
                                        synthetic.DRIFT_LOOP_SHIFT)
        slam.set_keyframe_poses(q2, p2)
    path = os.path.join(tmp, "port_pre.npz")
    slam.save(path)
    _close("port", slam, sim)
    del slam
    resumed = JaxSlam(jax_cfg(cfg), **SYS)
    resumed.load(path)
    _close("JAX on the port's state", resumed, sim, resumed=True)
    return jtraj


def band_distances() -> None:
    """The signed distances one hit's band samples carry in each package's
    TSDF fusion (JAX's compiled, as its pipeline and archive run it): the
    surface extraction keeps voxels with |distance| < 0.2 m, so a value a
    rounding below 0.2 decides which voxels are surface."""
    import jax

    from noetic_slam_tpu.models import tsdf as jtsdf
    from noetic_slam_tpu_torch.models import tsdf as ttsdf

    cfg = synthetic.drift_loop_cfg()
    pt = np.array([[5.0, 0.0, 0.0]], np.float32)
    valid = np.ones(1, bool)
    origin = np.zeros(3, np.float32)
    _, jd, _ = jax.jit(jtsdf._ray_samples, static_argnums=0)(
        jax_cfg(cfg).tsdf, pt, valid, origin)
    _, td, _ = ttsdf._ray_samples(cfg.tsdf, torch.from_numpy(pt),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(origin))
    fmt = lambda v: " ".join(f"{x:.9g}" for x in v)  # noqa: E731
    print(f"band sample distances: JAX {fmt(np.asarray(jd))}; port "
          f"{fmt(td.numpy())}", flush=True)


def main() -> int:
    torch.set_num_threads(1)
    band_distances()
    with tempfile.TemporaryDirectory() as tmp:
        trajs = [draw(tmp, False, mm) for mm in (0.0, 1.0)]
        gap = np.linalg.norm(trajs[0][:, 1:4] - trajs[1][:, 1:4], axis=-1)
        print(f"JAX's trajectories of the two draws: largest gap "
              f"{gap.max():.3f} m", flush=True)
        for mm in (0.0, 1.0):
            draw(tmp, True, mm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
