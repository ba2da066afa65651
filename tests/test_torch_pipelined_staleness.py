"""tests/test_pipelined_sync.py:95 (pipelined staleness with closures),
run through both packages' ``SlamSystem`` (the port on the CPU) on the
drifting loop of tests/test_slam_system.py (``synthetic.drift_loop_sim``:
100 scans at 5 Hz with a starved GICP, so the odometry drifts and closures
correct it; the JAX test's 150-scan lap is beyond this file's budget).

JAX runs the whole loop with ``maybe_close_loop`` every second batch under
pipelined sync and checkpoints at ``RESUME`` scans; the port resumes from
that checkpoint and runs the rest the same way, through the revisit and
its closures. Independent runs of this starved sequence do not agree scan
by scan (tests/test_torch_slam_system.py), so the two are held to what does
not depend on the drift drawn: every keyframe in the graph chained by
edges, nothing lost, the same keyframe and closure counts, and the JAX
test's bound."""

import jax
import numpy as np
import torch

from noetic_slam_tpu.runtime.slam import SlamSystem as JaxSlam
from noetic_slam_tpu_torch.runtime.slam import SlamSystem
from noetic_slam_tpu_torch.utils import synthetic
from tests.torch_parity import jax_cfg, to_np

torch.set_num_threads(1)
CPU = "cpu"
BATCH = 4
CLOSE_EVERY = 2       # batches between maybe_close_loop calls (:128-139)
RESUME = 60           # scans JAX runs before the checkpoint (a batch edge)
ATE_MAX = 0.35        # [m] tests/test_pipelined_sync.py:150


def _run(slam, sim, scans, lo, hi, imu_i=0):
    """Scans [lo, hi) in batches of BATCH, ``maybe_close_loop`` (the
    pipelined entry sync) every CLOSE_EVERY batches counted from scan 0.
    Returns the next IMU index."""
    for b0 in range(lo, hi, BATCH):
        chunk = scans[b0: b0 + BATCH]
        through = max(h + pt.max() for h, _, pt in chunk) + 0.02
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= through):
            slam.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1
        slam.process_scans(chunk)
        if b0 % (CLOSE_EVERY * BATCH) == 0:
            slam.maybe_close_loop()
    return imu_i


def _check_lossless(slam, sim):
    slam.sync_graph()
    assert slam.sync_lost_keyframes == 0
    n_nodes = slam.graph.n_nodes
    n = int(to_np(n_nodes) if isinstance(n_nodes, torch.Tensor)
            else jax.device_get(n_nodes))
    assert n == slam._synced_total
    assert slam._edges_host >= slam._synced_total - 1
    traj = slam.flush()
    ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                             sim.gt_pos)
    assert ate < ATE_MAX, ate


def test_pipelined_staleness_is_lossless_with_closures(tmp_path):
    sim = synthetic.drift_loop_sim()
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    cfg = synthetic.drift_loop_cfg()
    kw = dict(enable_tsdf=True, enable_loop_closure=True, loop_min_gap=15,
              loop_radius=5.0, pipelined=True)
    path = str(tmp_path / "jax_resume.nst.npz")

    jslam = JaxSlam(jax_cfg(cfg), **kw)
    imu_i = _run(jslam, sim, scans, 0, RESUME)
    jslam.sync_graph()
    jslam.save(path)
    _run(jslam, sim, scans, RESUME, len(scans), imu_i)

    port = SlamSystem(cfg, device=CPU, **kw)
    port.load(path)
    assert port._synced_total > 0
    _run(port, sim, scans, RESUME, len(scans), imu_i)

    for slam in (jslam, port):
        _check_lossless(slam, sim)
        assert slam.loop_closures >= 1
    assert port._synced_total == jslam._synced_total
    assert port.loop_closures == jslam.loop_closures

