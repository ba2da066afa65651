"""The slice end to end on the synthetic replay: the fused odometry + TSDF
step through the JAX ``OdometryPipeline`` and through the port's, on the
same scans; per-scan positions must agree and both trajectories must
track the ground truth."""

import numpy as np
import torch

from noetic_slam_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline
from noetic_slam_tpu.utils import synthetic
from noetic_slam_tpu_torch.config import CapacityConfig, DlioConfig, TsdfConfig
from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
from tests.torch_parity import jax_cfg

torch.set_num_threads(1)

# Per-scan agreement: one registration step of the reference moves by up
# to ~1.1 cm under a one-ulp input change (tests/test_torch_odometry.py),
# and registration pulls both back to the map, so the gap does not grow.
# Measured on this sequence: max 2.4 cm, RMS 0.9 cm. The bounds are twice
# that: another CPU's BLAS/XLA kernels round differently, which is another
# draw of the same noise.
POS_MAX = 0.05       # [m]
POS_RMS = 0.02       # [m]
ATE_MAX = 0.05       # [m], tests/test_odometry_e2e.py


def _cfg():
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=4096, max_ds_points=2048, max_deskew_frames=1024,
            max_imu_window=64, max_keyframes=32, max_submap_kf=8),
        tsdf=TsdfConfig(max_blocks=256))


def _replay(pipe, sim, scans):
    imu_i = 0
    for h, xyz, pt in scans:
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= h + pt.max() + 0.02):
            pipe.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1
        pipe.process_scan(h, xyz, pt)
    return pipe.flush()


def test_synthetic_replay_matches_jax():
    sim = synthetic.make_sim(duration=2.0, n_points=2048, calib_time=3.1,
                             seed=1)
    # generate once: sim.scan() draws from a shared generator
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    jpipe = JaxPipeline(jax_cfg(_cfg()), with_tsdf=True)
    jax_traj = _replay(jpipe, sim, scans)
    pipe = OdometryPipeline(_cfg(), device="cpu", with_tsdf=True)
    traj = _replay(pipe, sim, scans)

    assert traj.shape == jax_traj.shape == (len(scans), 8)
    np.testing.assert_array_equal(traj[:, 0], jax_traj[:, 0])
    gap = np.linalg.norm(traj[:, 1:4] - jax_traj[:, 1:4], axis=-1)
    assert gap.max() < POS_MAX, gap
    assert np.sqrt(np.mean(gap ** 2)) < POS_RMS, gap
    for t in (traj, jax_traj):
        ate = synthetic.ate_rmse(t[:, 0], t[:, 1:4], sim.gt_stamps,
                                 sim.gt_pos)
        assert ate < ATE_MAX, ate
    assert pipe.submap_overflow == 0
    assert int(pipe.tsdf_state.num_blocks) > 0
    # control flow read on the host: >= 2 per registered scan
    assert pipe.host_syncs >= 2 * (len(scans) - 1)
