"""The slice end to end on the committed MulRan-format fixture (real
ingest: CSV/bin parsing, event-ordered replay, static calibration, no
per-point times): the JAX pipeline and the port's, both with the fused
TSDF step, must each keep the ATE under 0.05 m."""

import os

import numpy as np
import pytest
import torch

from noetic_slam_tpu.io.replay import replay_dataset as jax_replay
from noetic_slam_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline
from noetic_slam_tpu.utils.synthetic import ate_rmse
from noetic_slam_tpu_torch.config import CapacityConfig, DlioConfig, TsdfConfig
from noetic_slam_tpu_torch.io.mulran import MulranDataset
from noetic_slam_tpu_torch.io.replay import replay_dataset
from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
from tests.torch_parity import jax_cfg

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mulran_mini")
ATE_MAX = 0.05      # [m]
# no deskew on motion-distorted scans: the two runs drift apart a little
# more than on the synthetic replay (see test_torch_slice_synthetic.py);
# measured max 2.8 cm over the fixture's 85 scans
POS_MAX = 0.05      # [m]

pytestmark = pytest.mark.skipif(not os.path.isdir(FIXTURE),
                                reason="mulran_mini fixture not present")


def _cfg():
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=128,
            max_imu_window=64, max_keyframes=64, max_submap_kf=32,
            max_trajectory=512),
        tsdf=TsdfConfig(max_blocks=256))


def test_mulran_fixture_matches_jax():
    ds = MulranDataset.load(FIXTURE)
    jpipe = JaxPipeline(jax_cfg(_cfg()), with_tsdf=True)
    jstats = jax_replay(ds, jpipe)
    pipe = OdometryPipeline(_cfg(), device="cpu", with_tsdf=True)
    stats = replay_dataset(ds, pipe)
    assert stats["n_scans"] == jstats["n_scans"] >= 60
    assert stats["n_imu"] == jstats["n_imu"]

    traj, jtraj = pipe.flush(), jpipe.flush()
    assert traj.shape == jtraj.shape == (stats["n_scans"], 8)
    np.testing.assert_array_equal(traj[:, 0], jtraj[:, 0])
    gap = np.linalg.norm(traj[:, 1:4] - jtraj[:, 1:4], axis=-1)
    assert gap.max() < POS_MAX, gap
    for t in (traj, jtraj):
        ate = ate_rmse(t[:, 0], t[:, 1:4], ds.gt_stamps, ds.gt_poses[:, :, 3])
        assert ate < ATE_MAX, ate
    assert int(pipe.tsdf_state.num_blocks) > 0
