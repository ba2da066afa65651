"""tests/test_aggressive_motion.py's aggressive rotation (~69 deg/s peak
yaw rate, weaving translation), held between the JAX ``OdometryPipeline``
and the port's (``device="cpu"``) through the lockstep harness of
``tests/torch_lockstep.py``. The JAX test is marked ``slow``."""

import torch

from noetic_slam_tpu_torch.config import (
    CapacityConfig,
    DlioConfig,
    KeyframeConfig,
    PreprocConfig,
)
from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
from noetic_slam_tpu_torch.utils import synthetic
from tests.test_aggressive_motion import aggressive_pose_of
from tests.torch_lockstep import CPU, Trio, ate, run

torch.set_num_threads(1)
LOCKSTEP_SCANS = 20   # the first keyframes and a well-posed stretch
# The reference's own 8 s ATE on this draw: 0.18 m, and 0.19 / 0.38 /
# 0.32 m with every point's y / z moved up or x down by one ulp
# (scripts/torch_ulp_noise.py). The JAX test's 0.25 m bound sits inside
# that spread (ROADMAP Queue 3 item 3), so the port's run is held to the
# spread's top.
ATE_MAX = 0.40        # [m]
RAW_SCANS = 60        # the run without deskew: the draw's first 6 s


def _cfg(deskew: bool):
    """tests/test_aggressive_motion.py:41-48's configuration."""
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=4096, max_ds_points=2048, max_deskew_frames=1024,
            max_imu_window=64, max_keyframes=32, max_submap_kf=8),
        keyframe=KeyframeConfig(thresh_dist=1.0, thresh_rot=30.0),
        adaptive=False,
        preproc=PreprocConfig(deskew=deskew))


def test_aggressive_rotation_ate_bounded():
    """tests/test_aggressive_motion.py:64: the first LOCKSTEP_SCANS scans
    in lockstep with JAX with deskew on (the first keyframes' steps, on a
    ~100-200-correspondence target, are noise-dominated in the reference:
    0.36-0.90 m under one ulp); then the port alone over the JAX test's
    whole 8 s draw, within the reference's own one-ulp spread (ATE_MAX),
    and over the first RAW_SCANS clearly worse without deskew than with
    it (the JAX test's > 3x: deskew is load-bearing at this motion)."""
    sim = synthetic.make_sim(duration=8.0, n_points=2048, calib_time=3.1,
                             seed=23, pose_fn=aggressive_pose_of)
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    trio = Trio(_cfg(True), {})
    assert run(sim, trio, scans[:LOCKSTEP_SCANS]) == []
    trio.check(min_held=0.6)
    # the port's own run goes on alone (the IMU samples it already has are
    # pushed again and dropped as late)
    own = trio.own
    assert run(sim, own, scans[LOCKSTEP_SCANS:]) == []
    raw = OdometryPipeline(_cfg(False), device=CPU)
    assert run(sim, raw, scans[:RAW_SCANS]) == []
    traj = own.flush()
    a = ate(sim, traj)
    assert a < ATE_MAX, a
    assert ate(sim, raw.flush()) > 3.0 * ate(sim, traj[:RAW_SCANS])
