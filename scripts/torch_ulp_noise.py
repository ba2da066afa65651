#!/usr/bin/env python3
"""The reference's own noise on the robustness tests' draws, beside the
port's distance from it (tests/test_torch_robustness.py,
tests/test_torch_aggressive_motion.py).

    JAX_PLATFORMS=cpu python3 scripts/torch_ulp_noise.py

(~8 min on one core.) Prints:
1. per step, on the aggressive-rotation draw's first 20 scans, on the
   one-plane world's 20 scans and on the delayed-sync outbox draw's 50
   (tests/test_torch_keyframe_eviction.py): the reference's move under a
   one-ulp change of every point's x from the same state, the port's
   distance from the reference from the same state, and whether the
   keyframe and gate decisions of the three agree;
2. the 8 s aggressive draw's ATE: the reference unperturbed and under a
   one-ulp change of every point's y (up), z (up) or x (down), and the
   port's own run.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from noetic_slam_tpu.runtime.pipeline import (  # noqa: E402
    OdometryPipeline as JaxPipeline,
)
from noetic_slam_tpu_torch.config import (  # noqa: E402
    CapacityConfig,
    DlioConfig,
    KeyframeConfig,
    TsdfConfig,
)
from noetic_slam_tpu_torch.runtime.pipeline import (  # noqa: E402
    OdometryPipeline,
)
from noetic_slam_tpu_torch.utils import synthetic  # noqa: E402
from tests.test_aggressive_motion import aggressive_pose_of  # noqa: E402
from tests.test_torch_aggressive_motion import (  # noqa: E402
    _cfg as aggressive_cfg,
)
from tests.torch_lockstep import Trio, ate, run, small_cfg  # noqa: E402
from tests.torch_parity import jax_cfg  # noqa: E402


def outbox_cfg():
    """tests/test_torch_keyframe_eviction.py's outbox configuration."""
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=6, max_submap_kf=4,
            outbox_slots=32),
        keyframe=KeyframeConfig(thresh_dist=0.25, thresh_rot=45.0),
        adaptive=False,
        tsdf=TsdfConfig(voxel_size=0.25, truncation=0.75, max_blocks=4096,
                        space_carving=False, scan_block_cap=1024))


def per_step(tag, cfg, sim, scans):
    trio = Trio(cfg, {})
    run(sim, trio, scans)
    print(f"{tag}: step, reference's one-ulp move [m], port - reference "
          f"[m], decisions (keyframe, gate) equal: reference/ulp, "
          f"reference/port")
    for i, s in enumerate(trio.steps):
        j, u, t = s["jax"], s["ulp"], s["port"]
        print(f"  {i:3d} {s['ref_dp']:.4f} {s['dp']:.4f} {u == j} {t == j}")


def main():
    torch.set_num_threads(1)
    agg = synthetic.make_sim(duration=8.0, n_points=2048, calib_time=3.1,
                             seed=23, pose_fn=aggressive_pose_of)
    scans = [agg.scan(s) for s in range(len(agg.scan_stamps))]
    per_step("aggressive rotation, first 20 scans", aggressive_cfg(True),
             agg, scans[:20])

    rng = np.random.default_rng(9)
    g = np.c_[rng.uniform(-60, 60, 30000), rng.uniform(-60, 60, 30000),
              np.zeros(30000)].astype(np.float32)
    plane = synthetic.make_sim(duration=2.0, n_points=1024, calib_time=3.1,
                               seed=24, imu_noise=0.003, world_pts=g)
    per_step("one-plane world", small_cfg(), plane,
             [plane.scan(s) for s in range(len(plane.scan_stamps))])

    outbox = synthetic.make_sim(duration=10.0, scan_hz=5.0, n_points=1024,
                                calib_time=3.1, seed=21)
    per_step("delayed-sync outbox draw", outbox_cfg(), outbox,
             [outbox.scan(s) for s in range(len(outbox.scan_stamps))])

    step = None
    for axis, toward in ((None, None), (1, np.inf), (2, np.inf),
                         (0, -np.inf)):
        moved = scans
        if axis is not None:
            moved = []
            for h, xyz, pt in scans:
                x = xyz.copy()
                x[:, axis] = np.nextafter(x[:, axis], np.float32(toward))
                moved.append((h, x, pt))
        pipe = JaxPipeline(jax_cfg(aggressive_cfg(True)))
        if step is not None:
            pipe._step = step
        run(agg, pipe, moved)
        step = pipe._step
        what = ("unperturbed" if axis is None else
                f"{'xyz'[axis]} {'up' if toward > 0 else 'down'} one ulp")
        print(f"aggressive 8 s ATE, reference {what}: "
              f"{ate(agg, pipe.flush()):.4f} m")
    own = OdometryPipeline(aggressive_cfg(True), device="cpu")
    run(agg, own, scans)
    print(f"aggressive 8 s ATE, port: {ate(agg, own.flush()):.4f} m")


if __name__ == "__main__":
    main()
