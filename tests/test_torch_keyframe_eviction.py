"""Keyframe eviction past saturation in the whole system
(tests/test_keyframe_eviction.py:118-213): the pose graph tracking evicted
keyframes, and the outbox hand-off under delayed sync, run through both
packages' ``SlamSystem`` on the same scans (the port on the CPU).

Each package is held to the JAX test's own contract, and the two packages
to each other. Graph tracking (2,048 points into a 16-keyframe submap):
trajectories within ``POS_TOL`` a scan (the replay tolerance of
tests/test_torch_slice_synthetic.py), the same keyframes, graph and slot
-> node map, nodes within ``POS_TOL``. The outbox case (1,024 points at
5 Hz into a 4-keyframe submap) is noise-dominated in the reference itself:
from the same state, one ulp on every point's x moves its step by
0.2-12 cm and flips its keyframe decision on 8 of the 50 steps
(scripts/torch_ulp_noise.py), so independent runs are held to keyframe
totals within ``KF_FLIPS`` and the same hand-off contract, not to each
other's poses. Both cases run a shorter draw than the JAX tests (fewer
scans), still past saturation."""

import jax
import numpy as np
import torch

from noetic_slam_tpu.runtime.slam import SlamSystem as JaxSlam
from noetic_slam_tpu_torch.config import (
    CapacityConfig,
    DlioConfig,
    KeyframeConfig,
    TsdfConfig,
)
from noetic_slam_tpu_torch.runtime.slam import SlamSystem
from noetic_slam_tpu_torch.utils import synthetic
from tests.torch_parity import jax_cfg, to_np

torch.set_num_threads(1)
CPU = "cpu"
POS_TOL = 0.05       # [m] a pose or graph node over a replay
KF_FLIPS = 2         # net keyframe decisions the outbox draw may flip


def _np(x):
    return to_np(x) if isinstance(x, torch.Tensor) else np.asarray(
        jax.device_get(x))


def _run(slam, sim, scans, sync_every):
    """The JAX tests' loop: IMU through each sweep's end, one scan at a
    time, ``sync_graph`` after every ``sync_every``-th scan and at the
    end."""
    imu_i = 0
    for s, (header, xyz, pt) in enumerate(scans):
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= header + pt.max() + 0.02):
            slam.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1
        slam.process_scan(header, xyz, pt)
        if s % sync_every == sync_every - 1:
            slam.sync_graph()
    slam.sync_graph()


def _both(cfg, sim, sync_every, **kw):
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    port = SlamSystem(cfg, device=CPU, **kw)
    jslam = JaxSlam(jax_cfg(cfg), **kw)
    for slam in (port, jslam):
        _run(slam, sim, scans, sync_every)
    return port, jslam


def _same_graph(port, jslam):
    """Lossless in both, trajectories within POS_TOL a scan, the same
    keyframes and graph, nodes within POS_TOL. Returns the keyframe
    total."""
    for slam in (port, jslam):
        assert slam.sync_lost_keyframes == 0
    traj, jtraj = port.flush(), jslam.flush()
    assert traj.shape == jtraj.shape
    gap = np.linalg.norm(traj[:, 1:4] - jtraj[:, 1:4], axis=-1)
    assert gap.max() < POS_TOL, gap.max()
    total = int(_np(port.odometry.state.kf_total))
    assert total == int(_np(jslam.odometry.state.kf_total))
    for f in ("n_nodes", "n_edges"):
        assert int(_np(getattr(port.graph, f))) == int(
            _np(getattr(jslam.graph, f))), f
    n = int(_np(port.graph.n_nodes))
    np.testing.assert_allclose(_np(port.graph.node_p)[:n],
                               _np(jslam.graph.node_p)[:n], atol=POS_TOL)
    return total


def _tiny_cfg(max_kf):
    """tests/test_keyframe_eviction.py:27-33's configuration."""
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=256,
            max_imu_window=64, max_keyframes=max_kf, max_submap_kf=16),
        keyframe=KeyframeConfig(thresh_dist=0.5, thresh_rot=45.0),
        adaptive=False)


def test_graph_tracks_evicted_keyframes():
    """tests/test_keyframe_eviction.py:118 at 6 s: synced every scan, every
    keyframe ever created becomes a node chained by edges, though the
    6-slot store evicts; each resident slot's node holds that keyframe's
    pose; the same slot -> node map in both packages."""
    sim = synthetic.make_sim(duration=6.0, n_points=2048, calib_time=3.1,
                             seed=21)
    port, jslam = _both(_tiny_cfg(6), sim, 1, enable_tsdf=False,
                        enable_loop_closure=True, loop_min_gap=1000)
    total = _same_graph(port, jslam)
    assert total > 6                       # the store saturated
    assert port._slot_node == jslam._slot_node
    for slam in (port, jslam):
        st = slam.odometry.state
        total = int(_np(st.kf_total))
        assert int(_np(slam.graph.n_nodes)) == total
        assert int(_np(slam.graph.n_edges)) == total - 1
        assert len(slam._slot_node) >= int(_np(st.kf_count))
        nodes = list(slam._slot_node.values())
        assert len(set(nodes)) == len(nodes)
        kf_pos, seq = _np(st.kf_pos), _np(st.kf_seq)
        node_p = _np(slam.graph.node_p)
        for slot, node in slam._slot_node.items():
            if seq[slot] > 0 and slot < int(_np(st.kf_count)):
                np.testing.assert_allclose(node_p[node], kf_pos[slot],
                                           atol=1e-5)


def test_outbox_lossless_handoff_under_delayed_sync(tmp_path):
    """tests/test_keyframe_eviction.py:172 at 10 s: one sync per 32-scan
    stretch on a 6-slot store that evicts constantly; the 32-slot outbox
    hands every keyframe ever created to the graph and the archive, none
    lost, in both packages. Then the archived-candidate data of a closure
    (JAX slam.py:977-1011, the port's ``_candidate_data``): the port
    resumed from JAX's checkpoint reads each evicted keyframe's cloud,
    validity, pose and covariances from the archive as JAX does."""
    cfg = DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=6, max_submap_kf=4,
            outbox_slots=32),
        keyframe=KeyframeConfig(thresh_dist=0.25, thresh_rot=45.0),
        adaptive=False,
        tsdf=TsdfConfig(voxel_size=0.25, truncation=0.75, max_blocks=4096,
                        space_carving=False, scan_block_cap=1024))
    sim = synthetic.make_sim(duration=10.0, scan_hz=5.0, n_points=1024,
                             calib_time=3.1, seed=21)
    port, jslam = _both(cfg, sim, 32, enable_tsdf=True,
                        enable_loop_closure=True, use_descriptors=False)
    totals = [int(_np(slam.odometry.state.kf_total))
              for slam in (port, jslam)]
    assert abs(totals[0] - totals[1]) <= KF_FLIPS, totals
    for slam, total in zip((port, jslam), totals):
        assert slam.sync_lost_keyframes == 0
        assert total > 3 * cfg.capacity.max_keyframes, total
        assert int(_np(slam.graph.n_nodes)) == total
        assert len(slam.archive) == total

    path = str(tmp_path / "jax.nst.npz")
    jslam.save(path)
    resumed = SlamSystem(cfg, device=CPU, enable_tsdf=True,
                         enable_loop_closure=True, use_descriptors=False)
    resumed.load(path)
    assert resumed._node_slot == jslam._node_slot
    evicted = [n for n in sorted(jslam.archive.entries)
               if n not in jslam._node_slot]
    assert len(evicted) >= totals[1] - cfg.capacity.max_keyframes
    for node in evicted[::8]:
        want = [_np(x) if x is not None else None
                for x in jslam._candidate_data(node)]
        got = [_np(x) if x is not None else None
               for x in resumed._candidate_data(node)]
        world, cov, q, p, valid, guard = got
        assert guard is None and want[5] is None   # no resident slot
        np.testing.assert_array_equal(valid, want[4])
        np.testing.assert_allclose(q, want[2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(p, want[3], rtol=0, atol=1e-6)
        np.testing.assert_allclose(world[valid], want[0][valid], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(cov[valid], want[1][valid], rtol=0,
                                   atol=1e-4)
