"""The keyframe-sync protocol of tests/test_pipelined_sync.py: pipelined
against the exact drain, run through both packages' ``SlamSystem`` on the
same scans (the port on the CPU), and a checkpoint without the outbox
fields (staleness with closures: tests/test_torch_pipelined_staleness.py).

Each package is held to the JAX test's own contract, and the two packages
to each other: the same keyframes handed to the graph, the archive and the
descriptor store, none lost, and graph nodes within ``POS_TOL`` (the
replay tolerance of tests/test_torch_slice_synthetic.py)."""

import os

import jax
import numpy as np
import pytest
import torch

from noetic_slam_tpu.runtime import checkpoint as jck
from noetic_slam_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline
from noetic_slam_tpu.runtime.slam import SlamSystem as JaxSlam
from noetic_slam_tpu_torch.config import (
    CapacityConfig,
    DlioConfig,
    KeyframeConfig,
    TsdfConfig,
)
from noetic_slam_tpu_torch.models.odometry import init_state
from noetic_slam_tpu_torch.runtime import checkpoint as ck
from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
from noetic_slam_tpu_torch.runtime.slam import SlamSystem
from noetic_slam_tpu_torch.utils import synthetic
from tests.torch_parity import jax_cfg, to_np

torch.set_num_threads(1)
CPU = "cpu"
POS_TOL = 0.05       # [m] a graph node (a keyframe pose) over a replay


def _cfg():
    """tests/test_pipelined_sync.py:30-39's configuration."""
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=4096, max_ds_points=2048, max_deskew_frames=1024,
            max_imu_window=64, max_keyframes=16, max_submap_kf=8,
            outbox_slots=8),
        keyframe=KeyframeConfig(thresh_dist=0.2, thresh_rot=45.0),
        adaptive=False,
        tsdf=TsdfConfig(voxel_size=0.2, truncation=0.6, max_blocks=4096,
                        space_carving=False))


def _run(slam, sim, scans, batch=4, sync="pipelined"):
    """tests/test_pipelined_sync.py:42-58's loop."""
    imu_i = 0
    for b0 in range(0, len(scans), batch):
        chunk = scans[b0: b0 + batch]
        through = max(h + pt.max() for h, _, pt in chunk) + 0.02
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= through):
            slam.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1
        slam.process_scans(chunk)
        if sync == "pipelined":
            slam.sync_pipelined()
        elif sync == "exact":
            slam.sync_graph()


def _summary(slam):
    def g(x):
        return (to_np(x) if isinstance(x, torch.Tensor)
                else np.asarray(jax.device_get(x)))

    n = int(g(slam.graph.n_nodes))
    return {"nodes": n, "node_p": g(slam.graph.node_p)[:n],
            "lost": slam.sync_lost_keyframes,
            "archived": len(slam.archive) if slam.archive else 0,
            "desc": slam.desc_store.count if slam.desc_store else 0,
            "total": slam._synced_total}


def _same_handoff(a, b, tol):
    assert a["lost"] == b["lost"] == 0
    for k in ("nodes", "total", "archived", "desc"):
        assert a[k] == b[k], (k, a[k], b[k])
    np.testing.assert_allclose(a["node_p"], b["node_p"], atol=tol)


def test_pipelined_matches_exact_drain():
    """tests/test_pipelined_sync.py:61: the port's pipelined and exact
    runs hand off the same keyframes (node count, node poses, archive,
    descriptors, none lost), and JAX's pipelined run the same keyframes
    as the port's."""
    sim = synthetic.make_sim(duration=2.5, n_points=2048, calib_time=3.1,
                             seed=7)
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    runs = {}
    for mode in ("exact", "pipelined"):
        slam = SlamSystem(_cfg(), enable_tsdf=True,
                          enable_loop_closure=True, loop_min_gap=100,
                          pipelined=(mode == "pipelined"), device=CPU)
        _run(slam, sim, scans, sync=mode)
        slam.sync_graph()          # final exact drain in both modes
        runs[mode] = _summary(slam)
    a, b = runs["exact"], runs["pipelined"]
    assert a["nodes"] > 3 and a["archived"] == a["nodes"]
    _same_handoff(a, b, 1e-6)

    jslam = JaxSlam(jax_cfg(_cfg()), enable_tsdf=True,
                    enable_loop_closure=True, loop_min_gap=100,
                    pipelined=True)
    _run(jslam, sim, scans, sync="pipelined")
    jslam.sync_graph()
    _same_handoff(_summary(jslam), b, POS_TOL)


def test_checkpoint_missing_outbox_fields_degrade_gracefully(tmp_path):
    """tests/test_pipelined_sync.py:190: a JAX checkpoint written before
    the outbox ring existed (its ``odom/ob_*`` fields removed) raises a
    clear error through the port's bare ``load_checkpoint`` and loads
    through its ``load_pipeline`` with init-shaped outbox fields, every
    other field as JAX's ``load_pipeline`` restores it."""
    cfg = _cfg()
    jpipe = JaxPipeline(jax_cfg(cfg))
    from noetic_slam_tpu.models.odometry import init_state as jinit

    jpipe.state = jinit(jax_cfg(cfg))
    jpipe.calibrated = True
    path = os.path.join(tmp_path, "old.nst.npz")
    jck.save_pipeline(path, jpipe)
    data = dict(np.load(path, allow_pickle=False))
    stripped = [k for k in data if k.startswith("odom/ob_")]
    assert stripped
    for k in stripped:
        del data[k]
    np.savez_compressed(path, **data)

    with pytest.raises(ValueError, match="ob_"):
        ck.load_checkpoint(path, CPU)
    pipe = OdometryPipeline(cfg, device=CPU)
    ck.load_pipeline(path, pipe)
    jpipe2 = JaxPipeline(jax_cfg(cfg))
    jck.load_pipeline(path, jpipe2)
    fresh = init_state(cfg, CPU)
    for name in pipe.state._fields:
        got = to_np(getattr(pipe.state, name))
        if name.startswith("ob_"):
            np.testing.assert_array_equal(got,
                                          to_np(getattr(fresh, name)))
        want = np.asarray(jax.device_get(getattr(jpipe2.state, name)))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert int(pipe.state.ob_seq.sum()) == 0
    assert pipe.calibrated and pipe.prev_header == jpipe2.prev_header
