"""The whole system (``runtime/slam.py``) against the JAX ``SlamSystem`` on
the drifting closed loop of tests/test_slam_system.py (a 100 m circle at
5 Hz, 2048 points, IMU noise and a starved GICP budget, so the odometry
drifts and the loop closure has something to correct), and checkpoints
crossing between the two packages.

Two independent runs of this sequence cannot agree scan by scan: the
starved registration amplifies any rounding difference (the reference
against itself with 1 mm added to one point of one scan ends metres apart,
see PERF.md and scripts/drift_draws.py), so each run draws its own drift.
The independent runs are held to what does not depend on the draw (both
close the loop, with the same keyframe and closure counts, and track the
ground truth), and the JAX closure on the port's own draw, resumed from
the port's checkpoint, must do what the port's closure did there. The
per-scan comparison starts both packages from one state: JAX runs to
``HOLD`` scans before the end and saves; the port loads that checkpoint;
both run the last scans and close the loop."""

import jax
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from noetic_slam_tpu.runtime.slam import SlamSystem as JaxSlam
from noetic_slam_tpu_torch.runtime.slam import SlamSystem
from noetic_slam_tpu_torch.utils import synthetic
from tests.torch_parity import jax_cfg, to_np

torch.set_num_threads(1)
CPU = "cpu"
HOLD = 5              # scans both packages run from the shared state
POS_TOL = 0.05        # [m] per scan and per graph node (replay tolerance)
SYS = dict(loop_radius=5.0, loop_min_gap=15)


def _cfg():
    return synthetic.drift_loop_cfg()


class _Feed:
    """Scans of the drifting loop with their IMU samples, fed in order."""

    def __init__(self):
        self.sim = synthetic.drift_loop_sim()
        self.scans = [self.sim.scan(s)
                      for s in range(len(self.sim.scan_stamps))]
        self.tree = cKDTree(self.sim.world)

    def run(self, slam, lo, hi, imu_i=0):
        sim = self.sim
        for h, xyz, pt in self.scans[lo:hi]:
            while (imu_i < len(sim.imu_stamps)
                   and sim.imu_stamps[imu_i] <= h + pt.max() + 0.02):
                slam.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                              sim.imu_acc[imu_i])
                imu_i += 1
            slam.process_scan(h, xyz, pt)
        return imu_i

    def surface_median(self, slam):
        d, _ = self.tree.query(slam.surface_points(min_weight=2.0))
        return float(np.median(d))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run (checkpoint HOLD scans before the end, then the rest and
    the closure), the port resumed from that checkpoint, the port's own run
    of the whole sequence (checkpoint before its closure), and JAX resumed
    from that checkpoint closing the loop on the port's draw."""
    d = tmp_path_factory.mktemp("slam")
    feed = _Feed()
    n = len(feed.scans)
    out = {"feed": feed, "dir": d}

    jslam = JaxSlam(jax_cfg(_cfg()), **SYS)
    imu_i = feed.run(jslam, 0, n - HOLD)
    jslam.sync_graph()
    jslam.save(str(d / "jax_pre.npz"))
    feed.run(jslam, n - HOLD, n, imu_i)
    out["jax_med0"] = feed.surface_median(jslam)
    out["jax_closed"] = jslam.maybe_close_loop()
    out["jax_med1"] = feed.surface_median(jslam)
    out["jax"] = jslam

    slam = SlamSystem(_cfg(), device=CPU, **SYS)
    slam.load(str(d / "jax_pre.npz"))
    out["resumed_pre"] = _system_fields(slam)
    feed.run(slam, n - HOLD, n, imu_i)
    out["med0"] = feed.surface_median(slam)
    out["closed"] = slam.maybe_close_loop()
    out["med1"] = feed.surface_median(slam)
    out["resumed"] = slam
    slam.save(str(d / "port_post.npz"))
    out["resumed_post"] = _system_fields(slam)

    own = SlamSystem(_cfg(), device=CPU, **SYS)
    feed.run(own, 0, n)
    own.sync_graph()
    own.save(str(d / "port_own_pre.npz"))
    out["own_med0"] = feed.surface_median(own)
    out["own_closed"] = own.maybe_close_loop()
    out["own_med1"] = feed.surface_median(own)
    out["own"] = own

    jown = JaxSlam(jax_cfg(_cfg()), **SYS)
    jown.load(str(d / "port_own_pre.npz"))
    out["jown_med0"] = feed.surface_median(jown)
    out["jown_closed"] = jown.maybe_close_loop()
    out["jown_med1"] = feed.surface_median(jown)
    out["jown"] = jown
    return out


def _system_fields(slam):
    """Every field a checkpoint carries, as host arrays / values."""
    g = lambda x: to_np(x).copy() if isinstance(x, torch.Tensor) \
        else np.asarray(jax.device_get(x))                 # noqa: E731
    st = {f"odom/{k}": g(getattr(slam.odometry.state, k))
          for k in slam.odometry.state._fields if not k.startswith("grid_")}
    st.update({f"tsdf/{k}": g(v) for k, v in slam.tsdf._asdict().items()})
    st.update({f"graph/{k}": g(v) for k, v in slam.graph._asdict().items()})
    st.update({f"archive/{k}": v for k, v in slam.archive.pack().items()})
    st["desc"] = slam.desc_store.pack()["desc"]
    st["host"] = (dict(slam._slot_node), slam._synced_total,
                  slam.loop_closures, slam.sync_lost_keyframes,
                  list(slam.odometry.headers), slam.odometry.prev_header,
                  slam.odometry._flushed_scans)
    st["imu"] = slam.odometry._imu_stamps.copy()
    st["last_kf_pose"] = np.concatenate(slam._last_kf_pose)
    return st


def _fields_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if k == "host":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_both_close_the_drifting_loop_from_one_state(runs):
    """Resumed from the JAX checkpoint: the same last scans, the same
    closure, the same corrected graph and a map error that falls by at
    least 25% in both."""
    jslam, slam, feed = runs["jax"], runs["resumed"], runs["feed"]
    assert runs["jax_closed"] and runs["closed"]
    assert slam.loop_closures == jslam.loop_closures == 1
    assert slam._synced_total == jslam._synced_total
    jlog, log = jslam.closure_log[0], slam.closure_log[0]
    for k in ("source", "cand_node", "cur_node", "moved_keyframes",
              "archived"):
        assert log[k] == jlog[k], k
    assert abs(log["correction_m"] - jlog["correction_m"]) < POS_TOL
    n = slam._synced_total
    gap = np.linalg.norm(to_np(slam.graph.node_p)[:n]
                         - np.asarray(jslam.graph.node_p)[:n], axis=-1)
    assert gap.max() < POS_TOL, gap
    traj, jtraj = slam.flush(), jslam.flush()
    assert traj.shape == jtraj.shape == (len(feed.scans), 8)
    np.testing.assert_array_equal(traj[:-HOLD], jtraj[:-HOLD])
    step = np.linalg.norm(traj[-HOLD:, 1:4] - jtraj[-HOLD:, 1:4], axis=-1)
    assert step.max() < POS_TOL, step
    for med0, med1 in ((runs["jax_med0"], runs["jax_med1"]),
                       (runs["med0"], runs["med1"])):
        assert med0 > 0.4, med0          # there is drift to correct
        assert med1 < 0.75 * med0, (med0, med1)


def test_independent_runs_close_alike(runs):
    """The port's own run of the whole sequence: it closes the loop, with
    the JAX run's keyframe and closure counts, tracks the ground truth and
    loses no keyframe."""
    own, jslam, feed = runs["own"], runs["jax"], runs["feed"]
    assert runs["own_closed"]
    assert own.loop_closures == jslam.loop_closures == 1
    assert own._synced_total == jslam._synced_total
    assert int(own.odometry.state.kf_total) == int(
        jslam.odometry.state.kf_total)
    assert own.sync_lost_keyframes == 0 and own.loop_raced == 0
    traj = own.flush()
    ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], feed.sim.gt_stamps,
                             feed.sim.gt_pos)
    assert ate < 0.15, ate
    assert int(own.graph.n_edges) >= own._synced_total
    assert len(own.archive) == own._synced_total
    # host reads: the step's two a scan or more, plus the closure's
    assert own.host_syncs > 2 * len(feed.scans)


def test_reference_closes_the_ports_own_draw_alike(runs):
    """JAX resumed from the port's own run just before its closure: the
    same closure, the same corrected graph within the replay tolerance,
    and the same surface median error before and after (within 1 cm),
    whichever way the closure moved it on this draw."""
    own, jown = runs["own"], runs["jown"]
    assert runs["jown_closed"] == runs["own_closed"]
    assert jown.loop_closures == own.loop_closures
    jlog, log = jown.closure_log[0], own.closure_log[0]
    for k in ("source", "cand_node", "cur_node", "moved_keyframes"):
        assert log[k] == jlog[k], k
    assert abs(log["correction_m"] - jlog["correction_m"]) < POS_TOL
    n = own._synced_total
    gap = np.linalg.norm(to_np(own.graph.node_p)[:n]
                         - np.asarray(jown.graph.node_p)[:n], axis=-1)
    assert gap.max() < POS_TOL, gap
    for k in ("med0", "med1"):
        assert abs(runs[f"own_{k}"] - runs[f"jown_{k}"]) < 0.01, (
            k, runs[f"own_{k}"], runs[f"jown_{k}"])


def test_checkpoint_jax_to_port(runs):
    """The JAX checkpoint resumed in the port with every field equal."""
    jslam = JaxSlam(jax_cfg(_cfg()), **SYS)
    jslam.load(str(runs["dir"] / "jax_pre.npz"))
    _fields_equal(runs["resumed_pre"], _system_fields(jslam))


def test_checkpoint_port_to_jax(runs):
    """The port's post-closure checkpoint resumed in JAX with every field
    equal, and the archive volume JAX replays from it equal to the port's
    by block key."""
    slam = runs["resumed"]
    jslam = JaxSlam(jax_cfg(_cfg()), **SYS)
    jslam.load(str(runs["dir"] / "port_post.npz"))
    _fields_equal(runs["resumed_post"], _system_fields(jslam))
    # the archive volume JAX replayed from the file against the port's
    # replay of the same file (the closure updated the port's own volume
    # in place, in other chunk compositions): equal by block key, up to
    # rare samples on a voxel boundary that the two transforms round to
    # neighbouring voxels
    again = SlamSystem(_cfg(), device=CPU, **SYS)
    again.load(str(runs["dir"] / "port_post.npz"))
    a, b = again.archive.volume, jslam.archive.volume
    pad = np.iinfo(np.int32).max
    ka = {int(k): s for k, s in zip(to_np(a.dir_keys), to_np(a.dir_slots))
          if k != pad}
    kb = {int(k): s for k, s in zip(np.asarray(b.dir_keys),
                                    np.asarray(b.dir_slots)) if k != pad}
    assert ka.keys() == kb.keys()
    keys = sorted(ka)
    wa = to_np(a.weight)[[ka[k] for k in keys]]
    wb = np.asarray(b.weight)[[kb[k] for k in keys]]
    off = np.abs(wa - wb) > 1e-4 + 1e-5 * np.abs(wb)
    assert off.mean() < 1e-5, off.sum()
    assert abs(wa.sum() - wb.sum()) < 1e-5 * wb.sum()
