"""The port's command line (``noetic_slam_tpu_torch.cli``) against the JAX
package's (``noetic_slam_tpu.cli``), with the same arguments on the same
inputs: ``slam`` over the MulRan fixture (occupancy map, ESDF,
checkpoint), an Ouster capture (the packet path), a seeded bag (TSDF,
mesh, ESDF, renders, checkpoint) and the synthetic sequence. The
trajectories agree pose by pose within the replay tolerance (5 cm), with
the same pose count and stamps; both write the same files and the same
stdout lines. Also: ``export``, ``eval`` and ``info``, a port checkpoint
loaded by the JAX ``SlamSystem``, and ``slam`` raising without
``--device`` where there is no card.

The pcap and bag runs hold scans back through the port's ``NeedMoreImu``
(the IMU-starved scan); the MulRan run drives ``SlamSystem`` with
``map_backend="occupancy"``."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch
import yaml

from noetic_slam_tpu import cli as jcli
from noetic_slam_tpu.config.params import load_config as jload_config
from noetic_slam_tpu.runtime.slam import SlamSystem as JaxSlam
from noetic_slam_tpu_torch import cli as tcli
from noetic_slam_tpu_torch.config.params import load_config as tload_config
from noetic_slam_tpu_torch.runtime import slam as tslam
from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu
from noetic_slam_tpu_torch.utils import fixtures, synthetic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mulran_mini")
POSE_TOL = 0.05          # [m] per pose over a replay (ROADMAP Rules)
# tests/test_mulran_e2e.py's small capacities; the occupancy run also
# shrinks its block table
SMALL = {"capacity": {
    "max_points": 2048, "max_ds_points": 1024, "max_deskew_frames": 128,
    "max_imu_window": 64, "max_keyframes": 64, "max_submap_kf": 32,
    "max_trajectory": 512}}
CONFIGS = {
    "mulran": {**SMALL, "occupancy": {"max_blocks": 8192}},
    # tests/test_pcap_e2e.py's capacities for a 16 x 512 capture
    "pcap": {"capacity": {**SMALL["capacity"], "max_points": 16384,
                          "max_ds_points": 2048,
                          "max_deskew_frames": 512}},
    "bag": {**SMALL, "tsdf": {"max_blocks": 8192}},
    # the simulator's 4,096 points a scan, kept whole: decimated to 2,048
    # the registration is ill-conditioned in both packages (PERF.md §6)
    "synthetic": {"capacity": {**SMALL["capacity"], "max_points": 4096,
                               "max_ds_points": 2048,
                               "max_deskew_frames": 512},
                  "tsdf": {"max_blocks": 8192}},
}


def _inputs(kind, root):
    if kind == "mulran":
        return ["--mulran", FIXTURE, "--map-backend", "occupancy",
                "--max-scans", "30", "--esdf", "--checkpoint"]
    if kind == "pcap":
        d = os.path.join(root, "capture")
        fixtures.write_pcap_fixture(d)
        return ["--pcap", os.path.join(d, "fixture.pcap"), "--metadata",
                os.path.join(d, "metadata.json"), "--no-tsdf",
                "--max-scans", "15", "--checkpoint"]
    if kind == "synthetic":
        return ["--synthetic", "1.5", "--checkpoint"]
    sim = synthetic.make_sim(duration=1.5, n_points=2048, calib_time=3.1,
                             seed=9)
    path = os.path.join(root, "sim.bag")
    fixtures.write_sim_bag(path, sim, compression="bz2")
    return ["--bag", path, "--mesh", "--esdf", "--viz", "--checkpoint"]


def _main(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module",
                params=["mulran", "pcap", "bag", "synthetic"])
def run(request, tmp_path_factory):
    """One input through both command lines: the port's on the CPU,
    counting the scans its ``SlamSystem`` holds back for want of IMU."""
    kind = request.param
    root = str(tmp_path_factory.mktemp(f"cli_{kind}"))
    cfg = os.path.join(root, "cfg.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(CONFIGS[kind], f)
    argv = ["slam", *_inputs(kind, root), "--config", cfg]
    starved = []
    process_scan = tslam.SlamSystem.process_scan

    def counting(self, *a, **kw):
        try:
            return process_scan(self, *a, **kw)
        except NeedMoreImu:
            starved.append(a[0])
            raise

    mp = pytest.MonkeyPatch()
    mp.setattr(tslam.SlamSystem, "process_scan", counting)
    try:
        port = _main(tcli, argv + ["--out", os.path.join(root, "port"),
                                   "--device", "cpu"])
    finally:
        mp.undo()
    ref = _main(jcli, argv + ["--out", os.path.join(root, "jax")])
    return {"kind": kind, "root": root, "cfg": cfg, "port": port,
            "jax": ref, "starved": starved}


def _fields(stdout):
    """Each stdout line's field: the text before its first number or
    colon (the JSON line: its keys)."""
    out = []
    for line in stdout.splitlines():
        if line.startswith("{"):
            out.append(sorted(json.loads(line)))
        else:
            out.append(re.split(r"[:\d]", line, maxsplit=1)[0])
    return out


def test_slam_writes_the_same_files_and_lines(run):
    (rc, out), (jrc, jout) = run["port"], run["jax"]
    assert rc == jrc == 0
    assert _fields(out) == _fields(jout)
    names = sorted(os.listdir(os.path.join(run["root"], "jax")))
    assert sorted(os.listdir(os.path.join(run["root"], "port"))) == names
    for name in names:
        assert os.path.getsize(os.path.join(run["root"], "port", name)) > 0
    want = {"mulran": {"occupied.ply", "esdf.npz", "esdf_slice.png",
                       "state.nst.npz"},
            "pcap": {"state.nst.npz"},
            "synthetic": {"tsdf_surface.ply", "state.nst.npz"},
            "bag": {"tsdf_surface.ply", "tsdf_mesh.ply", "esdf.npz",
                    "esdf_slice.png", "state.nst.npz", "trajectory.png",
                    "map_views.png", "map_viewer.html"}}[run["kind"]]
    assert want | {"trajectory.tum", "dlio_map.pcd"} <= set(names)
    line = [ln for ln in out.splitlines() if ln.startswith("trajectory:")]
    assert line == [ln for ln in jout.splitlines()
                    if ln.startswith("trajectory:")]


def test_slam_trajectory_matches_jax(run):
    traj = np.loadtxt(os.path.join(run["root"], "port", "trajectory.tum"))
    ref = np.loadtxt(os.path.join(run["root"], "jax", "trajectory.tum"))
    assert traj.shape == ref.shape and len(ref) >= 15
    np.testing.assert_array_equal(traj[:, 0], ref[:, 0])
    err = np.linalg.norm(traj[:, 1:4] - ref[:, 1:4], axis=1)
    assert err.max() < POSE_TOL, err.max()
    if run["kind"] in ("mulran", "synthetic"):
        ate = [float(o.split("ATE RMSE vs ground truth:")[1].split("m")[0])
               for _, o in (run["port"], run["jax"])]
        assert max(ate) < 0.5 and abs(ate[0] - ate[1]) < POSE_TOL


def test_slam_holds_imu_starved_scans(run):
    """Bag and capture: scans arrive before the IMU sample that covers
    their sweep; the replay loops catch the port's ``NeedMoreImu`` and run
    them later, losing none (the pose counts above)."""
    if run["kind"] in ("mulran", "synthetic"):
        # MulRan has no per-point times; the synthetic loop pushes the IMU
        # past each sweep first
        assert run["starved"] == []
    else:
        assert len(run["starved"]) > 0


def test_port_checkpoint_loads_in_jax(run):
    """The port's checkpoint, loaded by the JAX ``SlamSystem`` and by the
    port's: the same odometry state, keyframes and pose graph."""
    overrides = ({"map_backend": "occupancy"} if run["kind"] == "mulran"
                 else None)
    path = os.path.join(run["root"], "port", "state.nst.npz")
    jslam = JaxSlam(jload_config(run["cfg"], overrides=overrides))
    jslam.load(path)
    slam = tslam.SlamSystem(tload_config(run["cfg"], overrides=overrides),
                            device="cpu")
    slam.load(path)
    js, ts = jslam.odometry.state, slam.odometry.state
    assert int(np.asarray(js.kf_count)) == int(ts.kf_count) > 0
    traj = np.loadtxt(os.path.join(run["root"], "port", "trajectory.tum"))
    assert int(np.asarray(js.num_scans)) == len(traj)
    for f in ("p", "q", "v", "kf_pos", "kf_xyz"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy(), err_msg=f)
    assert int(np.asarray(jslam.graph.n_nodes)) == int(slam.graph.n_nodes)
    assert jslam._synced_total == slam._synced_total


def test_export_eval_and_info_print_the_same_fields(tmp_path):
    bags = []
    for cli, tag in ((tcli, "port"), (jcli, "jax")):
        bag = str(tmp_path / f"{tag}.bag")
        rc, out = _main(cli, ["export", "--mulran", FIXTURE, "--bag", bag,
                              "--compression", "bz2"])
        assert rc == 0
        bags.append(json.loads(out))
    # the bags themselves: tests/test_torch_ingest.py
    assert bags[0] == bags[1] and bags[0]["gt"] > 0
    traj = np.loadtxt(os.path.join(FIXTURE, "global_pose.csv"),
                      delimiter=",")
    tum = tmp_path / "gt.tum"
    np.savetxt(tum, np.column_stack(
        [traj[:, 0] * 1e-9, traj[:, 4], traj[:, 8], traj[:, 12],
         np.zeros((len(traj), 3)), np.ones(len(traj))]), fmt="%.9f")
    gt = os.path.join(FIXTURE, "global_pose.csv")
    got, want = (_main(c, ["eval", str(tum), gt]) for c in (tcli, jcli))
    assert got == want and json.loads(got[1])["ate_rmse_m"] < 1e-6
    (rc, out), (jrc, jout) = (_main(tcli, ["info", "--device", "cpu"]),
                              _main(jcli, ["info"]))
    assert rc == jrc == 0
    assert [ln.split(":")[0] for ln in out.splitlines()[:2]] == [
        "backend", "devices"] == [ln.split(":")[0]
                                  for ln in jout.splitlines()[:2]]
    assert out.startswith("backend: cpu\n")
    cfg = "\n".join(out.splitlines()[2:])
    assert json.loads(cfg) == json.loads("\n".join(jout.splitlines()[2:]))


def test_slam_without_device_raises_where_there_is_no_card(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["slam", "--synthetic", "1", "--out", str(tmp_path)],
                 ["info"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
    assert not os.path.exists(tmp_path / "trajectory.tum")
