"""The port never imports JAX nor anything of the JAX package: in a fresh
interpreter whose import system refuses ``jax`` and ``noetic_slam_tpu``
(but not ``noetic_slam_tpu_torch``), every module of the port and every
module that ``chip_smoke.py`` imports import (the command line, the
ingest layer, the multi-sequence runtime, the live path, the grid NN
engine and the sharded paths among them; ``cli info`` runs), two small
steps of the
pipeline run on the CPU with each map backend, and a small SlamSystem
syncs its keyframes into the graph, the archive and the descriptors,
attempts a closure, and saves and loads a checkpoint."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import ast, importlib, pkgutil, sys

    def refused(name):
        return (name in ("jax", "noetic_slam_tpu")
                or name.startswith(("jax.", "jaxlib", "noetic_slam_tpu.")))

    class RefuseJax:
        def find_spec(self, name, path=None, target=None):
            if refused(name):
                raise ImportError("refused here: " + name)

    sys.meta_path.insert(0, RefuseJax())

    import noetic_slam_tpu_torch as pkg
    mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in mods:
        importlib.import_module(name)
    # the command line and the ingest layer are among them
    ingest = {"cli", "io.rosbag", "io.ouster", "io.pcap", "io.viz",
              "io.export", "io.replay", "runtime.native", "runtime.metrics",
              "utils.lz4frame", "utils.fixtures"}
    assert {pkg.__name__ + "." + m for m in ingest} <= set(mods), mods
    # so are the multi-sequence runtime and the live path
    entry = {"runtime.multi", "runtime.live", "parallel.batch", "io.player",
             "io.sensor_http"}
    assert {pkg.__name__ + "." + m for m in entry} <= set(mods), mods
    # and the grid NN engine and the sharded paths
    sharded = {"ops.gridnn", "parallel.mesh", "parallel.registration",
               "parallel.bundle_adjustment", "parallel.tsdf"}
    assert {pkg.__name__ + "." + m for m in sharded} <= set(mods), mods
    # chip_smoke.py imports inside its phases: import every module it names
    tree = ast.parse(open("chip_smoke.py").read())
    smoke = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    smoke |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    for name in sorted(smoke):
        assert not refused(name), name
        importlib.import_module(name)

    import numpy as np
    import torch
    from noetic_slam_tpu_torch.config import (
        CapacityConfig, DlioConfig, OccupancyConfig, TsdfConfig)
    from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
    from noetic_slam_tpu_torch.utils import synthetic

    torch.set_num_threads(1)
    cfg = DlioConfig(capacity=CapacityConfig(
        max_points=1024, max_ds_points=512, max_deskew_frames=256,
        max_imu_window=64, max_keyframes=8, max_submap_kf=4),
        tsdf=TsdfConfig(max_blocks=64, scan_block_cap=64),
        occupancy=OccupancyConfig(max_blocks=64, scan_block_cap=64))
    sim = synthetic.make_sim(duration=0.25, n_points=1024, calib_time=3.1,
                             seed=2)
    scans = [sim.scan(s) for s in range(2)]
    for backend in ("tsdf", "occupancy"):
        pipe = OdometryPipeline(cfg.replace(map_backend=backend),
                                device="cpu", with_tsdf=True)
        for i in range(len(sim.imu_stamps)):
            pipe.push_imu(sim.imu_stamps[i], sim.imu_ang[i], sim.imu_acc[i])
        for scan in scans:
            pipe.process_scan(*scan)
        traj = pipe.flush()
        assert traj.shape == (2, 8) and np.isfinite(traj).all(), traj
        assert int(pipe.tsdf_state.num_blocks) > 0
        assert type(pipe.tsdf_state).__name__ == (
            "OccupancyState" if backend == "occupancy" else "TsdfState")
    import os, tempfile
    from noetic_slam_tpu_torch import SlamSystem
    slam = SlamSystem(cfg.replace(keyframe=cfg.keyframe.__class__(
        thresh_dist=0.05)), device="cpu", loop_min_gap=1)
    for i in range(len(sim.imu_stamps)):
        slam.push_imu(sim.imu_stamps[i], sim.imu_ang[i], sim.imu_acc[i])
    slam.process_scans(scans)
    slam.maybe_close_loop()
    assert slam._synced_total >= 1 and len(slam.archive) >= 1
    assert slam.desc_store.count == slam._synced_total
    path = os.path.join(tempfile.mkdtemp(), "ck.npz")
    slam.save(path)
    again = SlamSystem(slam.cfg, device="cpu")
    again.load(path)
    assert again._synced_total == slam._synced_total
    import contextlib, io
    from noetic_slam_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["info", "--device", "cpu"]) == 0
    assert buf.getvalue().startswith("backend: cpu")
    bad = sorted(m for m in sys.modules if refused(m))
    assert not bad, bad
    print("OK", len(mods), "modules,", len(smoke), "imported by chip_smoke")
""")


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().startswith("OK"), proc.stdout
