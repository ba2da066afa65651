"""The port never imports JAX: in a fresh interpreter whose import system
refuses ``jax``, every module of ``noetic_slam_tpu_torch`` imports and two
small pipeline steps run on the CPU."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    class RefuseJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError("jax is refused here: " + name)

    sys.meta_path.insert(0, RefuseJax())

    import noetic_slam_tpu_torch as pkg
    mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in mods:
        importlib.import_module(name)

    import numpy as np
    import torch
    from noetic_slam_tpu_torch.config import CapacityConfig, DlioConfig, TsdfConfig
    from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
    from noetic_slam_tpu_torch.utils import synthetic

    torch.set_num_threads(1)
    cfg = DlioConfig(capacity=CapacityConfig(
        max_points=1024, max_ds_points=512, max_deskew_frames=256,
        max_imu_window=64, max_keyframes=8, max_submap_kf=4),
        tsdf=TsdfConfig(max_blocks=64, scan_block_cap=64))
    sim = synthetic.make_sim(duration=0.25, n_points=1024, calib_time=3.1,
                             seed=2)
    pipe = OdometryPipeline(cfg, device="cpu", with_tsdf=True)
    for i in range(len(sim.imu_stamps)):
        pipe.push_imu(sim.imu_stamps[i], sim.imu_ang[i], sim.imu_acc[i])
    for s in range(2):
        pipe.process_scan(*sim.scan(s))
    traj = pipe.flush()
    assert traj.shape == (2, 8) and np.isfinite(traj).all(), traj
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    assert not bad, bad
    print("OK", len(mods), "modules")
""")


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().startswith("OK"), proc.stdout
