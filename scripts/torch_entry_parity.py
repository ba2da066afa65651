"""The port's ``batch``, ``live`` and ``player`` paths against the JAX
package's on the CPU: the per-pose distances behind tests/test_torch_multi.py
and tests/test_torch_live.py.

    JAX_PLATFORMS=cpu python3 scripts/torch_entry_parity.py   # ~5 min

Prints, each on its own line:
- multi: the port's ``MultiSequencePipeline`` (two devices) against its
  one-sequence ``OdometryPipeline`` runs and against JAX's unsharded
  ``MultiSequencePipeline``, at tests/test_multi_pipeline.py's config;
- live: the 16 x 512 capture streamed losslessly over loopback into the
  port's ``LiveDriver`` + ``SlamSystem`` and into JAX's, at the tests'
  capacities (``LIVE_CFG``): scans, frames held, distances at the stamps
  both processed; then JAX against itself at tests/test_torch_cli.py's
  2,048 kept points, with 1 mm added to one point of one scan;
- player: ``cli player --rate 0`` over tests/fixtures/mulran_mini, both
  packages.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import tempfile

import numpy as np
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)


def _dist(a, b):
    return float(np.linalg.norm(a[:, 1:4] - b[:, 1:4], axis=1).max())


def multi():
    from noetic_slam_tpu.runtime import multi as jmulti
    from noetic_slam_tpu_torch.runtime.multi import (MultiSequencePipeline,
                                                     run_lockstep)
    from tests import test_torch_multi as t
    from tests.torch_parity import jax_cfg

    sims = []
    for s in (3, 9):
        sim = t.synthetic.make_sim(duration=1.2, n_points=2048,
                                   calib_time=3.1, seed=s)
        sims.append((sim, [sim.scan(i) for i in range(len(sim.scan_stamps))]))
    solo = [t._run_single(t._cfg(), s) for s in sims]
    mp = MultiSequencePipeline(t._cfg(), n_seq=2, devices=["cpu", "cpu"])
    port = run_lockstep(mp, [t._feed(s) for s in sims])
    jmp = jmulti.MultiSequencePipeline(jax_cfg(t._cfg()), n_seq=2)
    ref = jmulti.run_lockstep(jmp, [t._feed(s, cls=jmulti.ArrayFeed)
                                    for s in sims])
    for i in range(2):
        print(f"multi: sequence {i}: {len(port[i])} poses; port against its "
              f"one-sequence run: bitwise equal "
              f"{np.array_equal(port[i], solo[i])}; against JAX: max "
              f"{_dist(port[i], ref[i]) * 100:.3f} cm, stamps max "
              f"{np.abs(port[i][:, 0] - ref[i][:, 0]).max():.1e} s",
              flush=True)


def _stream(pkg: str, cfg_path: str, meta: dict, ports, perturb=None):
    """Stream the capture losslessly into ``pkg``'s LiveDriver +
    SlamSystem(pipelined=True); ``perturb``: the process_scan call that
    gets 1 mm on its point 100."""
    from tests.test_torch_live import stream_lossless

    if pkg == "port":
        from noetic_slam_tpu_torch.config.params import load_config
        from noetic_slam_tpu_torch.io import ouster as ou
        from noetic_slam_tpu_torch.runtime.live import LiveDriver
        from noetic_slam_tpu_torch.runtime.slam import SlamSystem

        slam = SlamSystem(load_config(cfg_path), pipelined=True,
                          device="cpu")
    else:
        from noetic_slam_tpu.config.params import load_config
        from noetic_slam_tpu.io import ouster as ou
        from noetic_slam_tpu.runtime.live import LiveDriver
        from noetic_slam_tpu.runtime.slam import SlamSystem

        slam = SlamSystem(load_config(cfg_path), pipelined=True)
    calls = []
    inner = slam.process_scan

    def process_scan(header, xyz, pt):
        calls.append(header)
        if len(calls) == perturb:
            xyz = xyz.copy()
            xyz[100] += 0.001
        return inner(header, xyz, pt)

    slam.process_scan = process_scan
    with open(meta["metadata"]) as f:
        info = ou.SensorInfo.from_json(f.read())
    drv = LiveDriver(slam, info, lidar_port=ports[0], imu_port=ports[1],
                     max_read_errors=10 ** 9)
    try:
        stream_lossless(drv, meta["pcap"], *ports)
    finally:
        drv.close()
    return drv, np.asarray(slam.flush())


def live():
    from noetic_slam_tpu_torch.utils import fixtures
    from noetic_slam_tpu_torch.utils.synthetic import ate_rmse
    from tests.test_torch_cli import CONFIGS
    from tests.test_torch_live import LIVE_CFG

    with tempfile.TemporaryDirectory() as d:
        meta = fixtures.write_pcap_fixture(d)
        gt = np.loadtxt(meta["gt"])

        def ate(t):
            return ate_rmse(t[:, 0] - fixtures.PCAP_BASE_NS * 1e-9,
                            t[:, 1:4], gt[:, 0], gt[:, 1:4])

        cfgs = {}
        for name, cfg in (("tests", LIVE_CFG), ("cli_pcap", {
                **CONFIGS["pcap"], "tsdf": {"max_blocks": 8192}})):
            cfgs[name] = os.path.join(d, f"{name}.yaml")
            with open(cfgs[name], "w") as f:
                yaml.safe_dump(cfg, f)
        drv, traj = _stream("port", cfgs["tests"], meta, (47995, 47996))
        jdrv, jtraj = _stream("jax", cfgs["tests"], meta, (47997, 47998))
        at = {s: i for i, s in enumerate(traj[:, 0])}
        rows = [at[s] for s in jtraj[:, 0]]
        print(f"live: LIVE_CFG: port {drv.n_scans} scans ({drv.n_held} held "
              f"for their IMU, {drv.n_refused} dropped), JAX "
              f"{jdrv.n_scans}; at JAX's {len(rows)} stamps max "
              f"{_dist(traj[rows], jtraj) * 100:.3f} cm; ATE port "
              f"{ate(traj):.4f} m, JAX {ate(jtraj):.4f} m", flush=True)
        _, a = _stream("jax", cfgs["cli_pcap"], meta, (47997, 47998))
        _, b = _stream("jax", cfgs["cli_pcap"], meta, (47997, 47998),
                       perturb=41)
        print(f"live: 2,048 kept points: JAX against itself with 1 mm on "
              f"one point of its 41st call: {len(a)} / {len(b)} scans, max "
              f"{_dist(a, b) * 100:.3f} cm (last five "
              f"{np.round(np.linalg.norm(a[-5:, 1:4] - b[-5:, 1:4], axis=1) * 100, 2)}"
              f" cm)", flush=True)


def player():
    from noetic_slam_tpu import cli as jcli
    from noetic_slam_tpu_torch import cli as tcli

    fixture = os.path.join(REPO, "tests", "fixtures", "mulran_mini")
    with tempfile.TemporaryDirectory() as d:
        cfg = os.path.join(d, "cfg.yaml")
        with open(cfg, "w") as f:
            yaml.safe_dump({"capacity": {
                "max_points": 2048, "max_ds_points": 1024,
                "max_deskew_frames": 128, "max_imu_window": 64,
                "max_keyframes": 64, "max_submap_kf": 32,
                "max_trajectory": 512}}, f)
        argv = ["player", "--mulran", fixture, "--rate", "0", "--no-tsdf",
                "--config", cfg]
        for cli, tag, extra in ((tcli, "port", ["--device", "cpu"]),
                                (jcli, "jax", [])):
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(argv + ["--out", os.path.join(d, tag)] + extra)
        a, b = (np.loadtxt(os.path.join(d, t, "trajectory.tum"))
                for t in ("port", "jax"))
        print(f"player: {len(a)} / {len(b)} poses, max {_dist(a, b) * 100:.3f}"
              f" cm", flush=True)


if __name__ == "__main__":
    multi()
    live()
    player()
