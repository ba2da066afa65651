"""Both command lines on the same inputs, pose by pose (CPU).

    JAX_PLATFORMS=cpu python3 scripts/torch_cli_parity.py [--inputs ...]
        [--synthetic-capacity test|mulran]

Runs ``slam`` of the port (``noetic_slam_tpu_torch.cli``, ``--device
cpu``) and of the JAX package (``noetic_slam_tpu.cli``) with the
arguments and configurations of ``tests/test_torch_cli.py`` on each input
(``mulran``, ``pcap``, ``bag``, ``synthetic``), and prints per input the
pose count, the largest per-pose distance between the two trajectories
and, for the synthetic sequence, each one's largest distance to ground
truth. ``--synthetic-capacity mulran`` runs the synthetic sequence at the
MulRan run's capacities (2048 points, 1024 kept, 128 deskew frames)
instead of the test's (4096, 2048, 512). About 20 s an input on one core.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import yaml

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from noetic_slam_tpu_torch.utils import synthetic  # noqa: E402
from tests import test_torch_cli as cli_test  # noqa: E402


def _largest(x, y) -> float:
    return float(np.linalg.norm(x - y, axis=1).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inputs", nargs="+",
                    default=["mulran", "pcap", "bag", "synthetic"])
    ap.add_argument("--synthetic-capacity", default="test",
                    choices=["test", "mulran"])
    args = ap.parse_args()
    import torch

    torch.set_num_threads(1)
    for kind in args.inputs:
        root = tempfile.mkdtemp(prefix=f"cli_parity_{kind}_")
        cfg = dict(cli_test.CONFIGS[kind])
        if kind == "synthetic" and args.synthetic_capacity == "mulran":
            cfg["capacity"] = cli_test.SMALL["capacity"]
        path = os.path.join(root, "cfg.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        argv = ["slam", *cli_test._inputs(kind, root), "--config", path]
        cli_test._main(cli_test.tcli, argv + ["--out", f"{root}/port",
                                              "--device", "cpu"])
        cli_test._main(cli_test.jcli, argv + ["--out", f"{root}/jax"])
        a = np.loadtxt(f"{root}/port/trajectory.tum")[:, :4]
        b = np.loadtxt(f"{root}/jax/trajectory.tum")[:, :4]
        line = (f"{kind}: {len(a)} / {len(b)} poses, largest per-pose "
                f"distance {_largest(a[:, 1:], b[:, 1:]):.4f} m")
        if kind == "synthetic":
            sim = synthetic.make_sim(duration=1.5, calib_time=3.1,
                                     n_points=4096, seed=11)
            gt = np.stack([np.interp(a[:, 0], sim.gt_stamps,
                                     sim.gt_pos[:, k]) for k in range(3)], 1)
            line += (f" ({args.synthetic_capacity} capacity); to ground "
                     f"truth: port {_largest(a[:, 1:], gt):.4f} m, JAX "
                     f"{_largest(b[:, 1:], gt):.4f} m")
        print(line, flush=True)


if __name__ == "__main__":
    main()
