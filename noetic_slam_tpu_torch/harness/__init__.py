"""Long-run harnesses of the port, each the counterpart of one root script:

- ``harness.soak``           <- ``scripts/soak.py`` (the long ``SlamSystem``
                                soak: eviction, graph growth, closures
                                through the archive, a bitwise resume);
- ``harness.endurance``      <- ``scripts/endurance.py`` (live ingest at
                                2048x20 under injected packet faults);
- ``harness.endurance_slam`` <- ``scripts/endurance_slam.py`` (a synthetic
                                drive as Ouster UDP into ``LiveDriver`` +
                                ``SlamSystem``);
- ``harness.soak_cli``       <- ``scripts/soak_cli.py`` (a km-class MulRan
                                directory through ``cli slam``);
- ``harness.soak_drift``     <- ``scripts/soak_drift.py`` (descriptor-led
                                recovery from multi-metre drift, through
                                a candidate already evicted to the
                                archive);
- ``harness.profile_stages`` <- ``scripts/profile_stages.py`` (the
                                odometry step's stages at production
                                shapes, slope-timed, with kernel A's own
                                device time inside each);
- ``harness.profile_tsdf``   <- ``scripts/profile_tsdf.py`` (TSDF fusion's
                                stages and their alternatives, with
                                kernel B's own device time).
- ``harness.bench_batch``    <- ``scripts/bench_batch.py`` (the B =
                                1/2/4/8 multi-sequence ladder on one
                                card, with its JSON artifact);
- ``harness.bench_scaling``  <- ``scripts/bench_scaling.py`` (B = D
                                sequences on D ranks, the batch axis
                                over a rank mesh, slope-timed);
- ``harness.multihost_sim``  <- ``scripts/multihost_sim.py`` (P launchers
                                of K ranks forming one world: the
                                sharded paths, the batch axis and the
                                fused step with the map-sharded align).

``harness.live_record`` is no script's counterpart: it records what
``harness.endurance_slam`` hands the system (``ESLAM_RECORD``), so that
``scripts/torch_live_replay.py`` can replay it through both packages.

Each keeps its script's environment knobs, defaults, seeds,
configurations, cadences, JSON keys (the profilers print a table; the
port also writes it as JSON), pass rule and exit code, and adds
``main(argv)`` with ``--device`` (left unset: the card; without one it
raises; the tests pass ``cpu``) and, in the style of ``bench.py``'s extras,
``device``, ``power_limit_w``, host syncs and peak device memory per
window, and the launches of kernels A and B. Run one with
``python -m noetic_slam_tpu_torch.harness.<name>``. Outputs go under
``build/harness/`` unless the environment names a path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

HARNESS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "harness")


def output_path(env: str, name: str) -> str:
    """``$env`` if set, else ``build/harness/<name>``; its directory made."""
    path = os.environ.get(env) or os.path.join(HARNESS_DIR, name)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return path


def parse_device(argv, doc: str) -> torch.device:
    """The ``--device`` of ``argv`` (None: the card; raises without one)."""
    from noetic_slam_tpu_torch import resolve_device

    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    return resolve_device(ap.parse_args(argv).device)


def device_extras(dev: torch.device) -> dict:
    """``device`` (the card's name, or ``cpu``) and ``power_limit_w``."""
    from noetic_slam_tpu_torch.bench import power_limit_w

    return {"device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else dev.type),
            "power_limit_w": power_limit_w(dev)}


def launches() -> dict:
    """The launch counts of kernels A and B so far (wrapper calls that
    launched on the card; 0 on the CPU)."""
    c = kernel_counters()
    return {k: c[k].launches for k in ("nn1_fused", "block_accumulate")}


def launches_since(before: dict) -> dict:
    now = launches()
    return {k: now[k] - before[k] for k in now}


def kernel_counters() -> dict:
    """name -> the wrapper of kernels A, B, C and D; each counts its own
    launches in ``.launches``."""
    from noetic_slam_tpu_torch.ops.cuda import (
        lm_kernel,
        logodds_kernel,
        nn_kernel,
        tsdf_kernel,
    )

    return {"nn1_fused": nn_kernel.nn1_fused,
            "block_accumulate": tsdf_kernel.block_accumulate,
            "logodds_accumulate": logodds_kernel.logodds_accumulate,
            "lm_search_fused": lm_kernel.lm_search_fused}


class PlainCalls:
    """While entered, counts in ``n`` the calls that reach a kernel's plain
    version (on the card there must be none; on the CPU every kernel call
    does)."""

    def __init__(self):
        from noetic_slam_tpu_torch.models import occupancy, tsdf
        from noetic_slam_tpu_torch.ops import neighbors
        from noetic_slam_tpu_torch.ops.cuda import lm_kernel

        self.n = 0
        self._names = [(neighbors, "nn1_plain"),
                       (tsdf, "block_accumulate_plain"),
                       (occupancy, "logodds_accumulate_plain"),
                       (lm_kernel, "lm_search_plain")]
        self._orig = [getattr(m, name) for m, name in self._names]

    def __enter__(self):
        def counted(fn):
            def call(*a, **kw):
                self.n += 1
                return fn(*a, **kw)
            return call

        for (m, name), fn in zip(self._names, self._orig):
            setattr(m, name, counted(fn))
        return self

    def __exit__(self, *exc):
        for (m, name), fn in zip(self._names, self._orig):
            setattr(m, name, fn)


class Window:
    """Per-window extras: host syncs of ``system`` and the card's peak
    memory in the window (the peak is reset when the window opens; None off
    the card)."""

    def __init__(self, dev: torch.device, system=None):
        self.dev, self.system = dev, system
        self.syncs0 = system.host_syncs if system is not None else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def extras(self) -> dict:
        out = {}
        if self.system is not None:
            out["host_syncs"] = self.system.host_syncs - self.syncs0
        out["peak_memory_gib"] = (
            round(torch.cuda.max_memory_allocated(self.dev) / 2**30, 3)
            if self.dev.type == "cuda" else None)
        return out


def ate_profile(stamps, est, gt_stamps, gt_pos) -> list:
    """Mean aligned position error of each tenth of the trajectory (the
    root scripts' per-decile profile: Umeyama alignment, no scale)."""
    gtc = np.stack([np.interp(stamps, gt_stamps, gt_pos[:, k])
                    for k in range(3)], -1)
    mu_e, mu_g = est.mean(0), gtc.mean(0)
    H = (est - mu_e).T @ (gtc - mu_g)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    al = ((Vt.T @ S @ U.T) @ (est - mu_e).T).T + mu_g
    seg = np.linalg.norm(al - gtc, axis=-1)
    dec = max(1, len(seg) // 10)
    return [round(float(seg[i:i + dec].mean()), 3)
            for i in range(0, len(seg), dec)][:10]
