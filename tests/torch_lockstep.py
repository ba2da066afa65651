"""Lockstep harness of the port's robustness tests
(``tests/test_torch_robustness.py``,
``tests/test_torch_aggressive_motion.py``): one sequence of scans and IMU
samples through the JAX ``OdometryPipeline`` and the port's, with every
port step also run from the state JAX held before that scan.

``Trio`` feeds the same inputs to JAX's pipeline, the port's, and the port
in lockstep: each lockstep step starts from JAX's state before that scan
(one registration step). With ``ulp=True`` JAX also runs each step a
second time from the same state with every point's x moved by one ulp,
which measures the reference's own noise on that step.

``Trio.check`` holds exactly, on every step: the scans deferred for IMU,
processed / skipped and ``deskew_ok``. On every step where the reference
reproduces itself (its one-ulp step within ``REF_NOISE`` and the same
keyframe and gate decisions) it also holds the port's keyframe and gate
decisions exactly and its pose within 2 cm (``STEP_TOL``, one
registration step; ROADMAP "Parity tolerances"). Where the reference's
own step moves by more under one ulp, the registration is noise-dominated
in the reference itself (ROADMAP Queue 3 item 3: up to 0.90 m on the
aggressive draw's first keyframes, up to 1.2 m on a one-plane world), and
no implementation can be held closer than that noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from noetic_slam_tpu.runtime.pipeline import NeedMoreImu as JaxNeedMoreImu
from noetic_slam_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline
from noetic_slam_tpu_torch import convert
from noetic_slam_tpu_torch.config import CapacityConfig, DlioConfig
from noetic_slam_tpu_torch.runtime.pipeline import (
    NeedMoreImu,
    OdometryPipeline,
)
from noetic_slam_tpu_torch.utils import synthetic
from tests.torch_parity import jax_cfg, to_np

CPU = "cpu"
STEP_TOL = 0.02      # [m] one registration step from the same state
REF_NOISE = 0.011    # [m] the reference's documented one-ulp step noise


def small_cfg(**kw):
    """tests/test_odometry_e2e.py's ``small_cfg``, the port's config."""
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=4096, max_ds_points=2048, max_deskew_frames=1024,
            max_imu_window=64, max_keyframes=32, max_submap_kf=8),
        **kw)


def _decisions(out, rejected_before, state):
    return {"processed": bool(to_np(out.processed)),
            "deskew_ok": bool(to_np(out.deskew_ok)),
            "is_keyframe": bool(to_np(out.is_keyframe)),
            "rejected": int(to_np(state.reg_rejected)) - rejected_before}


class Trio:
    """JAX's pipeline, the port's, the port in lockstep with JAX and, with
    ``ulp``, JAX in lockstep with itself on a one-ulp change of the scan.

    ``jax_steps`` maps a config to its jitted JAX step, shared by the
    pipelines of one configuration (each ``OdometryPipeline`` jits its own
    step, and a compile takes ~30 s on one core)."""

    def __init__(self, cfg, jax_steps: dict, ulp: bool = True):
        self.jax = JaxPipeline(jax_cfg(cfg))
        self.jax._step = jax_steps.setdefault(repr(cfg), self.jax._step)
        self.ulp = None
        if ulp:
            self.ulp = JaxPipeline(jax_cfg(cfg))
            self.ulp._step = self.jax._step
        self.own = OdometryPipeline(cfg, device=CPU)
        self.lock = OdometryPipeline(cfg, device=CPU)
        self.steps = []          # per processed scan: see process_scan
        self.deferred = 0        # scans JAX (and the port) held back

    def _jax_pipes(self):
        return (self.jax,) if self.ulp is None else (self.jax, self.ulp)

    def push_imu(self, *sample):
        for p in (*self._jax_pipes(), self.own, self.lock):
            p.push_imu(*sample)

    def process_scan(self, header, xyz, pt):
        """One scan into every pipeline; raises the port's NeedMoreImu
        when JAX defers it (the port must defer it too)."""
        before = (None if self.jax.state is None
                  else jax.device_get(self.jax.state))
        rej0 = 0 if before is None else int(before.reg_rejected)
        try:
            jout = self.jax.process_scan(header, xyz, pt)
        except JaxNeedMoreImu:
            self.deferred += 1
            for p in (self.own, self.lock):
                with pytest.raises(NeedMoreImu):
                    p.process_scan(header, xyz, pt)
            raise NeedMoreImu() from None
        self.own.process_scan(header, xyz, pt)
        if before is not None:
            self.lock.state = convert.odom_state_from_numpy(before, CPU)
        tout = self.lock.process_scan(header, xyz, pt)
        jp = np.asarray(jout.lidar_p)
        step = {"jax": _decisions(jout, rej0, self.jax.state),
                "port": _decisions(tout, rej0, self.lock.state),
                "dp": float(np.linalg.norm(to_np(tout.lidar_p) - jp))}
        if self.ulp is not None:
            if before is not None:
                self.ulp.state = jax.tree_util.tree_map(jnp.asarray, before)
            x_ulp = xyz.copy()
            x_ulp[:, 0] = np.nextafter(x_ulp[:, 0], np.float32(np.inf))
            uout = self.ulp.process_scan(header, x_ulp, pt)
            step["ulp"] = _decisions(uout, rej0, self.ulp.state)
            step["ref_dp"] = float(np.linalg.norm(np.asarray(uout.lidar_p)
                                                  - jp))
        self.steps.append(step)
        return jout

    def check(self, min_held: float | None):
        """Decisions and poses as the module docstring says. ``min_held``:
        the least share of steps on which the reference reproduces itself
        (and the port is held); None, without the one-ulp run: no
        registration step is held. Both packages' own states must be
        finite. Returns the port's and JAX's trajectories."""
        assert self.steps
        assert (min_held is None) == (self.ulp is None)
        held = 0
        for i, s in enumerate(self.steps):
            j, t = s["jax"], s["port"]
            for k in ("processed", "deskew_ok"):
                assert j[k] == t[k], (i, k, s)
            if self.ulp is not None and s["ref_dp"] < REF_NOISE \
                    and s["ulp"] == j:
                held += 1
                assert t == j, (i, s)
                assert s["dp"] < STEP_TOL, (i, s)
        if min_held is not None:
            assert held >= min_held * len(self.steps), (held, self.steps)
        assert self.own.num_processed == self.jax.num_processed
        for st in (self.own.state, self.jax.state):
            for f in ("p", "q", "v"):
                assert np.all(np.isfinite(to_np(getattr(st, f)))), f
        return self.own.flush(), self.jax.flush()


def run(sim, pipe, scans, drop_imu_between=None):
    """tests/test_robustness.py:17-41's loop over pre-made ``scans``:
    IMU through each sweep's end (samples inside ``drop_imu_between``
    dropped), scans deferred until the IMU covers them. Returns the
    scans still deferred at the end."""
    imu_i = 0
    pending = []
    for header, xyz, pt in scans:
        sweep_end = header + pt.max()
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= sweep_end + 0.02):
            t = sim.imu_stamps[imu_i]
            imu_i += 1
            if (drop_imu_between
                    and drop_imu_between[0] <= t <= drop_imu_between[1]):
                continue
            pipe.push_imu(t, sim.imu_ang[imu_i - 1], sim.imu_acc[imu_i - 1])
        # the cv-wait analog: defer scans until IMU coverage resumes
        pending.append((header, xyz, pt))
        still = []
        for args in pending:
            try:
                pipe.process_scan(*args)
            except NeedMoreImu:
                still.append(args)
        pending = still
    return pending


def ate(sim, traj):
    return synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                              sim.gt_pos)
