"""Multi-sequence lockstep SLAM driver (port of
``noetic_slam_tpu.runtime.multi``).

B independent sequences advance in LOCKSTEP, one odometry step each per
round (``parallel.batch.make_batched_odometry_step``). The reference runs
one bag per process tree (roslaunch); here N bags are one program.

Host-side per-sequence work (IMU buffering, static calibration, scan
packing) reuses the one-sequence ``OdometryPipeline`` frontends. Device
state is one ``OdomState`` per sequence, on that sequence's device.
Sequences that are stalled (IMU not yet covering the sweep) or exhausted
ride along with an IDLE step: a zero-point scan at the previous header
(header_delta = 0), which takes the step's skip branch and leaves the
sequence's state bitwise as it was, apart from ``total_steps``.

Differences from the JAX module: where it takes a ``mesh``, the port takes
``devices`` (default: the card), and sequence i lives on
``devices[i * D // B]`` (the contiguous blocks of ``P("batch")``); the
batched step runs the one-sequence step per sequence (see
``parallel.batch``); ``step_rounds`` uploads the K rounds' inputs once per
device and runs them in order; ``host_syncs`` counts the step's host
reads over every sequence.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

from noetic_slam_tpu_torch import resolve_device
from noetic_slam_tpu_torch.config import DlioConfig
from noetic_slam_tpu_torch.models.odometry import OdomState, StepInput, init_state
from noetic_slam_tpu_torch.ops.gicp import HostSyncs
from noetic_slam_tpu_torch.parallel import batch as pbatch
from noetic_slam_tpu_torch.runtime.checkpoint import _empty_grid, _pack, _unpack
from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu, OdometryPipeline
from noetic_slam_tpu_torch.utils.host import to_device

ScanItem = Optional[Tuple[float, np.ndarray, Optional[np.ndarray]]]


class MultiSequencePipeline:
    """Drive B sequences through the batched odometry step. Per-sequence
    API mirrors OdometryPipeline with an index:

        mp = MultiSequencePipeline(cfg, n_seq=4)
        mp.push_imu(i, stamp, ang, acc)      # feed each sequence's IMU
        mp.step_round([scan0, None, scan2, scan3])   # one lockstep round
        traj_i = mp.flush(i)                 # per-sequence trajectory

    A ``None`` entry idles that sequence for the round.
    """

    def __init__(self, cfg: DlioConfig | None = None, n_seq: int = 2,
                 devices: Sequence | None = None):
        self.cfg = cfg or DlioConfig()
        self.n_seq = n_seq
        devs = [resolve_device(d) for d in (devices or [None])]
        if n_seq % len(devs):
            raise ValueError(
                f"n_seq={n_seq} not divisible by {len(devs)} devices")
        self.devices = devs
        # sequence i on the i-th contiguous block of devices
        self.seq_device = [devs[i * len(devs) // n_seq]
                           for i in range(n_seq)]
        self._syncs = HostSyncs()
        self._step = pbatch.make_batched_odometry_step(self.cfg, self._syncs)
        # frontends carry host-side IMU/calibration/packing; their own step
        # is never used
        self.frontends = [OdometryPipeline(self.cfg, device=d)
                          for d in self.seq_device]
        self.states: Optional[List[OdomState]] = None
        self.rounds = 0

    @property
    def host_syncs(self) -> int:
        """Device->host reads that steered the step, over every sequence."""
        return self._syncs.n

    # ------------------------------------------------------------------ IMU
    def push_imu(self, i: int, stamp: float, ang_vel, lin_accel) -> None:
        self.frontends[i].push_imu(stamp, ang_vel, lin_accel)

    @property
    def ready(self) -> bool:
        """All sequences calibrated (static-calibration windows elapsed)."""
        return all(f.calibrated for f in self.frontends)

    # ----------------------------------------------------------------- step
    def _ensure_state(self):
        if self.states is not None:
            return
        if not self.ready:
            raise NeedMoreImu("IMU calibration in progress on some sequence")
        states = []
        for f in self.frontends:
            if f.state is None:
                f.state = init_state(self.cfg, f.device)
            states.append(f.state)
            f.state = None               # device state now owned here
        self.states = states

    def _pack_idle(self, f: OdometryPipeline):
        """Fully-synthetic inert input for a sequence that never produced a
        scan (no IMU-coverage precondition). Sequences WITH a previous
        header idle through _pack_round's zero-point scan at that header
        (header_delta = 0) instead; either way the step's skip branch
        leaves the sequence's pose/time state unchanged."""
        cap = self.cfg.capacity
        n, M = cap.max_points, cap.max_imu_window
        imu = np.zeros((M, 7), np.float32)
        head = [0.0, 0.0, 0.0]               # delta, deskew off, k = 0
        if self.cfg.preproc.quantized_wire:
            points = np.full((n, 3), 32767, np.int16)
            pts_t = np.zeros((n,), np.float16)
            scalars = np.array(head + [1e-4, 0.0, 0.0, 0.0, 0.0], np.float32)
        else:
            points = np.full((n, 4), 1e6, np.float32)
            pts_t = None
            scalars = np.array(head + [0.0], np.float32)
        return points, imu, scalars, pts_t

    def _pack_round(self, scans: Sequence[ScanItem], prevs: list):
        """Pack one round's B inputs; ``prevs`` (per-sequence previous
        header, mutated in place) threads header deltas across rounds
        packed ahead of one upload."""
        packed = []
        for j, (f, item) in enumerate(zip(self.frontends, scans)):
            if item is None:
                if prevs[j] is not None:
                    packed.append(f._pack_scan(
                        prevs[j], np.zeros((0, 3), np.float32), None, 0.0))
                else:
                    packed.append(self._pack_idle(f))
            else:
                header, xyz, pt = item
                delta = 0.0 if prevs[j] is None else header - prevs[j]
                packed.append(f._pack_scan(header, xyz, pt, delta))
                prevs[j] = header
        return packed

    def _upload(self, all_packed) -> List[List[StepInput]]:
        """inputs[r][j] of K packed rounds: one host->device copy per field
        and device, of the (K, sequences there, ...) stack."""
        K = len(all_packed)
        inputs = [[None] * self.n_seq for _ in range(K)]
        for dev in dict.fromkeys(self.seq_device):
            seqs = [j for j in range(self.n_seq) if self.seq_device[j] == dev]

            def up(sel):
                a = np.stack([[all_packed[r][j][sel] for j in seqs]
                              for r in range(K)])
                return to_device(a, dev)

            pts, imu, sc = up(0), up(1), up(2)
            pt = None if all_packed[0][seqs[0]][3] is None else up(3)
            for r in range(K):
                for jl, j in enumerate(seqs):
                    inputs[r][j] = StepInput(
                        points=pts[r, jl], imu=imu[r, jl], scalars=sc[r, jl],
                        pt=None if pt is None else pt[r, jl])
        return inputs

    def step_round(self, scans: Sequence[ScanItem]) -> None:
        """Advance every sequence one step: real scans where provided,
        idle steps for ``None`` entries.

        Raises NeedMoreImu (before any state mutation) if a non-None scan's
        sweep is not yet covered by that sequence's IMU buffer: feed more
        IMU and retry, or pass None to idle the sequence this round.
        """
        self.step_rounds([scans])

    def step_rounds(self, rounds: Sequence[Sequence[ScanItem]]) -> None:
        """Advance every sequence through K lockstep rounds from one
        stacked upload (the offline-throughput mode); semantics identical
        to K step_round calls."""
        if not rounds:
            return
        assert all(len(r) == self.n_seq for r in rounds)
        self._ensure_state()

        prevs = [f.prev_header for f in self.frontends]
        all_packed = []
        headers_per_round = []
        for scans in rounds:
            all_packed.append(self._pack_round(scans, prevs))
            headers_per_round.append(list(prevs))

        for inp in self._upload(all_packed):
            self.states, _outs = self._step(self.states, inp)

        K = len(rounds)
        for r, scans in enumerate(rounds):
            for j, (f, item) in enumerate(zip(self.frontends, scans)):
                if item is not None and f.first_scan_stamp is None:
                    f.first_scan_stamp = item[0]
                f.headers.append(headers_per_round[r][j])
        for j, f in enumerate(self.frontends):
            f.prev_header = prevs[j]
        self.rounds += K
        # trajectory-ring guard (the device ring holds max_trajectory rows)
        if (self.rounds % (self.cfg.capacity.max_trajectory // 2)) < K:
            for i in range(self.n_seq):
                self.flush(i)

    # -------------------------------------------------------- checkpointing
    def save(self, path: str, feeds=None) -> None:
        """Checkpoint all sequences (device states + per-sequence host
        bookkeeping + optional feed cursors) into one ``.nst.npz`` in the
        JAX layout (``odom{i}/<field>``, ``host/json``), so that either
        package loads it."""
        out: dict = {}
        seq_host = []
        for i, f in enumerate(self.frontends):
            st = self.states[i] if self.states is not None else f.state
            if st is not None:
                _pack(f"odom{i}", st, out)
                out.update(_empty_grid(st.submap_xyz.shape[0], f"odom{i}"))
            seq_host.append({
                "prev_header": f.prev_header,
                "headers": f.headers,
                "first_scan_stamp": f.first_scan_stamp,
                "flushed_scans": f._flushed_scans,
                "calibrated": f.calibrated,
                "imu_stamps": np.asarray(f._imu_stamps).tolist(),
                "imu_ang": np.asarray(f._imu_ang).tolist(),
                "imu_acc": np.asarray(f._imu_acc).tolist(),
            })
        host = {"n_seq": self.n_seq, "rounds": self.rounds,
                "seq": seq_host,
                "feed_cursors": ([fd.cursor() for fd in feeds]
                                 if feeds is not None else None)}
        out["host/json"] = np.frombuffer(json.dumps(host).encode(),
                                         dtype=np.uint8)
        np.savez_compressed(path, **out)

    def load(self, path: str, feeds=None) -> None:
        """Restore a checkpoint written by ``save`` (of either package) into
        a pipeline built with the same config/n_seq, each state on its
        sequence's device; with ``feeds``, their cursors are restored
        too."""
        with np.load(path, allow_pickle=False) as data:
            host = json.loads(bytes(data["host/json"]).decode())
            if host["n_seq"] != self.n_seq:
                raise ValueError(f"checkpoint has {host['n_seq']} "
                                 f"sequences, pipeline {self.n_seq}")
            self.rounds = int(host["rounds"])
            self.states = None
            for i, (f, h) in enumerate(zip(self.frontends, host["seq"])):
                f.state = _unpack(f"odom{i}", OdomState, data, f.device)
                f.prev_header = h.get("prev_header")
                f.headers = list(h.get("headers", []))
                f.first_scan_stamp = h.get("first_scan_stamp")
                f._flushed_scans = int(h.get("flushed_scans", 0))
                f.trajectory = f.trajectory[: f._flushed_scans]
                f.calibrated = bool(h.get("calibrated", True))
                f._imu_stamps = np.asarray(h.get("imu_stamps", []),
                                           np.float64)
                f._imu_ang = np.asarray(h.get("imu_ang", []),
                                        np.float64).reshape(-1, 3)
                f._imu_acc = np.asarray(h.get("imu_acc", []),
                                        np.float64).reshape(-1, 3)
        cursors = host.get("feed_cursors")
        if feeds is not None and cursors is not None:
            for fd, cur in zip(feeds, cursors):
                fd.seek(*cur)

    # ------------------------------------------------------------- results
    def flush(self, i: int) -> np.ndarray:
        """Per-sequence trajectory (T, 8): stamp, p, q; one bulk fetch of
        sequence i's ring through the frontend's flush bookkeeping."""
        f = self.frontends[i]
        if self.states is None:
            if f.state is None:           # neither stepped nor restored
                return np.zeros((0, 8))
            return f.flush()              # post-load, pre-restart state
        f.state = self.states[i]
        try:
            return f.flush()
        finally:
            f.state = None


class ArrayFeed:
    """Lockstep feed over in-memory IMU arrays + an indexed scan source.

    ``scan_fn(i)`` -> (header_stamp, xyz (N, 3), point_times | None).
    Replay-equivalent semantics (io/replay.replay_dataset): IMU is pushed
    in stamp order; scans arriving before calibration completes are
    dropped; a scan is released only once IMU coverage reaches its sweep
    end (the reference's cv wait, odom.cc:1024-1028); if the IMU stream
    ends first, the remaining scan tail is dropped.
    """

    def __init__(self, imu_stamps, imu_gyro, imu_accel, scan_stamps,
                 scan_fn, max_scans: Optional[int] = None):
        self.imu_stamps = np.asarray(imu_stamps, np.float64)
        self.imu_gyro = np.asarray(imu_gyro)
        self.imu_accel = np.asarray(imu_accel)
        self.scan_stamps = np.asarray(scan_stamps, np.float64)
        self.scan_fn = scan_fn
        self.n_scans = (len(self.scan_stamps) if max_scans is None
                        else min(max_scans, len(self.scan_stamps)))
        self._imu_i = 0
        self._scan_i = 0

    @classmethod
    def from_dataset(cls, ds, max_scans=None):
        """MulranDataset (or same-interface) feed; scans without per-point
        times, like the replay harness (run_scan passes point_times=None)."""
        return cls(ds.imu_stamps, ds.imu_gyro, ds.imu_accel, ds.scan_stamps,
                   lambda i: (float(ds.scan_stamps[i]),
                              ds.read_scan(i)[:, :3], None),
                   max_scans=max_scans)

    @classmethod
    def from_sim(cls, sim, max_scans=None):
        """utils.synthetic.Sim feed (per-point times included)."""
        return cls(sim.imu_stamps, sim.imu_ang, sim.imu_acc, sim.scan_stamps,
                   sim.scan, max_scans=max_scans)

    def cursor(self) -> Tuple[int, int]:
        """(scan cursor, imu cursor), for checkpointed resume."""
        return (self._scan_i, self._imu_i)

    def seek(self, scan_i: int, imu_i: int) -> None:
        self._scan_i, self._imu_i = int(scan_i), int(imu_i)

    def _push_through(self, push, through: float) -> None:
        while (self._imu_i < len(self.imu_stamps)
               and self.imu_stamps[self._imu_i] <= through):
            j = self._imu_i
            push(float(self.imu_stamps[j]), self.imu_gyro[j],
                 self.imu_accel[j])
            self._imu_i += 1

    def next_ready_scan(self, frontend, push) -> ScanItem:
        """Next scan with IMU coverage satisfied (pushing IMU as needed),
        or None when the feed is exhausted."""
        while self._scan_i < self.n_scans:
            item = self.scan_fn(self._scan_i)
            header, _xyz, pt = item
            sweep_end = header + (float(np.max(pt))
                                  if pt is not None and len(pt) else 0.0)
            self._push_through(push, sweep_end + 0.02)
            if not frontend.calibrated:
                if self._imu_i >= len(self.imu_stamps):
                    return None          # IMU ended before calibration
                self._scan_i += 1        # drop pre-calibration scans
                continue
            if not frontend.imu_covers(sweep_end):
                return None              # IMU stream ended: drop the tail
            self._scan_i += 1
            return item
        return None


def run_lockstep(mp: MultiSequencePipeline, feeds,
                 rounds_per_dispatch: int = 1) -> List[np.ndarray]:
    """Drive B feeds (ArrayFeed protocol) through a MultiSequencePipeline
    to completion; returns the per-sequence trajectories.

    Exhausted sequences idle (zero-point skip steps) until every sequence
    is done, so the sequences keep advancing in lockstep.
    ``rounds_per_dispatch`` > 1 packs and uploads K rounds at a time
    (step_rounds); host-side pulls are device-independent, so pre-pulling
    K rounds keeps the semantics.
    """
    n = mp.n_seq
    assert len(feeds) == n
    R = max(1, rounds_per_dispatch)

    def pull(i):
        return feeds[i].next_ready_scan(
            mp.frontends[i],
            lambda s, a, c, i=i: mp.push_imu(i, s, a, c))

    pending = [pull(i) for i in range(n)]
    for i in range(n):
        f = mp.frontends[i]
        if pending[i] is None and not f.calibrated:
            # Feed ended (or had no IMU) before static calibration
            # completed: give the sequence an inert default state so one
            # dead bag cannot abort the whole N-bag run (_ensure_state
            # requires every frontend calibrated). The sequence idles
            # through zero-point skip steps and flushes an empty
            # trajectory.
            f.state = init_state(mp.cfg, f.device)
            f.calibrated = True
    while any(p is not None for p in pending):
        batch_rounds: List[List[ScanItem]] = []
        for _ in range(R):
            if not any(p is not None for p in pending):
                break
            batch_rounds.append(list(pending))
            pending = [pull(i) if pending[i] is not None else None
                       for i in range(n)]
        mp.step_rounds(batch_rounds)
    return [mp.flush(i) for i in range(n)]
