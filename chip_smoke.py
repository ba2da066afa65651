#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``noetic_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--scans 40] [--profile N]

Phases, each printing its own line:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: the hand-written kernels (``noetic_slam_tpu_torch/csrc``) built
   with nvcc for sm_90a into ``build/torch_kernels/``;
3. kernel A (1-NN) against its plain version at the slice's shapes:
   8192 queries against 262,144 Morton-sorted targets, capped (0.5 m) and
   uncapped: found sets equal, not-found idx 0 with sqd = cap^2, sqd
   within rtol 1e-5, idx equal or tied, two runs bitwise equal, and sqd
   bitwise equal to the plain model of its walk. It is timed in turns with
   ``cdist``+``amin`` (kernel, library, library, kernel), hot and cold,
   and its two launches apart (target boxes; list build + walk + exact
   distances). Its bound does not depend on the kernel's own tiles: the
   pairs of a per-query best-first walk over 256-row target tiles
   (``nn_kernel.needed_pairs``); the count earlier revisions used
   (64-query tiles, box to box) is printed beside it, with the lists'
   lengths and the rows the walk's pruning rule scans;
4. kernel B (TSDF block accumulation) against its plain version: one
   scan's 753,664-sample stream into a 65,536-row payload, clamped and in
   the NO_CLAMP signed case;
5. kernel C (occupancy log-odds accumulation) against its plain version:
   one scan's 819,200 beam samples into a 65,536-row payload, clamped at
   the ``OccupancyConfig`` defaults and unclamped (-/+1e30, sign -1).
   Kernel against plain within 1e-5 absolute; also 1e-5 relative for B
   (weights up to 100) and for C's unclamped sums (up to ~1e3).
   Phases 4 and 5 also check that two kernel runs agree bitwise, that the
   stream fused with sign +1 and then -1 into a zero payload gives exactly
   0, and that no voxel outside the samples' hits changes; they print the
   largest entry and the longest chain of serial 32-sample tiles, and time
   the kernel and one ``index_add_`` of the same stream in turns (kernel,
   library, library, kernel), hot and cold (a 64 MB write before each
   call, as the main path finds the rows cold). Every timing queues a
   device sleep before its window, so that the window holds the card's
   time and not the host's launch rate;
6. the main path: ``OdometryPipeline(cfg, with_tsdf=True)`` (the card by
   default) over a synthetic 32,768-point sequence at the production
   capacities, with the launch counters reset just before it; the
   trajectory's ATE against ground truth must stay under 0.05 m, and
   kernel B must run once per scan. 6b: kernel A against its plain version
   and timed beside ``cdist``+``amin`` on the operands of one real
   correspondence search kept from that run (ten scans before its end);
7. the occupancy path: the first ``OCC_SCANS`` of those scans through
   ``OdometryPipeline(cfg.replace(map_backend="occupancy"), with_tsdf=True)``
   at the ``OccupancyConfig`` defaults, counters reset just before it;
   kernel C must run once per fused scan;
8. map products: surface points, the surface-nets mesh and the ESDF
   region around the final pose of the TSDF map; occupied voxels and the
   ESDF region of the occupancy map;
9. the whole system: ``SlamSystem(pipelined=True)`` at bench.py:286-351's
   full width (8192 points, 4096 kept, 16,384 blocks and the archive's
   second volume) over the first ``SYSTEM_SCANS`` of its 240-scan spiral
   (phase 17 runs the whole spiral), driven as bench.py drives it
   (``warmup()``, batches of 8 through ``process_scans``,
   ``maybe_close_loop`` every third batch, the first 32 scans untimed),
   the counters set to 0 just before and read just after. It prints
   scans/s beside the fused step alone on the same scans, closures, raced
   attempts, ``sync_lost_keyframes`` (must be 0, and every keyframe
   synced and archived), ATE, peak memory, host syncs per scan and per
   closing call, and the ``StageTimer`` table; no call may reach a plain
   version;
10. loop closures on the drifting loop of tests/test_slam_system.py
   (starved registration, IMU noise), twice: as the test has it, where the
   closure's outcome and the surface's median error before and after it
   are printed (the drift drawn there differs from machine to machine);
   and started from rest with a manufactured drift on top
   (``synthetic.linear_drift`` through ``SlamSystem.set_keyframe_poses``),
   where it must close and cut the surface's median error by at least
   25%. It prints the moved keyframes and ``t_optimize`` / ``t_apply`` /
   ``t_map_sync``;
11. kernels A and B against their plain versions on operands kept from
   phases 9-10: the first correspondence search inside ``verify_loop``
   (two keyframe clouds with sentinel rows, the cap at twice the
   correspondence distance) and an archive fusion's chunk stream (with
   its exact +1/-1 cancellation), timed hot and cold beside
   ``cdist``+``amin`` and ``index_add_`` (the ``system_*`` keys);
12. the command line, ``noetic_slam_tpu_torch.cli.main`` in this process
   at its default configuration (production capacities), the counters
   reset before each run and read after it, on inputs written here from
   seeds: ``slam --pcap`` on an OS1-64 capture in 512x10 mode (64 x 512)
   with the mesh, ESDF, checkpoint and renders (ATE < 0.15 m); ``slam
   --bag`` on a bz2 bag of phase 6's scans (ATE < 0.05 m); ``export`` of a
   40-scan, 32,768-point MulRan directory to a bag, read back, then
   ``slam --mulran --map-backend occupancy --esdf`` (ATE < 0.5 m). Each
   prints its scans, wall seconds and scans/s, ATE, closures,
   ``sync_lost_keyframes`` (must be 0), the launches (A and B, or A and C,
   must run; no call may reach a plain version) and its output files
   (each must exist and be non-empty): ``cli_launches`` in the JSON line;
13. the live path: phase 12's capture replayed by a sender thread over
   loopback UDP, paced by its capture stamps, into what ``cli live``
   builds (``SlamSystem(pipelined=True)`` with TSDF at the default
   configuration, fed by ``runtime.live.LiveDriver`` in sensor-stamp
   mode): (a0) at 10 Hz under the JAX driver's rule (a frame the IMU does
   not cover yet is dropped), (a) at 10 Hz under the port's (it is held
   until the next IMU drain; ATE < 0.15 m, A and B must launch), (b) at
   20 Hz. Each prints frames sent, scans processed, frames dropped and
   held, ``source.lidar_dropped``, the processed rate, the lag from the
   last packet sent to the last scan done, ATE, host syncs per scan and
   the launches. (c) ``cli player --rate 1`` over phase 12's MulRan
   directory: events, wall seconds, ATE, no thread exception;
   ``live_launches`` in the JSON line;
14. the multi-sequence runtime: scripts/bench_batch.py's B = 1/2/4/8
   ladder at its full width (8,192 points, 4,096 kept, 64 keyframes, 16
   submap keyframes; one ``make_sim(seed=77)`` shared by every sequence,
   cut to ``BATCH_SECONDS``) through ``MultiSequencePipeline`` on the
   card: total and per-sequence scans/s, host syncs per round, A's
   launches, peak memory, each sequence's ATE (each < 0.08 m); the B
   trajectories must be bitwise equal (the step repeats on the card); then
   ``cli batch --synthetic 2
   --mulran <phase 12's directory> --checkpoint`` and a ``--resume`` from
   its checkpoint, both exiting 0; ``batch_launches`` in the JSON line;
15. the grid NN engine (``nn_engine="grid"``) at the main path's width
   over phase 6's scans, (a) with ``cov_engine="radius"`` and (b) with
   ``"knn"`` (grid covariances), each beside the brute engine's run of the
   same scans, and (c) ``cli slam --config <nn_engine: grid> --mulran``
   over phase 12's directory beside the default configuration: scans/s,
   ATE (each < 0.05 m), the largest per-pose distance to the brute run,
   host syncs; kernel A must not launch on the grid's correspondences;
   ``grid_launches`` in the JSON line;
16. the sharded paths (``parallel``) on D = 1 rank under NCCL, then D = 2
   and 4 ranks under gloo, every rank on the one card
   (``parallel.mesh.launch``): (a) ``OdometryPipeline`` with
   ``make_sharded_align`` over 12 of phase 6's scans at its width, every
   rank's poses bitwise rank 0's and every step within 2 cm of the
   one-process step from the same state, steps/s, and the bytes each
   rank hands to ``all_reduce`` per align equal to
   ``collective_traffic_per_align``'s, and kernel A against its plain
   version on each rank's first shard search of the tenth align
   (uncapped, no target count, sentinel rows in the shard); (b) the
   sharded TSDF (``TsdfConfig`` with the default capacity a rank) over
   those steps' clouds, each rank's shard equal to the same masks through
   the plain path, the global block counters the sum of the ranks'
   changes, blocks per rank and gathered;
   (c) ``sharded_optimize`` with CG on a 2,048-node chain with one loop
   edge and dense on 64 nodes, within 1e-3 m of one-process ``optimize``.
   A and B must launch on every rank (``sharded_launches`` per rank in
   the JSON line); a rank that fails or hangs ends the phase with an error;
17. the port's benchmark, ``cli.main(["bench"])`` in this process at root
   bench.py's full size (the K = 8 replay of 180 32,768-point scans, TSDF
   fusion, the K = 1 online rate and latency, the fused step, the whole
   ``SlamSystem`` over its 240-scan spiral, the roofline of kernel A at
   8,192 x 65,536 and of the TSDF fusion, the MulRan fixture's ATE), the
   counters set to 0 just before and read just after, every plain-version
   call counted: its JSON line is printed, A and B must launch, no call may
   reach a plain version, both ATEs must be < 0.05 m, ``submap_overflow``
   and ``slam_system_lost_keyframes`` 0 (``bench_launches`` in the JSON
   line). Then ten main-path scans of phase 6's sequence under
   ``runtime.profiling.device_trace``: whether the profiler started, and
   the kernels and device time its trace holds.

Each kernel phase prints the kernel's time, its plain version's, the time
of one PyTorch library call computing the same function (used nowhere in
the port), and the kernel's bound: the larger of the bytes it must move
over 3.35 TB/s and its f32 operations over 67 TFLOP/s (the H100 SXM's
published peaks). Then one JSON line with every kernel's launches, error,
times and bound, the nvidia-smi line, and last ``{"ok": true, "device":
{...}}``. Any failed phase exits non-zero before the last line. Needs a
CUDA device: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

N_QUERY = 8192
N_TARGET = 262144
NN_CAP = 0.5
OCC_SCANS = 40   # synthetic scans on the occupancy path
NO_WALK_SHIFT = 1.0e4   # m: queries moved this far have no candidate tile
BOUND_TILE = 256   # target rows a tile of the walk kernel A's bound counts
OLD_Q_TILE = 64    # queries a tile of the bound of earlier revisions
KEEP_NN_BEFORE_END = 10   # the main path keeps one kernel A call's operands
                          # from the scan this many before its last
TOL = 1e-5      # kernel vs plain: atol, and rtol where a case allows it
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory, data sheet
F32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
FLUSH_BYTES = 64 * 2**20     # > the H100's 50 MB L2: evicts a call's operands
SLEEP_CYCLES = 200_000       # device sleep per queued call (~0.1 ms), so
                             # that the host has queued it before it runs


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _time_ms(fn, iters: int) -> float:
    """Mean ms per call from CUDA events, after one warm-up call. The device
    sleeps while the host queues the calls, so that the window holds the
    device's time and not the host's launch rate."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_cold_ms(fn, n: int) -> float:
    """Median ms of ``n`` single calls that each find the L2 cold, as the
    main path does (a scan's other launches run between two fusions):
    before each call a FLUSH_BYTES write and a device sleep while the host
    queues it, and events around the call alone."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    evs = []
    for i in range(n):
        flush.fill_(float(i))
        torch.cuda._sleep(SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def _turns(kernel, library, iters: int = 20, n_cold: int = 15) -> dict:
    """A kernel and its library yardstick timed in turns in one call
    (kernel, library, library, kernel), hot (``_time_ms``) and then cold
    (``_time_cold_ms``); each number the mean of its two turns."""
    hot = [_time_ms(fn, iters) for fn in (kernel, library, library, kernel)]
    cold = [_time_cold_ms(fn, n_cold)
            for fn in (kernel, library, library, kernel)]
    return {"ms": (hot[0] + hot[3]) / 2,
            "library_ms": (hot[1] + hot[2]) / 2,
            "ms_cold": (cold[0] + cold[3]) / 2,
            "library_ms_cold": (cold[1] + cold[2]) / 2,
            "turns": hot, "cold_turns": cold}


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_row(name, source, replaces, max_err, ms, plain_ms, library_ms,
                nbytes, ops, ms_cold=None, library_ms_cold=None):
    bound_ms, bound_by = _bound(nbytes, ops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "ms_cold": ms_cold,
            "library_ms_cold": library_ms_cold}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); nothing to run")
    from noetic_slam_tpu_torch import device

    dev = device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    gpu_line = smi.stdout.strip().splitlines()[0]
    print(f"[1 device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: "
          f"{gpu_line}", flush=True)
    return dev, gpu_line


def phase_build():
    from noetic_slam_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    how = ("already built" if _build.build_seconds is None
           else f"nvcc {_build.build_seconds:.2f} s")
    print(f"[2 build] kernels loaded in {secs:.2f} s ({how}) -> "
          f"{_build.library_path()}", flush=True)


def _planes_cloud(rng, n: int) -> np.ndarray:
    """Points on the six faces of a 60 m box (bench.py's roofline cloud)."""
    planes = rng.integers(0, 6, n)
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    for ax in range(3):
        pts[planes == ax, ax] = -30.0
        pts[planes == ax + 3, ax] = 30.0
    return pts


def nn_problem(dev):
    """Kernel A's operands at the slice's shapes: (query (N_QUERY, 3),
    target (N_TARGET, 3), t_count () int32, live rows). The target is a
    padded submap, live rows first in Morton order; the queries are a
    registration source: target points plus 5 cm noise, one in eight moved
    off the surfaces by ~1 m (beyond the cap), in Morton order."""
    import torch

    from noetic_slam_tpu_torch.ops.pointcloud import SENTINEL, morton_sort_key

    rng = np.random.default_rng(0)
    n_live = N_TARGET - N_TARGET // 16
    tgt = np.full((N_TARGET, 3), SENTINEL, np.float32)
    tgt[:n_live] = _planes_cloud(rng, n_live)
    valid = np.arange(N_TARGET) < n_live
    tgt_t = torch.from_numpy(tgt).to(dev)
    key = morton_sort_key(tgt_t, torch.from_numpy(valid).to(dev), 1.0)
    tgt_t = tgt_t[torch.sort(key, stable=True).indices].contiguous()
    pick = rng.choice(n_live, N_QUERY, replace=False)
    noise = rng.normal(0, 0.05, (N_QUERY, 3))
    noise[::8] = rng.normal(0, 1.0, (len(noise[::8]), 3))
    q = (tgt_t[torch.from_numpy(pick).to(dev)]
         + torch.from_numpy(noise.astype(np.float32)).to(dev))
    qkey = morton_sort_key(q, torch.ones(N_QUERY, dtype=torch.bool,
                                         device=dev), 1.0)
    q = q[torch.sort(qkey, stable=True).indices].contiguous()
    count = torch.full((), n_live, dtype=torch.int32, device=dev)
    return q, tgt_t, count, n_live


def nn_library(q, tgt, n_live):
    """Kernel A's library yardstick: brute force over the live targets with
    ``torch.cdist`` + ``amin`` (the port never calls cdist)."""
    import torch

    def library():
        for q0 in range(0, q.shape[0], 1024):
            torch.cdist(q[q0:q0 + 1024], tgt[:n_live]).amin(dim=1)

    return library


def nn_check(label, nn1, q, tgt, count, cap, live=None):
    """Kernel A (``nn1``) twice and its plain version once on the same
    operands: two runs bitwise equal, found sets equal, not-found idx 0
    with sqd = cap^2, sqd within rtol TOL, idx equal or tied within it.
    ``live`` (bool per query): compare only those; the others are
    sentinel queries, which the kernel must find nothing for (the plain
    version pairs one with a sentinel target row, where the target holds
    some inside its count). Returns (found, idx ties, max |dsqd|, plain
    sqd)."""
    import torch

    from noetic_slam_tpu_torch.ops.cuda.nn_kernel import nn1_plain

    cap_t = None if cap is None else torch.full((), cap, device=q.device)
    ik, dk = nn1(q, tgt, count, cap_t)
    ik2, dk2 = nn1(q, tgt, count, cap_t)
    ip, dp_t = nn1_plain(q, tgt, count, cap_t)
    torch.cuda.synchronize()
    _check(bool(torch.equal(ik, ik2)) and bool(torch.equal(dk, dk2)),
           f"nn {label}: two kernel runs differ")
    ik, dk, ip, dp = (x.cpu().numpy() for x in (ik, dk, ip, dp_t))
    live = np.ones(len(dk), bool) if live is None else live
    c2 = np.inf if cap is None else np.float32(cap) ** 2
    _check(bool(np.all(ik[~live] == 0) and np.all(dk[~live] == c2)),
           f"nn {label}: a sentinel query found a row")
    fk, fp = (dk < c2) & live, (dp < c2) & live
    _check(np.array_equal(fk, fp), f"nn {label}: found sets differ "
           f"({int((fk != fp).sum())} queries)")
    if cap is not None:
        _check(bool(np.all(ik[live & ~fk] == 0)),
               f"nn {label}: not-found idx != 0")
        _check(bool(np.all(dk[live & ~fk] == c2)), f"nn {label}: not-found "
               "sqd != cap^2")
    np.testing.assert_allclose(dk[fk], dp[fp], rtol=TOL, atol=0.0)
    tie = live & (ik != ip)
    _check(bool(np.all(np.isclose(dk[tie], dp[tie], rtol=TOL, atol=0.0))),
           f"nn {label}: idx differ where distances do not tie")
    err = float(np.abs(dk[fk] - dp[fk]).max()) if fk.any() else 0.0
    return fk, int(tie.sum()), err, dp_t


def _old_nn_pairs(q, tgt, count, cap2, d_plain, n_live):
    """The count earlier revisions' bound used: every query of a
    64-query tile against every row of the 256-row target tiles whose
    box-to-box bound beats the tile's final worst best."""
    import torch

    from noetic_slam_tpu_torch.ops.cuda.nn_kernel import visit_lists

    vlist, vlb, _ = visit_lists(q, tgt, count.reshape(1), cap2,
                                q_tile=OLD_Q_TILE, t_tile=BOUND_TILE,
                                per_query=False)
    worst = torch.minimum(d_plain, cap2).reshape(-1, OLD_Q_TILE).amax(dim=1)
    tile_rows = torch.clamp(n_live - vlist.long() * BOUND_TILE, 0, BOUND_TILE)
    return int((torch.where(vlb < worst[:, None], tile_rows, 0).sum(dim=1)
                * OLD_Q_TILE).sum())


def phase_nn(dev):
    import torch

    from noetic_slam_tpu_torch.ops.cuda import nn_kernel as nk

    q, tgt_t, count, n_live = nn_problem(dev)
    max_err = 0.0
    res = {}
    for label, cap in (("capped", NN_CAP), ("uncapped", None)):
        fk, ties, err, d_plain = nn_check(label, nk.nn1_fused, q, tgt_t,
                                          count, cap)
        if cap is None:
            _check(bool(fk.all()), "nn uncapped: a query found nothing")
        else:
            _check(0.5 < fk.mean() < 0.99, f"nn capped: found share "
                   f"{fk.mean():.3f} does not exercise the cap")
            d_capped = d_plain
        max_err = max(max_err, err)
        res[label] = (int(fk.sum()), ties)

    cap_t = torch.full((), NN_CAP, device=dev)
    t = _turns(lambda: nk.nn1_fused(q, tgt_t, count, cap_t),
               nn_library(q, tgt_t, n_live), iters=20, n_cold=15)
    plain_ms = _time_ms(lambda: nk.nn1_plain(q, tgt_t, count, cap_t), 3)
    # the call's two launches apart: the target boxes, then list build +
    # walk + exact distances (one fused launch, not split further)
    tbox = nk.target_boxes(tgt_t, count)
    boxes_ms = _time_ms(lambda: nk.target_boxes(tgt_t, count), 20)
    walk_ms = _time_ms(lambda: nk.walk(q, tgt_t, tbox, count, cap_t), 20)
    # the same launch with the queries moved out of every tile's reach: the
    # launch, the queries, every box-to-box test and the output, no walk
    q_far = q + NO_WALK_SHIFT
    no_walk_ms = _time_ms(lambda: nk.walk(q_far, tgt_t, tbox, count, cap_t),
                          20)

    # bound: 8 f32 operations (3 sub, 3 mul, 2 add) per query-target pair
    # of a per-query best-first walk over BOUND_TILE-row target tiles (the
    # tiles whose point-to-box bound is below the query's final best);
    # bytes: each input read once, each output written once
    pairs = nk.needed_pairs(q, tgt_t, count, cap_t, d_capped,
                            t_tile=BOUND_TILE)
    cap2 = torch.full((1,), NN_CAP ** 2, device=dev)
    old_pairs = _old_nn_pairs(q, tgt_t, count, cap2, d_capped, n_live)
    nbytes = N_QUERY * 12 + n_live * 12 + N_QUERY * 8

    # the lists the kernel builds and the rows its pruning rule scans, from
    # the plain model (one warp per group walking alone; the kernel deals a
    # list over the CTA's warps, which start knowing only the cap)
    shape = nk.kernel_shape()
    _, _, vcnt = nk.visit_lists(q, tgt_t, count.reshape(1), cap2,
                                shape["group"], shape["tile"])
    _, dk = nk.nn1_fused(q, tgt_t, count, cap_t)
    _, dm, rows = nk.nn1_walk_plain(q, tgt_t, count, cap_t,
                                     group=shape["group"],
                                     t_tile=shape["tile"])
    _check(bool(torch.equal(dm, dk)), "nn: the kernel and its walk model "
           "differ in sqd")
    model_pairs = int(rows.sum()) * shape["group"]
    chain_one = int(rows.max())
    # a warp's share of the longest walk, in tiles; a lane evaluates at most
    # tile / 32 rows x 32 queries = tile distances for each
    chain_tiles = -(-chain_one // (shape["tile"] * shape["warps"]))
    chain = chain_tiles * shape["tile"]

    row = _kernel_row("nn1_fused", "noetic_slam_tpu_torch/csrc/nn1.cu",
                      "noetic_slam_tpu/ops/pallas/nn_kernel.py:53", max_err,
                      t["ms"], plain_ms, t["library_ms"], nbytes, 8.0 * pairs,
                      ms_cold=t["ms_cold"],
                      library_ms_cold=t["library_ms_cold"])
    old_bound, _ = _bound(nbytes, 8.0 * old_pairs)
    hot = ", ".join(f"{x:.4f}" for x in t["turns"])
    cold = ", ".join(f"{x:.4f}" for x in t["cold_turns"])
    print(f"[3 nn1] {N_QUERY} x {N_TARGET} (live {n_live}): capped found "
          f"{res['capped'][0]}, uncapped found {res['uncapped'][0]}; idx "
          f"ties {res['capped'][1]}/{res['uncapped'][1]}; max |dsqd| "
          f"{max_err:.3e}; two runs bitwise equal; kernel {t['ms']:.4f} ms "
          f"hot / {t['ms_cold']:.4f} cold, cdist+amin "
          f"{t['library_ms']:.3f} hot / {t['library_ms_cold']:.3f} cold "
          f"(capped; turns kernel, cdist, cdist, kernel: hot {hot}, cold "
          f"{cold}); launches apart: target boxes {boxes_ms:.4f} ms, list "
          f"build + walk + exact distances (fused) {walk_ms:.4f} ms, of which "
          f"{no_walk_ms:.4f} ms without any walk (the same launch with the "
          f"queries moved {NO_WALK_SHIFT:.0f} m away: no candidate); plain "
          f"{plain_ms:.3f} ms; shape {shape['group']} queries x "
          f"{shape['warps']} warps a CTA, {shape['tile']}-row tiles; lists: "
          f"longest {int(vcnt.max())}, mean {float(vcnt.float().mean()):.1f} "
          f"tiles; walk model: {model_pairs} pairs if every query of a "
          f"group scanned the tiles any of them needs, longest walk "
          f"{chain_one} rows for one warp alone, about {chain_tiles} tiles "
          f"a warp dealt over {shape['warps']} warps: at most {chain} "
          f"distance evaluations a thread; bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}; {pairs} pairs of a per-query walk over "
          f"{BOUND_TILE}-row tiles, "
          f"{pairs / (N_QUERY * n_live):.5f} of brute force); the bound of "
          f"earlier revisions (64-query tiles, box to box) {old_pairs} "
          f"pairs, {old_bound:.4f} ms", flush=True)
    return row


def phase_nn_main_shape(kept):
    """Kernel A and ``cdist``+``amin`` in turns on the operands of one real
    ``update_correspondences`` call kept from the main path's run, after
    the same checks against the plain version."""
    from noetic_slam_tpu_torch.ops.cuda import nn_kernel as nk

    scan, (q, tgt, count, cap_t) = kept["scan"], kept["args"]
    n_live = int(count)
    fk, ties, err, _ = nn_check("main shape", nk.nn1_fused, q, tgt, count,
                                float(cap_t))
    t = _turns(lambda: nk.nn1_fused(q, tgt, count, cap_t),
               nn_library(q, tgt, n_live), iters=20, n_cold=10)
    print(f"[6b nn1 at the main path's shape] the first correspondence "
          f"search of scan {scan}: {q.shape[0]} queries x {tgt.shape[0]} "
          f"target rows (live {n_live}), cap {float(cap_t):.3f} m: found "
          f"{int(fk.sum())}, idx ties {ties}, max |dsqd| {err:.3e}; kernel "
          f"{t['ms']:.4f} ms hot / {t['ms_cold']:.4f} cold, cdist+amin "
          f"{t['library_ms']:.3f} hot / {t['library_ms_cold']:.3f} cold",
          flush=True)
    return {"main_shape_ms": t["ms"], "main_shape_ms_cold": t["ms_cold"],
            "main_shape_library_ms": t["library_ms"],
            "main_shape_live_rows": n_live}


def _stream_addresses(runs, ivox):
    """(flat payload index, stream position) of every sample of a real
    entry: the operands of the one ``index_add_`` that computes a block
    accumulation's sums (the library yardstick), and what its bound
    counts (the distinct voxels it changes)."""
    from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import entry_addresses

    ent, pos = entry_addresses(runs.starts, runs.cnts)
    return runs.rows.long()[ent] * 512 + ivox[pos].long(), pos


def _check_accum(tag, kernel, plain, pay, args, limits, hit, rtol):
    """Kernel twice and plain once, each on copies of the payload tensors
    ``pay``: the two kernel runs bitwise equal, the plain version within
    atol TOL and ``rtol``, and every voxel no sample hits (``hit`` False;
    untouched rows included) unchanged bitwise. Returns (kernel payload,
    max |error|)."""
    import torch

    runs = []
    for _ in range(2):
        out = [p.clone() for p in pay]
        kernel(*out, *args, *limits)
        runs.append(out)
    want = [p.clone() for p in pay]
    plain(*want, *args, *limits)
    torch.cuda.synchronize()
    err = 0.0
    for a, b, p, x in zip(runs[0], runs[1], want, pay):
        _check(bool(torch.equal(a, b)), f"{tag}: two kernel runs differ")
        torch.testing.assert_close(a, p, rtol=rtol, atol=TOL)
        err = max(err, float((a - p).abs().max()))
        _check(bool(torch.equal(a.view(-1)[~hit], x.view(-1)[~hit])),
               f"{tag}: a voxel no sample hits changed")
    return runs[0], err


def _check_cancel(tag, kernel, like, args, limits):
    """Unclamped: the stream fused with sign +1 and then -1 into a zero
    payload (one tensor per channel, shaped as ``like``) gives exactly 0."""
    import torch

    rows, starts, cnts, ivox, *chans = args
    out = [torch.zeros_like(like) for _ in chans]
    kernel(*out, rows, starts, cnts, ivox, *chans, *limits)
    _check(any(bool((x != 0).any()) for x in out),
           f"{tag} cancel: the +1 fusion changed nothing")
    kernel(*out, rows, starts, cnts, ivox, *(-c for c in chans), *limits)
    _check(all(bool((x == 0).all()) for x in out),
           f"{tag} cancel: +1 then -1 left "
           f"{max(float(x.abs().max()) for x in out):.3e}")


def _entry_shape(runs):
    """(real entries, largest entry, serial 32-sample tiles of the longest
    warp chain, as the built kernel cuts the entries (``entry_cut``), and
    of the largest entry alone if it had every warp of a CTA:
    ceil(largest / (32 x warps per entry)))."""
    from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import entry_cut

    warps, short, part = entry_cut()
    cnts = runs.cnts[runs.cnts > 0].long()
    parts = _ceil_div(cnts, part).clamp(max=warps)
    parts[cnts <= short] = 1
    sub = _ceil_div(_ceil_div(cnts, parts), 32) * 32      # whole tiles
    chain = int(_ceil_div(sub, 32).max()) if cnts.numel() else 0
    largest = int(runs.cnts.max())
    return int(cnts.numel()), largest, chain, -(-largest // (32 * warps))


def _ceil_div(a, b):
    """ceil(a / b) of non-negative integer tensors, elementwise."""
    return (a + b - 1) // b


def _hit_mask(runs, ivox, numel):
    import torch

    flat, _ = _stream_addresses(runs, ivox)
    hit = torch.zeros(numel, dtype=torch.bool, device=ivox.device)
    hit[flat] = True
    return hit


def tsdf_problem(dev, rng, sign):
    """Kernel B's operands at one scan's shapes: 32,768 points of the
    60 m box scene at half size, their ray samples (23 per point) with
    weights times ``sign``, block-sorted into a default ``TsdfConfig`` map;
    a payload with history (weights in [0, 100], wsum up to 0.3 of them).
    Returns (BlockRuns, (rows, starts, cnts, ivox, w, wd), (W, WS))."""
    import torch

    from noetic_slam_tpu_torch.config import TsdfConfig
    from noetic_slam_tpu_torch.models import tsdf as tsdf_mod

    tcfg = TsdfConfig()
    pts = torch.from_numpy(_planes_cloud(rng, 32768) * 0.5).to(dev)
    valid = torch.ones(32768, dtype=torch.bool, device=dev)
    pos, sdf, w = tsdf_mod._ray_samples(tcfg, pts, valid,
                                        torch.zeros(3, device=dev))
    _check(pos.shape[0] == 32768 * 23, f"tsdf: {pos.shape[0]} samples")
    st = tsdf_mod.init_tsdf(tcfg, dev)
    st, r, stream = tsdf_mod.block_stream(tcfg, st, pos, sdf, w * sign)
    W = torch.from_numpy(rng.uniform(0, 100, st.weight.shape)
                         .astype(np.float32)).to(dev)
    WS = W * torch.from_numpy(rng.uniform(-0.3, 0.3, st.weight.shape)
                              .astype(np.float32)).to(dev)
    return r, (r.rows, r.starts, r.cnts, *stream), (W, WS)


def logodds_problem(dev, rng, sign):
    """Kernel C's operands at one scan's shapes: the same scene's beam
    samples (1 hit + 24 free-space per point) with deltas times ``sign``,
    block-sorted into a default ``OccupancyConfig`` map; a payload with
    history, uniform in [l_min, l_max]. Returns (BlockRuns, (rows, starts,
    cnts, ivox, delta), (L,))."""
    import torch

    from noetic_slam_tpu_torch.config import OccupancyConfig
    from noetic_slam_tpu_torch.models import occupancy as occ_mod

    ocfg = OccupancyConfig()
    pts = torch.from_numpy(_planes_cloud(rng, 32768) * 0.5).to(dev)
    valid = torch.ones(32768, dtype=torch.bool, device=dev)
    pos, delta = occ_mod._beam_samples(ocfg, pts, valid,
                                       torch.zeros(3, device=dev))
    _check(pos.shape[0] == 32768 * (1 + ocfg.miss_samples),
           f"logodds: {pos.shape[0]} samples")
    st = occ_mod.init_occupancy(ocfg, dev)
    st, r, stream = occ_mod.delta_stream(ocfg, st, pos, delta * sign)
    L = torch.from_numpy(rng.uniform(ocfg.l_min, ocfg.l_max,
                                     st.logodds.shape)
                         .astype(np.float32)).to(dev)
    return r, (r.rows, r.starts, r.cnts, *stream), (L,)


def _accum_phase(kernel, plain, problem, cases, clamp_range, dev, seed):
    """Kernel B or C against its plain version on one scan's stream, for
    each ``(label, limits, sign, rtol)`` of ``cases`` (the first clamped,
    whose first channel must end inside ``clamp_range``; the second
    unclamped and signed, which must leave it); the exact +-1 cancellation
    on the unclamped limits; the kernel and one ``index_add_`` of the same
    stream timed in turns, hot and cold, on the first case. Returns (runs
    and stream of the first case, its timings, plain ms, kernel ms and max
    |error| of each case)."""
    import torch

    rng = np.random.default_rng(seed)
    errs, got = [], []
    for label, limits, sign, rtol in cases:
        r, args, pay = problem(dev, rng, sign)
        n_blocks = int((r.cnts > 0).sum())
        _check(n_blocks > 1000, f"{problem.__name__} {label}: only "
               f"{n_blocks} blocks")
        hit = _hit_mask(r, args[3], pay[0].numel())
        out, err = _check_accum(f"{problem.__name__} {label}", kernel,
                                plain, pay, args, limits, hit, rtol)
        errs.append(err)
        inside = (clamp_range[0] <= float(out[0].min())
                  and float(out[0].max()) <= clamp_range[1])
        _check(inside == (not got), f"{problem.__name__} {label}: first "
               f"channel in [{float(out[0].min())}, {float(out[0].max())}]")
        got.append((r, args, limits, out))
    (r, args, limits, out), (_, _, limits2, _) = got
    _check_cancel(problem.__name__, kernel, out[0], args, limits2)
    plain_ms, kernel_ms = [], []
    for _, a, lim, o in got:
        work = [p.clone() for p in o]
        plain_ms.append(_time_ms(lambda: plain(*work, *a, *lim), 5))
        kernel_ms.append(_time_ms(lambda: kernel(*work, *a, *lim), 20))
    flat, spos = _stream_addresses(r, args[3])
    vals = torch.stack([c[spos] for c in args[4:]], dim=1)
    lib_pay = torch.zeros((out[0].numel(), vals.shape[1]), device=dev)
    work = [p.clone() for p in out]
    t = _turns(lambda: kernel(*work, *args, *limits),
               lambda: lib_pay.index_add_(0, flat, vals))
    return r, args, t, plain_ms, kernel_ms, errs


def _accum_line(r, args, t, plain_ms, kernel_ms, errs, row, labels):
    n_blocks, largest, chain, chain_largest = _entry_shape(r)
    n_samples, n_vox = _voxel_counts(r, args[3])
    hot = ", ".join(f"{x:.4f}" for x in t["turns"])
    cold = ", ".join(f"{x:.4f}" for x in t["cold_turns"])
    return (f"{args[3].shape[0]} samples ({n_samples} in real entries, "
            f"{n_vox} voxels), {n_blocks} blocks, largest {largest} samples "
            f"(mean {n_samples / n_blocks:.0f}), longest chain {chain} "
            f"tiles (the largest entry's alone: {chain_largest}): max |d| "
            f"{errs[0]:.3e} / {errs[1]:.3e} ({labels[0]} / {labels[1]}); "
            f"kernel "
            f"{t['ms']:.4f} ms hot / {t['ms_cold']:.4f} cold, index_add_ "
            f"{t['library_ms']:.4f} hot / {t['library_ms_cold']:.4f} cold "
            f"({labels[0]}; turns kernel, index_add_, index_add_, kernel: "
            f"hot {hot}, cold {cold}); kernel {kernel_ms[0]:.4f} / "
            f"{kernel_ms[1]:.4f} ms, plain {plain_ms[0]:.3f} / "
            f"{plain_ms[1]:.3f} ms ({labels[0]} / {labels[1]}); bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}); two runs "
            f"bitwise equal, +1/-1 exact, unhit voxels unchanged")


def _voxel_counts(r, ivox):
    """(samples in real entries, distinct voxels they hit)."""
    import torch

    flat, _ = _stream_addresses(r, ivox)
    return int(flat.shape[0]), int(torch.unique(flat).shape[0])


def phase_tsdf(dev):
    from noetic_slam_tpu_torch.config import TsdfConfig
    from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import (
        NO_CLAMP,
        block_accumulate,
        block_accumulate_plain,
    )

    # rtol and atol TOL in both cases (weights up to 100)
    cases = (("clamped", (TsdfConfig().max_weight,), 1.0, TOL),
             ("no_clamp", (NO_CLAMP,), -1.0, TOL))
    r, args, t, plain_ms, kernel_ms, errs = _accum_phase(
        block_accumulate, block_accumulate_plain, tsdf_problem, cases,
        (0.0, cases[0][1][0]), dev, seed=1)
    n_samples, n_vox = _voxel_counts(r, args[3])
    # bound: the entries and the stream read once (12 B per sample), each
    # voxel the samples change read and written once in both channels
    row = _kernel_row(
        "block_accumulate", "noetic_slam_tpu_torch/csrc/block_accum.cu",
        "noetic_slam_tpu/ops/pallas/tsdf_kernel.py:51", max(errs), t["ms"],
        plain_ms[0], t["library_ms"],
        nbytes=12 * r.rows.shape[0] + 12 * n_samples + 16 * n_vox,
        ops=2 * n_samples + 5 * n_vox, ms_cold=t["ms_cold"],
        library_ms_cold=t["library_ms_cold"])
    print("[4 tsdf] " + _accum_line(r, args, t, plain_ms, kernel_ms, errs,
                                    row, ("clamped", "no_clamp")), flush=True)
    return row


def phase_logodds(dev):
    from noetic_slam_tpu_torch.config import OccupancyConfig
    from noetic_slam_tpu_torch.ops.cuda.logodds_kernel import (
        UNCLAMPED,
        logodds_accumulate,
        logodds_accumulate_plain,
    )

    ocfg = OccupancyConfig()
    # clamped: atol TOL alone (|L| <= 3.5); signed: also rtol TOL, since
    # its unclamped sums reach ~1e3, where one f32 ulp is ~6e-5 and the
    # plain version's index_add_ adds in another order
    cases = (("clamped", (ocfg.l_min, ocfg.l_max), 1.0, 0.0),
             ("signed", (-UNCLAMPED, UNCLAMPED), -1.0, TOL))
    r, args, t, plain_ms, kernel_ms, errs = _accum_phase(
        logodds_accumulate, logodds_accumulate_plain, logodds_problem, cases,
        cases[0][1], dev, seed=2)
    n_samples, n_vox = _voxel_counts(r, args[3])
    # bound: the entries and the stream read once (8 B per sample), each
    # voxel the samples change read and written once
    row = _kernel_row(
        "logodds_accumulate", "noetic_slam_tpu_torch/csrc/block_accum.cu",
        "noetic_slam_tpu/ops/pallas/tsdf_kernel.py:112", max(errs), t["ms"],
        plain_ms[0], t["library_ms"],
        nbytes=12 * r.rows.shape[0] + 8 * n_samples + 8 * n_vox,
        ops=n_samples + 3 * n_vox, ms_cold=t["ms_cold"],
        library_ms_cold=t["library_ms_cold"])
    print("[5 logodds] " + _accum_line(r, args, t, plain_ms, kernel_ms,
                                       errs, row, ("clamped", "signed")),
          flush=True)
    return row


def _profile(run, lo: int, hi: int, tag: str) -> None:
    """torch.profiler over scans [lo, hi): wall and device-busy time per
    scan, stream syncs, the kernels that take the device time, and each
    step stage (the ``record_function`` ranges of models/odometry.py):
    host time in it, device time of the kernels it launched, and its span
    on the device timeline (gaps included). The profiler slows the host
    side; take rates from the unprofiled window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stage_prefix = ("odometry.", "tsdf.", "occupancy.")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(lo, hi)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: not the ranges' device-timeline spans, not aten ops
    # (whose device time repeats their kernels')
    kernels = sorted((e for e in evs if e.device_type == DeviceType.CUDA
                      and not e.key.startswith(stage_prefix)),
                     key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels)
    calls = {e.key: e.count for e in evs}
    n = hi - lo
    print(f"[profile {tag}] {n} scans: wall {wall_us / n / 1e3:.2f} ms/scan, device "
          f"busy {busy / n / 1e3:.2f} ms/scan ({100 * busy / wall_us:.1f}%); "
          f"per scan: {sum(e.count for e in kernels) / n:.0f} kernels, "
          f"cudaStreamSynchronize "
          f"{calls.get('cudaStreamSynchronize', 0) / n:.1f}, "
          f"cudaMemcpyAsync {calls.get('cudaMemcpyAsync', 0) / n:.1f}",
          flush=True)
    for e in kernels[:10]:
        print(f"[profile {tag}]   {dev_us(e) / n / 1e3:8.3f} ms/scan "
              f"{e.count / n:7.1f} calls/scan  {e.key[:90]}", flush=True)
    stages = {}
    for e in evs:
        if e.key.startswith(stage_prefix):
            stages.setdefault(e.key, {})[e.device_type] = e
    for key in sorted(stages, key=lambda k: -stages[k][DeviceType.CPU]
                      .cpu_time_total):
        host = stages[key][DeviceType.CPU]
        span = stages[key].get(DeviceType.CUDA)
        print(f"[profile {tag}]   stage {key:<26} host "
              f"{host.cpu_time_total / n / 1e3:7.3f} ms, device work "
              f"{host.device_time_total / n / 1e3:6.3f} ms, device span "
              f"{(span.device_time_total if span else 0.0) / n / 1e3:7.3f} "
              f"ms per scan", flush=True)


def _main_cfg():
    """The main path's configuration: the production capacities."""
    from noetic_slam_tpu_torch.config import (
        CapacityConfig,
        DlioConfig,
        KeyframeConfig,
    )

    return DlioConfig(
        capacity=CapacityConfig(
            max_points=32768, max_ds_points=8192, max_deskew_frames=2048,
            max_imu_window=128, max_keyframes=128, max_submap_kf=32),
        adaptive=False, keyframe=KeyframeConfig(thresh_dist=0.5))


def _counters():
    """name -> wrapper of every kernel; each counts its own launches."""
    from noetic_slam_tpu_torch.ops.cuda import (
        logodds_kernel,
        nn_kernel,
        tsdf_kernel,
    )

    return {"nn1_fused": nn_kernel.nn1_fused,
            "block_accumulate": tsdf_kernel.block_accumulate,
            "logodds_accumulate": logodds_kernel.logodds_accumulate}


def _drive(tag: str, cfg, sim, scans, n_scans: int, n_profile: int = 0,
           on_scan=None):
    """``OdometryPipeline(cfg, with_tsdf=True)``, on the card by default,
    over ``scans[:n_scans]`` (the first ten untimed), with every launch
    counter set to 0 just before and read just after; then ``n_profile``
    more scans under torch.profiler. Checks the trajectory and returns
    (pipeline, trajectory, launches, stats). ``on_scan(i)`` is called
    before scan ``i`` is processed."""
    import torch

    from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
    from noetic_slam_tpu_torch.utils import synthetic

    counters = _counters()
    pipe = OdometryPipeline(cfg, with_tsdf=True)
    _check(pipe.device.type == "cuda", f"{tag}: not on the card")
    imu_i = 0

    def run(lo, hi):
        nonlocal imu_i
        for i, (h, xyz, pt) in enumerate(scans[lo:hi], start=lo):
            if on_scan is not None:
                on_scan(i)
            while (imu_i < len(sim.imu_stamps)
                   and sim.imu_stamps[imu_i] <= h + pt.max() + 0.02):
                pipe.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                              sim.imu_acc[imu_i])
                imu_i += 1
            pipe.process_scan(h, xyz, pt)

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for fn in counters.values():
        fn.launches = 0
    warm = min(10, n_scans // 3)
    run(0, warm)
    syncs0 = pipe.host_syncs
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    start.record()
    run(warm, n_scans)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    launches = {name: fn.launches for name, fn in counters.items()}
    n_timed = n_scans - warm
    ev_ms = start.elapsed_time(end)
    stats = {"rate": 1e3 * n_timed / ev_ms, "wall_rate": n_timed / wall,
             "syncs": (pipe.host_syncs - syncs0) / n_timed,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "base_gib": base / 2**30,
             "n_timed": n_timed, "ev_ms": ev_ms}
    if n_profile:
        _profile(run, n_scans, n_scans + n_profile, tag)

    traj = pipe.flush()
    n_run = n_scans + n_profile
    _check(len(traj) == n_run, f"{tag}: {len(traj)} of {n_run} scans "
           "processed")
    _check(bool(np.isfinite(traj).all()), f"{tag}: non-finite pose")
    stats["ate"] = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4],
                                      sim.gt_stamps, sim.gt_pos)
    _check(stats["ate"] < 0.05, f"{tag}: ATE {stats['ate']:.4f} m >= 0.05 m")
    if cfg.gicp.nn_engine == "brute":
        _check(launches["nn1_fused"] > 0, f"{tag}: kernel A never launched")
    else:
        _check(launches["nn1_fused"] == 0,
               f"{tag}: kernel A launched {launches['nn1_fused']} times "
               f"with the grid engine")
    _check(pipe.submap_overflow == 0,
           f"{tag}: submap_overflow {pipe.submap_overflow}")
    _check(int(pipe.tsdf_state.num_blocks) > 0, f"{tag}: empty map")
    return pipe, traj, launches, stats


def _path_line(stats, pipe) -> str:
    return (f"steady {stats['n_timed']} scans in {stats['ev_ms']:.1f} ms "
            f"CUDA events = {stats['rate']:.2f} scans/s (wall "
            f"{stats['wall_rate']:.2f} scans/s); host_syncs/scan "
            f"{stats['syncs']:.2f}; peak memory {stats['peak_gib']:.3f} GiB "
            f"({stats['base_gib']:.3f} GiB allocated before the path);"
            f" ATE {stats['ate']:.4f} m; blocks "
            f"{int(pipe.tsdf_state.num_blocks)}, dropped "
            f"{int(pipe.tsdf_state.dropped)}; submap_overflow "
            f"{pipe.submap_overflow}")


def phase_main_path(cfg, sim, scans, n_scans: int, n_profile: int = 0):
    import torch

    from noetic_slam_tpu_torch.ops import neighbors

    # keep the operands of one real correspondence search late in the run
    # (phase 6b times kernel A on them): the first of the chosen scan
    kept = {"scan": max(0, n_scans - KEEP_NN_BEFORE_END)}
    now = {"scan": -1}
    inner = neighbors.nn1

    def keeping(query, target, t_count=None, max_dist=None):
        if now["scan"] == kept["scan"] and "args" not in kept:
            kept["args"] = tuple(x.clone() for x in (query, target, t_count,
                                                     max_dist))
        return inner(query, target, t_count, max_dist)

    neighbors.nn1 = keeping
    try:
        pipe, traj, launches, stats = _drive(
            "main path", cfg, sim, scans, n_scans, n_profile,
            on_scan=lambda i: now.update(scan=i))
    finally:
        neighbors.nn1 = inner
    _check("args" in kept, f"main path: scan {kept['scan']} made no "
           "correspondence search")
    _check(launches["block_accumulate"] == n_scans,
           f"main path: kernel B launched {launches['block_accumulate']} "
           f"times for {n_scans} scans")
    _check(bool(torch.isfinite(pipe.tsdf_state.weight).all()),
           "main path: non-finite TSDF weight")
    print(f"[6 main path] {n_scans} scans x 32768 points, tsdf: "
          f"{_path_line(stats, pipe)}; launches {launches}", flush=True)
    return pipe, traj, launches, kept


def phase_occupancy_path(cfg, sim, scans, n_scans: int, n_profile: int = 0):
    import torch

    ocfg = cfg.replace(map_backend="occupancy")
    pipe, traj, launches, stats = _drive("occupancy path", ocfg, sim,
                                         scans, n_scans, n_profile)
    L = pipe.tsdf_state.logodds
    _check(launches["logodds_accumulate"] == n_scans,
           f"occupancy path: kernel C launched "
           f"{launches['logodds_accumulate']} times for {n_scans} scans")
    _check(launches["block_accumulate"] == 0,
           "occupancy path: kernel B launched")
    _check(bool(torch.isfinite(L).all()), "occupancy path: non-finite L")
    lo, hi = float(L.min()), float(L.max())
    o = ocfg.occupancy
    _check(o.l_min <= lo and hi <= o.l_max,
           f"occupancy path: log-odds [{lo}, {hi}] outside [l_min, l_max]")
    n_occ = int((L > o.occ_thresh).sum())
    _check(n_occ > 0, "occupancy path: no occupied voxel")
    print(f"[7 occupancy path] {n_scans} scans x 32768 points, occupancy: "
          f"{_path_line(stats, pipe)}; occupied voxels {n_occ}; log-odds "
          f"[{lo:.3f}, {hi:.3f}]; launches {launches}", flush=True)
    return pipe, traj, launches


def _timed(fn):
    """(result, host ms) of the second call of ``fn()`` (the first loads
    its kernels), closed by a device synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


ESDF_SHAPE = (96, 96, 24)       # the CLI's region around the final pose


def _esdf_check(tag, fn, mcfg, state, traj):
    import torch

    v = mcfg.voxel_size
    lo = traj[-1, 1:4] - 0.5 * v * np.asarray(ESDF_SHAPE)
    (field, observed, _), ms = _timed(lambda: fn(mcfg, state, lo,
                                                 shape=ESDF_SHAPE,
                                                 max_dist=3.0))
    _check(tuple(field.shape) == ESDF_SHAPE, f"{tag} esdf: shape")
    _check(bool(torch.isfinite(field).all()), f"{tag} esdf: non-finite")
    n_obs = int(observed.sum())
    _check(n_obs > 0, f"{tag} esdf: nothing observed")
    return n_obs, ms


def phase_map_products(tsdf_cfg, tsdf_state, tsdf_traj, occ_cfg, occ_state,
                       occ_traj):
    from noetic_slam_tpu_torch.io.meshing import extract_mesh
    from noetic_slam_tpu_torch.models import esdf as esdf_mod
    from noetic_slam_tpu_torch.models import occupancy as occ_mod
    from noetic_slam_tpu_torch.models import tsdf as tsdf_mod

    (pts, _, mask), surf_ms = _timed(
        lambda: tsdf_mod.extract_surface(tsdf_cfg, tsdf_state))
    n_surf = int(mask.sum())
    _check(n_surf > 0, "map products: no TSDF surface point")
    (verts, faces), mesh_ms = _timed(lambda: extract_mesh(tsdf_cfg,
                                                          tsdf_state))
    _check(len(faces) > 0 and np.isfinite(verts).all(),
           "map products: empty or non-finite mesh")
    n_obs, esdf_ms = _esdf_check("tsdf", esdf_mod.esdf_region, tsdf_cfg,
                                 tsdf_state, tsdf_traj)
    (_, _, omask), occ_ms = _timed(
        lambda: occ_mod.extract_occupied(occ_cfg, occ_state))
    n_occ = int(omask.sum())
    _check(n_occ > 0, "map products: no occupied voxel")
    n_oobs, oesdf_ms = _esdf_check("occupancy",
                                   esdf_mod.esdf_region_occupancy, occ_cfg,
                                   occ_state, occ_traj)
    print(f"[8 map products] tsdf: extract_surface {n_surf} points "
          f"{surf_ms:.1f} ms, extract_mesh {len(verts)} vertices / "
          f"{len(faces)} faces {mesh_ms:.1f} ms, esdf_region "
          f"{ESDF_SHAPE} {n_obs} observed {esdf_ms:.1f} ms; occupancy: "
          f"extract_occupied {n_occ} voxels {occ_ms:.1f} ms, "
          f"esdf_region_occupancy {n_oobs} observed {oesdf_ms:.1f} ms",
          flush=True)


# ---------------------------------------------------------------------------
# The whole system: SlamSystem at bench.py's full width (phase 9), a loop
# closure on the drifting loop (phase 10), and kernels A and B on operands
# kept from their calls there (phase 11)
# ---------------------------------------------------------------------------

SYSTEM_SCANS = 128        # of bench.py's 240-scan whole-system sequence
                          # (phase 17 runs all of it; the spiral's revisit
                          # and closure come at ~200, so the closing call
                          # is timed in phase 10)
SYSTEM_K = 8              # scans a batch (bench.py's K)
SYSTEM_UNTIMED = 32       # the first four batches, untimed as in bench.py


def _system_cfg():
    """bench.py:286-351's whole-system configuration, at its full width."""
    from noetic_slam_tpu_torch.config import (
        CapacityConfig,
        DlioConfig,
        KeyframeConfig,
        TsdfConfig,
    )

    return DlioConfig(
        capacity=CapacityConfig(
            max_points=8192, max_ds_points=4096, max_deskew_frames=1024,
            max_imu_window=128, max_keyframes=128, max_submap_kf=16,
            max_trajectory=4096),
        adaptive=False, keyframe=KeyframeConfig(thresh_dist=0.5,
                                                thresh_rot=45.0),
        tsdf=TsdfConfig(voxel_size=0.2, truncation=0.6, max_blocks=16384,
                        space_carving=False, scan_block_cap=2048))


class _Probes:
    """Wrappers around the system path's calls of kernels A and B: the
    launches of A inside ``verify_loop`` and of B inside the archive's
    fusion, the operands of the first such call of each (B: the first of
    a fusion with a sign -1 entry once there is one, else the first), and
    every call that reaches a plain version (there must be none on the
    card)."""

    def __init__(self):
        from noetic_slam_tpu_torch.models import occupancy as occ_mod
        from noetic_slam_tpu_torch.models import posegraph as pg
        from noetic_slam_tpu_torch.models import tsdf as tsdf_mod
        from noetic_slam_tpu_torch.ops import neighbors
        from noetic_slam_tpu_torch.ops.cuda import nn_kernel, tsdf_kernel
        from noetic_slam_tpu_torch.runtime import archive as ar_mod

        self.where = None
        self.signed = False
        self.verify_a = self.archive_b = self.plain_calls = 0
        self.nn = self.fuse = None
        A, B = nn_kernel.nn1_fused, tsdf_kernel.block_accumulate

        def verify(*a, **kw):
            n0, self.where = A.launches, "verify"
            try:
                return self._orig[0][2](*a, **kw)
            finally:
                self.verify_a += A.launches - n0
                self.where = None

        def nn1(query, target, t_count=None, max_dist=None):
            if self.where == "verify" and self.nn is None:
                self.nn = tuple(x.clone() if hasattr(x, "clone") else x
                                for x in (query, target, t_count, max_dist))
            return self._orig[1][2](query, target, t_count, max_dist)

        def fuse_scan(*a, **kw):
            n0, self.where = B.launches, "archive"
            self.signed = bool(np.any(np.asarray(a[7]) < 0))
            try:
                return self._orig[2][2](*a, **kw)
            finally:
                self.archive_b += B.launches - n0
                self.where = None

        def accumulate(weight, wsum, *args):
            if self.where == "archive" and (
                    self.fuse is None or (self.signed and not self.fuse[2])):
                self.fuse = ((weight.clone(), wsum.clone()),
                             tuple(x.clone() if hasattr(x, "clone") else x
                                   for x in args), self.signed)
            return self._orig[3][2](weight, wsum, *args)

        def plain(orig):
            def counted(*a, **kw):
                self.plain_calls += 1
                return orig(*a, **kw)
            return counted

        self._orig = [(pg, "verify_loop", pg.verify_loop, verify),
                      (neighbors, "nn1", neighbors.nn1, nn1),
                      (ar_mod, "_fuse_scan", ar_mod._fuse_scan, fuse_scan),
                      (tsdf_mod, "block_accumulate", tsdf_mod.block_accumulate,
                       accumulate)]
        for mod, name in ((neighbors, "nn1_plain"),
                          (tsdf_mod, "block_accumulate_plain"),
                          (occ_mod, "logodds_accumulate_plain")):
            fn = getattr(mod, name)
            self._orig.append((mod, name, fn, plain(fn)))

    def __enter__(self):
        for mod, name, _, wrapper in self._orig:
            setattr(mod, name, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, name, fn, _ in self._orig:
            setattr(mod, name, fn)


def _feeder(slam, sim):
    """feed(through): push the sim's IMU samples up to ``through``."""
    state = {"i": 0}

    def feed(through):
        i = state["i"]
        while i < len(sim.imu_stamps) and sim.imu_stamps[i] <= through:
            slam.push_imu(sim.imu_stamps[i], sim.imu_ang[i], sim.imu_acc[i])
            i += 1
        state["i"] = i

    return feed


def _batches(slam, scans, feed, lo, hi, close_calls=None):
    """bench.py's loop: batches of SYSTEM_K scans through process_scans
    and, when ``close_calls`` is a list, maybe_close_loop every third
    batch (its host syncs, seconds and verdict appended)."""
    for b0 in range(lo, hi, SYSTEM_K):
        chunk = scans[b0:min(b0 + SYSTEM_K, hi)]
        feed(max(h + pt.max() for h, _, pt in chunk) + 0.02)
        slam.process_scans(chunk)
        if close_calls is not None and b0 % (3 * SYSTEM_K) == 0 and b0 > 0:
            s0, t0 = slam.host_syncs, time.perf_counter()
            closed = slam.maybe_close_loop()
            close_calls.append((slam.host_syncs - s0,
                                time.perf_counter() - t0, closed))


def _closure_line(log) -> str:
    return "; ".join(
        f"{c['source']} {c['cand_node']}->{c['cur_node']} correction "
        f"{c['correction_m']:.3f} m, moved {c['moved_keyframes']} of "
        f"{c['archived']}, {c['seconds']:.3f} s (t_optimize "
        f"{c['t_optimize']:.3f}, t_apply {c['t_apply']:.3f}, t_map_sync "
        f"{c['t_map_sync']:.3f})" for c in log) or "none"


def phase_system(probes: _Probes):
    """Phase 9: ``SlamSystem(pipelined=True)`` on the card at bench.py's
    full width, driven as bench.py drives it (warmup, batches of 8,
    maybe_close_loop every third batch, the first 32 scans untimed), the
    launch counters set to 0 just before and read just after; then the
    same scans through the fused step alone (``OdometryPipeline``) for its
    rate in the same call."""
    import torch

    from noetic_slam_tpu_torch import SlamSystem
    from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
    from noetic_slam_tpu_torch.utils import synthetic

    cfg = _system_cfg()
    t0 = time.perf_counter()
    sim = synthetic.make_sim(duration=SYSTEM_SCANS / 10.0 + 0.4,
                             n_points=cfg.capacity.max_points,
                             calib_time=3.1, seed=23,
                             pose_fn=synthetic.spiral_pose_of,
                             imu_noise=0.0005)
    scans = [sim.scan(i) for i in range(SYSTEM_SCANS)]
    sim_s = time.perf_counter() - t0
    untimed = SYSTEM_UNTIMED
    counters = _counters()
    slam = SlamSystem(cfg, enable_tsdf=True, enable_loop_closure=True,
                      loop_radius=4.0, loop_min_gap=15, pipelined=True)
    _check(slam.device.type == "cuda", "system: not on the card")
    feed = _feeder(slam, sim)
    calls = []
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for fn in counters.values():
        fn.launches = 0
    with probes:
        t0 = time.perf_counter()
        slam.warmup()
        warm_s = time.perf_counter() - t0
        _batches(slam, scans, feed, 0, untimed, calls)
        n_calls0 = len(calls)
        s0, o0 = slam.host_syncs, slam.odometry.host_syncs
        stages0 = slam.stages.snapshot()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        start.record()
        _batches(slam, scans, feed, untimed, len(scans), calls)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        launches = {name: fn.launches for name, fn in counters.items()}
    n_timed = len(scans) - untimed
    syncs = slam.host_syncs - s0
    step_syncs = slam.odometry.host_syncs - o0
    peak = torch.cuda.max_memory_allocated()
    stages = slam.stages.delta(stages0, slam.stages.snapshot())
    slam.sync_graph()                 # drain the last cadence (lossless)
    traj = slam.flush()
    _check(len(traj) == len(scans), f"system: {len(traj)} of {len(scans)} "
           "scans processed")
    _check(bool(np.isfinite(traj).all()), "system: non-finite pose")
    ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                             sim.gt_pos)
    _check(slam.sync_lost_keyframes == 0,
           f"system: {slam.sync_lost_keyframes} keyframes lost")
    total = int(slam.odometry.state.kf_total)
    _check(slam._synced_total == total == len(slam.archive),
           f"system: {slam._synced_total} synced, {total} created, "
           f"{len(slam.archive)} archived")
    _check(launches["nn1_fused"] > 0 and launches["block_accumulate"] > 0,
           f"system: launches {launches}")
    _check(launches["logodds_accumulate"] == 0,
           "system: kernel C launched on the TSDF system")
    _check(probes.archive_b > 0, "system: no archive fusion ran kernel B")
    _check(probes.plain_calls == 0,
           f"system: {probes.plain_calls} calls reached a plain version")
    _check(bool(torch.isfinite(slam.tsdf.weight).all()),
           "system: non-finite map weight")
    timed_calls = calls[n_calls0:]
    closing = [c for c in timed_calls if c[2]]
    other = [c for c in timed_calls if not c[2]]

    # the fused step alone on the same scans, batched the same way
    pipe = OdometryPipeline(cfg, with_tsdf=True)
    pfeed = _feeder(pipe, sim)
    _batches(pipe, scans, pfeed, 0, untimed)
    torch.cuda.synchronize()
    f0, fs0 = time.perf_counter(), pipe.host_syncs
    _batches(pipe, scans, pfeed, untimed, len(scans))
    torch.cuda.synchronize()
    fused_wall = time.perf_counter() - f0
    fused_syncs = (pipe.host_syncs - fs0) / n_timed
    del pipe

    mean = lambda xs, k: (float(np.mean([x[k] for x in xs]))  # noqa: E731
                          if xs else float("nan"))
    print(f"[9 system] SlamSystem(pipelined=True), bench.py:286-351 at full "
          f"width ({cfg.capacity.max_points} points, "
          f"{cfg.capacity.max_ds_points} kept, {cfg.tsdf.max_blocks} blocks), "
          f"{len(scans)} scans in batches of {SYSTEM_K}, maybe_close_loop "
          f"every third batch, the first {untimed} untimed (sim "
          f"{sim_s:.1f} s, warmup {warm_s:.2f} s): {n_timed / wall:.2f} scans/s wall "
          f"({n_timed} scans in {wall:.2f} s; CUDA events "
          f"{start.elapsed_time(end):.1f} ms); the fused step alone "
          f"(OdometryPipeline, same scans and batches) "
          f"{n_timed / fused_wall:.2f} scans/s, host syncs/scan "
          f"{fused_syncs:.2f}; closures {slam.loop_closures} (descriptor "
          f"{slam.loop_closures_descriptor}), raced attempts "
          f"{slam.loop_raced}, budget rejects {slam.loop_rejected_budget}, "
          f"skipped small {slam.loop_skipped_small}, sync_lost_keyframes "
          f"{slam.sync_lost_keyframes}; keyframes {total}, archive "
          f"{len(slam.archive)} entries, graph {int(slam.graph.n_nodes)} "
          f"nodes / {int(slam.graph.n_edges)} edges; ATE {ate:.4f} m; "
          f"peak memory {peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB "
          f"before); host syncs/scan {syncs / n_timed:.2f} (the step's "
          f"{step_syncs / n_timed:.2f}); maybe_close_loop calls in the "
          f"window: {len(closing)} closing, {mean(closing, 0):.1f} host "
          f"syncs and {mean(closing, 1):.3f} s each, {len(other)} not, "
          f"{mean(other, 0):.1f} syncs and {mean(other, 1):.3f} s each; "
          f"launches {launches} (A inside verify_loop {probes.verify_a}, B "
          f"inside archive fusions {probes.archive_b}); closures: "
          f"{_closure_line(slam.closure_log)}", flush=True)
    for row in slam.stages.table().splitlines():
        print(f"[9 system]   {row}", flush=True)
    window = ", ".join(f"{k} {v['calls']} calls {v['total_s']:.3f} s"
                       for k, v in sorted(stages.items(),
                                          key=lambda kv: -kv[1]["total_s"]))
    print(f"[9 system]   timed window only: {window}", flush=True)
    return launches


def _drift_loop_run(probes: _Probes, from_rest: bool) -> dict:
    """One run of the drifting loop through ``SlamSystem`` on the card,
    every keyframe synced, then one maybe_close_loop; from rest, the drift
    of ``synthetic.linear_drift`` is added before it. The surface's median
    error against the world as run, before and after the closing call."""
    import torch
    from scipy.spatial import cKDTree

    from noetic_slam_tpu_torch import SlamSystem
    from noetic_slam_tpu_torch.utils import synthetic

    sim = synthetic.drift_loop_sim(from_rest)
    scans = [sim.scan(i) for i in range(len(sim.scan_stamps))]
    slam = SlamSystem(synthetic.drift_loop_cfg(), loop_radius=5.0,
                      loop_min_gap=15)
    feed = _feeder(slam, sim)
    tree = cKDTree(sim.world)
    median = lambda: float(np.median(                       # noqa: E731
        tree.query(slam.surface_points(2.0))[0]))
    # the starved registration alone draws a different drift on every
    # machine (1 mm on one point of one scan sends it elsewhere), often too
    # small for a closure to cut the map's error (PERF.md §6): from rest
    # the run gets a known drift on top
    out = {"scans": len(scans)}
    with probes:
        t0 = time.perf_counter()
        for h, xyz, pt in scans:
            feed(h + pt.max() + 0.02)
            slam.process_scan(h, xyz, pt)
        slam.sync_graph()
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        out["med_run"] = median()
        traj = slam.flush()
        _check(bool(np.isfinite(traj).all()), "closure: non-finite pose")
        out["ate"] = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4],
                                        sim.gt_stamps, sim.gt_pos)
        out["drift"] = 0.0
        if from_rest:
            n = slam._synced_total
            q = slam.graph.node_q[:n].cpu().numpy()
            p = slam.graph.node_p[:n].cpu().numpy()
            q2, p2 = synthetic.linear_drift(q, p, synthetic.DRIFT_LOOP_YAW,
                                            synthetic.DRIFT_LOOP_SHIFT)
            slam.set_keyframe_poses(q2, p2)
            out["drift"] = float(np.linalg.norm(p2[-1] - p[-1]))
        out["med0"] = median()
        s0 = slam.host_syncs
        out["closed"] = slam.maybe_close_loop()
        out["syncs"] = slam.host_syncs - s0
    out["med1"] = median()
    _check(slam.sync_lost_keyframes == 0,
           f"closure: {slam.sync_lost_keyframes} keyframes lost")
    out["keyframes"] = slam._synced_total
    out["log"] = _closure_line(slam.closure_log)
    return out


def phase_closure(probes: _Probes):
    """Phase 10: the drifting loop of tests/test_slam_system.py (a 100 m
    circle at 5 Hz, starved registration, IMU noise) through ``SlamSystem``
    on the card, the counters set to 0 just before and read just after.
    First as the test has it: the closure's outcome and the error change
    are printed, as the drift this card draws allows (PERF.md §6).
    Then started from rest, the drift of ``synthetic.linear_drift`` added
    once every keyframe is synced: one maybe_close_loop must close the
    loop and cut the surface's median error against the world by at least
    25%."""
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    test = _drift_loop_run(probes, from_rest=False)
    rest = _drift_loop_run(probes, from_rest=True)
    launches = {name: fn.launches for name, fn in counters.items()}
    _check(probes.plain_calls == 0,
           f"closure: {probes.plain_calls} calls reached a plain version")
    _check(rest["closed"], "closure: the drifting loop did not close")
    _check(rest["med1"] < 0.75 * rest["med0"],
           f"closure: surface median error {rest['med0']:.3f} -> "
           f"{rest['med1']:.3f} m, not down 25%")

    def change(r):
        return (f"surface median error {r['med0']:.3f} -> {r['med1']:.3f} m "
                f"({100 * (r['med1'] / r['med0'] - 1):+.0f}%)")

    print(f"[10 closure] drifting loop (tests/test_slam_system.py:139-191) "
          f"as the test has it: {test['scans']} scans in {test['run_s']:.1f}"
          f" s, ATE {test['ate']:.4f} m, {test['keyframes']} keyframes; "
          f"closed {test['closed']}, {change(test)}; the call "
          f"{test['syncs']} host syncs; {test['log']}", flush=True)
    print(f"[10 closure] from rest: {rest['scans']} scans in "
          f"{rest['run_s']:.1f} s, ATE {rest['ate']:.4f} m and surface median "
          f"error {rest['med_run']:.3f} m as run; drift added "
          f"{rest['drift']:.3f} m at the last of {rest['keyframes']} "
          f"keyframes; closed {rest['closed']}, "
          f"{change(rest)}; the closing call {rest['syncs']} host syncs; "
          f"{rest['log']}; launches (both runs) {launches}", flush=True)
    return launches


def phase_system_kernels(probes: _Probes) -> dict:
    """Phase 11: kernels A and B against their plain versions on operands
    kept from the system path: the first correspondence search inside a
    ``verify_loop`` (two keyframe clouds with sentinel rows, the cap at
    twice the correspondence distance) and an archive fusion's chunk
    stream (NO_CLAMP, signs +-1), with B's exact +1/-1 cancellation; each
    timed hot and cold beside its library call and its plain version."""
    import torch

    from noetic_slam_tpu_torch.models.tsdf import BlockRuns
    from noetic_slam_tpu_torch.ops.cuda import nn_kernel as nk
    from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import (
        block_accumulate,
        block_accumulate_plain,
    )

    _check(probes.nn is not None, "system kernels: no verify_loop search kept")
    _check(probes.fuse is not None, "system kernels: no archive fusion kept")
    q, tgt, count, cap = probes.nn
    live = (torch.abs(q) < 1e5).all(dim=-1)
    fk, ties, err_a, d_plain = nn_check("verify_loop", nk.nn1_fused, q, tgt,
                                        count, float(cap),
                                        live.cpu().numpy())
    ta = _turns(lambda: nk.nn1_fused(q, tgt, count, cap),
                nn_library(q, tgt, tgt.shape[0]), iters=20, n_cold=10)
    plain_a = _time_ms(lambda: nk.nn1_plain(q, tgt, count, cap), 3)
    pairs = nk.needed_pairs(q, tgt, count, cap, d_plain, t_tile=BOUND_TILE)
    bound_a, by_a = _bound(q.shape[0] * 20 + tgt.shape[0] * 12, 8.0 * pairs)

    (W, WS), args, signed = probes.fuse
    rows, starts, cnts, ivox, w, wd, max_weight = args
    r = BlockRuns(rows, starts, cnts, None)
    stream = (rows, starts, cnts, ivox, w, wd)
    hit = _hit_mask(r, ivox, W.numel())
    _, err_b = _check_accum("system archive", block_accumulate,
                            block_accumulate_plain, (W, WS), stream,
                            (max_weight,), hit, TOL)
    _check_cancel("system archive", block_accumulate, W, stream,
                  (max_weight,))
    work = [W.clone(), WS.clone()]
    flat, spos = _stream_addresses(r, ivox)
    vals = torch.stack([w[spos], wd[spos]], dim=1)
    lib_pay = torch.zeros((W.numel(), 2), device=W.device)
    tb = _turns(lambda: block_accumulate(*work, *stream, max_weight),
                lambda: lib_pay.index_add_(0, flat, vals))
    plain_b = _time_ms(lambda: block_accumulate_plain(*work, *stream,
                                                      max_weight), 5)
    n_samples, n_vox = _voxel_counts(r, ivox)
    bound_b, by_b = _bound(12 * rows.shape[0] + 12 * n_samples + 16 * n_vox,
                           2 * n_samples + 5 * n_vox)
    print(f"[11 system kernels] A on the first verify_loop search: "
          f"{q.shape[0]} queries ({int(live.sum())} live) x {tgt.shape[0]} "
          f"rows, cap {float(cap):.3f} m: found {int(fk.sum())}, idx ties "
          f"{ties}, "
          f"max |dsqd| {err_a:.3e}, sentinel queries find nothing; kernel "
          f"{ta['ms']:.4f} ms hot / {ta['ms_cold']:.4f} cold, cdist+amin "
          f"{ta['library_ms']:.3f} / {ta['library_ms_cold']:.3f}, plain "
          f"{plain_a:.3f} ms, bound {bound_a:.5f} ms ({by_a}; {pairs} "
          f"pairs). B on an archive chunk ({'with' if signed else 'without'}"
          f" sign -1 entries): {_accum_line_short(r, ivox)}, max |d| "
          f"{err_b:.3e}, two runs bitwise equal, +1/-1 exact, unhit voxels "
          f"unchanged; kernel {tb['ms']:.4f} ms hot / {tb['ms_cold']:.4f} "
          f"cold, index_add_ {tb['library_ms']:.4f} / "
          f"{tb['library_ms_cold']:.4f}, plain {plain_b:.3f} ms, bound "
          f"{bound_b:.5f} ms ({by_b})", flush=True)
    return {
        "nn1_fused": {"system_max_abs_err": err_a, "system_ms": ta["ms"],
                      "system_ms_cold": ta["ms_cold"],
                      "system_library_ms": ta["library_ms"],
                      "system_library_ms_cold": ta["library_ms_cold"],
                      "system_plain_ms": plain_a, "system_bound_ms": bound_a,
                      "system_bound_by": by_a},
        "block_accumulate": {"system_max_abs_err": err_b,
                             "system_ms": tb["ms"],
                             "system_ms_cold": tb["ms_cold"],
                             "system_library_ms": tb["library_ms"],
                             "system_library_ms_cold": tb["library_ms_cold"],
                             "system_plain_ms": plain_b,
                             "system_bound_ms": bound_b,
                             "system_bound_by": by_b}}


def _accum_line_short(r, ivox) -> str:
    n_samples, n_vox = _voxel_counts(r, ivox)
    n_blocks, largest, chain, _ = _entry_shape(r)
    return (f"{ivox.shape[0]} samples ({n_samples} in {n_blocks} real "
            f"entries, {n_vox} voxels), largest {largest}, longest chain "
            f"{chain} tiles")


# ---------------------------------------------------------------------------
# The command line: ``noetic_slam_tpu_torch.cli`` on recorded inputs
# (phase 12)
# ---------------------------------------------------------------------------

CLI_PCAP_ATE = 0.15      # m: tests/test_pcap_e2e.py:58's bound
CLI_BAG_ATE = 0.05       # m: the synthetic sequence's (PERF.md section 2)
CLI_MULRAN_ATE = 0.5     # m: tests/test_mulran_e2e.py:104's bound
CLI_MULRAN_SCANS = 40    # MulRan scans written (0.5 s before the hold ends
                         # and 3.5 s of motion, at 10 Hz)


class _Instances:
    """Records every instance of ``mod.<name>`` (default: ``SlamSystem``)
    that the command line builds (the module's class swapped for a
    subclass while it is entered)."""

    def __init__(self, mod=None, name: str = "SlamSystem"):
        if mod is None:
            from noetic_slam_tpu_torch.runtime import slam as mod

        self.mod, self.name, self.made = mod, name, []
        made = self.made

        class Recorded(getattr(mod, name)):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        self.cls = Recorded

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.cls)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


class _ThreadErrors:
    """Counts the exceptions that escape any thread while entered."""

    def __enter__(self):
        import threading

        self.n, self.orig = 0, threading.excepthook

        def hook(args):
            self.n += 1
            self.orig(args)

        threading.excepthook = hook
        return self

    def __exit__(self, *exc):
        import threading

        threading.excepthook = self.orig


def _cli_run(tag: str, argv: list, out: str, files: tuple,
             need: tuple, prefix: str = "[12 cli]",
             traj_file: str | None = "trajectory.tum",
             instances: _Instances | None = None) -> dict:
    """``cli.main(argv + ["--out", out])`` in this process, its stdout
    shown prefixed, the launch counters set to 0 just before and read just
    after, every plain-version call counted (there must be none). Checks
    the exit code, that it built one system (``instances``, default the
    ``SlamSystem``s) on the card, with 0 lost keyframes for a
    ``SlamSystem``, that no thread died of an exception, that every
    kernel in ``need`` launched, and that each of ``files`` exists and is
    not empty."""
    import contextlib
    import io
    import os

    import torch

    from noetic_slam_tpu_torch import cli

    counters = _counters()
    buf = io.StringIO()
    probes = _Probes()
    inst = instances or _Instances()
    gc.collect()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with inst, probes, _ThreadErrors() as errs, \
            contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    stdout = buf.getvalue()
    for line in stdout.splitlines():
        print(f"{prefix} {tag} | {line}", flush=True)
    _check(rc == 0, f"cli {tag}: exit {rc}")
    _check(errs.n == 0, f"cli {tag}: {errs.n} thread exceptions")
    _check(len(inst.made) == 1, f"cli {tag}: {len(inst.made)} systems")
    made = inst.made[0]
    on_card = (made.device if hasattr(made, "device")
               else made.seq_device[0]).type == "cuda"
    _check(on_card, f"cli {tag}: not on the card")
    lost = getattr(made, "sync_lost_keyframes", 0)
    _check(lost == 0, f"cli {tag}: {lost} keyframes lost")
    _check(probes.plain_calls == 0,
           f"cli {tag}: {probes.plain_calls} calls reached a plain version")
    for name in need:
        _check(launches[name] > 0, f"cli {tag}: {name} never launched")
    sizes = {}
    for name in files:
        path = os.path.join(out, name)
        _check(os.path.isfile(path) and os.path.getsize(path) > 0,
               f"cli {tag}: {name} missing or empty")
        sizes[name] = os.path.getsize(path)
    traj = None
    if traj_file is not None:
        traj = np.loadtxt(os.path.join(out, traj_file), ndmin=2)
        _check(bool(np.isfinite(traj).all()), f"cli {tag}: non-finite pose")
    return {"traj": traj, "wall": wall, "launches": launches,
            "closures": getattr(made, "loop_closures", 0), "lost": lost,
            "stdout": stdout, "sizes": sizes, "host_syncs": made.host_syncs,
            "made": made}


def _cli_line(tag: str, what: str, r: dict, ate: float, extra: str = ""):
    n = len(r["traj"])
    files = ", ".join(f"{k} {v}" for k, v in r["sizes"].items())
    print(f"[12 cli] {tag}: {what}; {n} scans in {r['wall']:.2f} s wall "
          f"(the whole command: setup, ingest, closures, map products, "
          f"files) = {n / r['wall']:.2f} scans/s; ATE {ate:.4f} m; closures "
          f"{r['closures']}; sync_lost_keyframes {r['lost']}; host syncs "
          f"{r['host_syncs']} ({r['host_syncs'] / max(n, 1):.2f}/scan); "
          f"launches {r['launches']}{extra}; files (bytes): {files}",
          flush=True)


def _esdf_observed(path: str) -> int:
    d = np.load(path)
    _check(bool(np.isfinite(d["esdf"]).all()), f"{path}: non-finite ESDF")
    n = int(d["observed"].sum())
    _check(n > 0, f"{path}: no observed voxel")
    return n


def phase_cli(sim, scans, root: str) -> dict:
    """Phase 12: ``noetic_slam_tpu_torch.cli.main`` in this process at the
    command line's default configuration (production capacities), on
    inputs written here from seeds: (a) ``slam --pcap`` on an OS1-64
    capture in 512x10 mode (64 x 512, 32,768 points a frame) with TSDF,
    loop closure, mesh, ESDF, checkpoint and renders; (b) ``slam --bag`` on
    a bz2 bag of phase 6's 32,768-point sequence (``sim`` and the
    ``scans`` drawn from it) with TSDF; (c) ``export``
    of a 40-scan, 32,768-point MulRan directory to a bag, read back, then
    ``slam --mulran --map-backend occupancy --esdf``. The inputs stay in
    ``root`` for phases 13 and 14. Returns the launches of each kernel per
    run, and the capture's paths."""
    import contextlib
    import io
    import os

    from noetic_slam_tpu_torch import cli
    from noetic_slam_tpu_torch.io import rosbag
    from noetic_slam_tpu_torch.io.mulran import MulranDataset
    from noetic_slam_tpu_torch.utils import fixtures, synthetic
    from noetic_slam_tpu_torch.utils.geometry import quat_to_mat_np

    A, B, C = "nn1_fused", "block_accumulate", "logodds_accumulate"
    t_phase = time.perf_counter()
    out = {}
    # (a) an Ouster capture through the packet path
    cap = os.path.join(root, "capture")
    t0 = time.perf_counter()
    meta = fixtures.write_pcap_fixture(cap, h=64, w=512)
    gen_s = time.perf_counter() - t0
    o = os.path.join(root, "out_pcap")
    r = _cli_run("pcap", ["slam", "--pcap", meta["pcap"], "--metadata",
                          meta["metadata"], "--mesh", "--esdf",
                          "--checkpoint", "--viz"], o,
                 ("trajectory.tum", "dlio_map.pcd", "tsdf_surface.ply",
                  "tsdf_mesh.ply", "esdf.npz", "esdf_slice.png",
                  "state.nst.npz", "trajectory.png", "map_views.png",
                  "map_viewer.html"), (A, B))
    gt = np.loadtxt(meta["gt"])
    ate = synthetic.ate_rmse(r["traj"][:, 0] - fixtures.PCAP_BASE_NS
                             * 1e-9, r["traj"][:, 1:4], gt[:, 0],
                             gt[:, 1:4])
    _check(ate < CLI_PCAP_ATE, f"cli pcap: ATE {ate:.4f} m")
    _check(len(r["traj"]) >= 35, f"cli pcap: {len(r['traj'])} scans")
    _cli_line("pcap", f"64 x 512 capture ({meta['n_frames']} frames, "
              f"{meta['n_packets']} packets, {meta['bytes']} bytes, "
              f"written in {gen_s:.2f} s)", r, ate,
              f"; ESDF {_esdf_observed(os.path.join(o, 'esdf.npz'))} "
              f"observed voxels")
    out["pcap"] = r["launches"]
    capture = meta

    # (b) a bz2 bag of phase 6's synthetic 32,768-point sequence
    t0 = time.perf_counter()
    bag = fixtures.write_sim_bag(os.path.join(root, "sim.bag"), sim,
                                 compression="bz2", scans=scans)
    gen_s = time.perf_counter() - t0
    o = os.path.join(root, "out_bag")
    r = _cli_run("bag", ["slam", "--bag", bag["bag"]], o,
                 ("trajectory.tum", "dlio_map.pcd", "tsdf_surface.ply"),
                 (A, B))
    ate = synthetic.ate_rmse(r["traj"][:, 0] - fixtures.BAG_EPOCH,
                             r["traj"][:, 1:4], sim.gt_stamps,
                             sim.gt_pos)
    _check(ate < CLI_BAG_ATE, f"cli bag: ATE {ate:.4f} m")
    _check(len(r["traj"]) == bag["n_scans"],
           f"cli bag: {len(r['traj'])} of {bag['n_scans']} scans")
    _cli_line("bag", f"bz2 bag of {bag['n_scans']} scans x 32768 points "
              f"and {bag['n_imu']} IMU samples ({bag['bytes']} bytes, "
              f"written in {gen_s:.2f} s)", r, ate)
    out["bag"] = r["launches"]

    # (c) a MulRan directory: export to a bag and read it back, then
    # the occupancy map
    d = os.path.join(root, "mulran")
    t0 = time.perf_counter()
    fx = fixtures.write_mulran_fixture(d, duration=3.5,
                                       n_points=32768, seed=42)
    gen_s = time.perf_counter() - t0
    _check(fx["n_scans"] == CLI_MULRAN_SCANS,
           f"cli mulran: {fx['n_scans']} scans written")
    ebag = os.path.join(root, "export.bag")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["export", "--mulran", d, "--bag", ebag,
                       "--compression", "bz2"])
    _check(rc == 0, f"cli export: exit {rc}")
    stats = json.loads(buf.getvalue())
    ds = MulranDataset.load(d)
    gts = [rosbag.parse_odometry(m) for _, _, _, m in
           rosbag.BagReader(ebag).messages(["/gt"])]
    n_radar = sum(1 for _ in rosbag.BagReader(ebag).messages(
        ["/radar/polar"]))
    _check(stats == {"gt": len(ds.gt_stamps), "radar": n_radar}
           and len(gts) == len(ds.gt_stamps) and n_radar > 0,
           f"cli export: {stats}, {len(gts)} poses and {n_radar} "
           f"images read back")
    p_err = max(float(np.abs(g["p"] - pose[:, 3]).max())
                for g, pose in zip(gts, ds.gt_poses))
    r_err = max(float(np.abs(quat_to_mat_np(g["q"]) - pose[:, :3]).max())
                for g, pose in zip(gts, ds.gt_poses))
    _check(p_err == 0.0 and r_err < 1e-5,
           f"cli export: read back |dp| {p_err}, |dR| {r_err}")
    export_s = time.perf_counter() - t0
    o = os.path.join(root, "out_mulran")
    r = _cli_run("mulran", ["slam", "--mulran", d, "--map-backend",
                            "occupancy", "--esdf"], o,
                 ("trajectory.tum", "dlio_map.pcd", "occupied.ply",
                  "esdf.npz", "esdf_slice.png"), (A, C))
    _check(r["launches"][B] == 0, "cli mulran: kernel B launched on "
           "the occupancy map")
    line = [ln for ln in r["stdout"].splitlines()
            if ln.startswith("ATE RMSE vs ground truth:")]
    _check(len(line) == 1, "cli mulran: no ATE line")
    ate = float(line[0].split(":")[1].split("m")[0])
    _check(ate < CLI_MULRAN_ATE, f"cli mulran: ATE {ate:.4f} m")
    _cli_line("mulran", f"MulRan directory, {fx['n_scans']} scans x "
              f"32768 points (written in {gen_s:.2f} s; export to a bz2 "
              f"bag and read back in {export_s:.2f} s: {stats}, poses "
              f"exact, rotations within {r_err:.1e}), occupancy map", r,
              ate, f"; ESDF "
              f"{_esdf_observed(os.path.join(o, 'esdf.npz'))} observed "
              f"voxels")
    out["mulran_occupancy"] = r["launches"]
    print(f"[12 cli] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out, capture


# ---------------------------------------------------------------------------
# The live path and the player (phase 13), the multi-sequence runtime
# (phase 14)
# ---------------------------------------------------------------------------

LIVE_PORTS = (47502, 47503)   # loopback: lidar, IMU (phase 13's stream)
LIVE_ATE = 0.15          # m: tests/test_pcap_e2e.py:58's bound
LIVE_DRAIN_S = 1.0       # s the receiver polls on after the last packet
                         # (ten empty 100 ms polls; the driver raises at 60)
BATCH_LADDER = (1, 2, 4, 8)
BATCH_SECONDS = 2.0      # s of scans per sequence (scripts/bench_batch.py
                         # simulates 12 s: 120 scans)
BATCH_ATE = 0.08         # m: tests/test_multi_pipeline.py:82's bound


def _send_paced(pkts, speed: float, ports, log: dict) -> None:
    """The sensor: each packet to its loopback port at its capture stamp
    over ``speed`` after the first; the send time of the last and the
    most any packet went out behind its schedule in ``log``."""
    import socket

    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t_first = pkts[0][0]
    late = 0.0
    t0 = time.monotonic()
    for ts, port, payload in pkts:
        due = t0 + (ts - t_first) / speed
        lag = due - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        else:
            late = max(late, -lag)
        tx.sendto(payload, ("127.0.0.1",
                            ports[0] if port == 7502 else ports[1]))
    log["last_sent"] = time.monotonic()
    log["max_late_s"] = late
    tx.close()


def _live_run(tag: str, meta: dict, speed: float,
              jax_rule: bool = False) -> dict:
    """The composition ``cli live`` builds (``SlamSystem(cfg,
    pipelined=True)`` with TSDF, default config, fed by ``LiveDriver`` in
    sensor-stamp mode) receiving the capture from a sender thread paced at
    ``speed`` x its capture stamps; the launch counters set to 0 just
    before and read just after, plain-version calls counted. With
    ``jax_rule`` the driver drops a frame the IMU does not cover yet, as
    the JAX driver does, instead of holding it."""
    import threading

    import torch

    from noetic_slam_tpu_torch import SlamSystem
    from noetic_slam_tpu_torch.config.params import load_config
    from noetic_slam_tpu_torch.io import ouster as ou
    from noetic_slam_tpu_torch.io.pcap import read_pcap
    from noetic_slam_tpu_torch.runtime.live import LiveDriver
    from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu
    from noetic_slam_tpu_torch.utils import fixtures, synthetic

    with open(meta["metadata"]) as f:
        info = ou.SensorInfo.from_json(f.read())
    pkts = list(read_pcap(meta["pcap"]))
    n_lidar = sum(1 for _, port, _ in pkts if port == 7502)
    slam = SlamSystem(load_config(None), pipelined=True)
    _check(slam.device.type == "cuda", f"live {tag}: not on the card")
    calls, done_at = [], []
    inner = slam.process_scan

    def process_scan(*a):
        calls.append(a[0])
        out = inner(*a)
        done_at.append(time.monotonic())
        return out

    slam.process_scan = process_scan

    class DropRule(LiveDriver):
        def _submit(self, header, xyz, rel_t):
            try:
                self.slam.process_scan(header, xyz, rel_t)
                self.n_scans += 1
            except NeedMoreImu:
                self.n_refused += 1

    drv = (DropRule if jax_rule else LiveDriver)(
        slam, info, lidar_port=LIVE_PORTS[0], imu_port=LIVE_PORTS[1],
        timestamp_mode="sensor")
    counters = _counters()
    probes = _Probes()
    log: dict = {}
    sender = threading.Thread(target=_send_paced,
                              args=(pkts, speed, LIVE_PORTS, log))
    gc.collect()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    s0 = slam.host_syncs
    try:
        with probes, _ThreadErrors() as errs:
            t0 = time.monotonic()
            sender.start()
            while sender.is_alive() or (
                    time.monotonic() - log["last_sent"] < LIVE_DRAIN_S):
                drv.poll_once()
            sender.join()
            torch.cuda.synchronize()
        dropped = drv.source.lidar_dropped
    finally:
        drv.close()
    launches = {name: fn.launches for name, fn in counters.items()}
    _check(errs.n == 0, f"live {tag}: {errs.n} thread exceptions")
    _check(probes.plain_calls == 0,
           f"live {tag}: {probes.plain_calls} calls reached a plain version")
    traj = slam.flush()
    n = drv.n_scans
    _check(len(traj) == n, f"live {tag}: {len(traj)} poses, {n} scans")
    _check(bool(np.isfinite(traj).all()), f"live {tag}: non-finite pose")
    gt = np.loadtxt(meta["gt"])
    ate = (synthetic.ate_rmse(traj[:, 0] - fixtures.PCAP_BASE_NS * 1e-9,
                              traj[:, 1:4], gt[:, 0], gt[:, 1:4])
           if n > 1 else float("nan"))
    return {"frames": meta["n_frames"], "packets": n_lidar, "calls":
            len(calls), "scans": n, "ring_dropped": dropped,
            "rate": (n - 1) / max(done_at[-1] - done_at[0], 1e-9) if n > 1
            else 0.0,
            "lag_s": done_at[-1] - log["last_sent"] if n else float("nan"),
            "send_s": log["last_sent"] - t0, "max_late_s": log["max_late_s"],
            "ate": ate, "syncs": (slam.host_syncs - s0) / max(n, 1),
            "launches": launches, "imu": drv.n_imu, "held": drv.n_held,
            "refused": drv.n_refused}


def _live_line(tag: str, speed: float, r: dict) -> None:
    print(f"[13 live] {tag}: capture sent at {speed:g}x its stamps "
          f"({10 * speed:g} Hz frames) in {r['send_s']:.2f} s (a packet at "
          f"most {r['max_late_s'] * 1e3:.1f} ms behind schedule): "
          f"{r['frames']} frames sent, {r['scans']} scans processed, "
          f"{r['refused']} frames dropped (calibration hold, or replaced "
          f"while held), {r['held']} held for their IMU and run after the "
          f"next IMU drain ({r['calls']} calls into the system; the last "
          f"frame never completes); "
          f"source.lidar_dropped {r['ring_dropped']} packets of "
          f"{r['packets']}; processed rate {r['rate']:.2f} scans/s; lag last "
          f"packet sent -> last scan done {r['lag_s']:.3f} s; ATE "
          f"{r['ate']:.4f} m; host syncs/scan "
          f"{r['syncs']:.2f}; {r['imu']} IMU packets; launches "
          f"{r['launches']}", flush=True)


def phase_live(root: str, meta: dict) -> dict:
    """Phase 13: (a) the capture of phase 12(a) streamed over loopback at
    its sensor's pace (10 Hz) into ``LiveDriver`` + ``SlamSystem``; (b)
    the same stream at twice the pace (its rate and drops are the
    finding); (c) ``cli player --rate 1`` over phase 12(c)'s MulRan
    directory. Returns the launches of each kernel per run."""
    import os

    from noetic_slam_tpu_torch.io.mulran import MulranDataset
    from noetic_slam_tpu_torch.utils import synthetic

    A, B = "nn1_fused", "block_accumulate"
    t_phase = time.perf_counter()
    out = {}
    r = _live_run("(a0) 10 Hz, JAX rule", meta, 1.0, jax_rule=True)
    _live_line("(a0) sensor pace, the JAX driver's rule (a frame the IMU "
               "does not cover yet is dropped)", 1.0, r)
    out["sensor_10hz_jax_rule"] = r["launches"]
    r = _live_run("(a) 10 Hz", meta, 1.0)
    _live_line("(a) sensor pace", 1.0, r)
    _check(r["ate"] < LIVE_ATE, f"live (a): ATE {r['ate']:.4f} m")
    _check(r["launches"][A] > 0 and r["launches"][B] > 0,
           f"live (a): launches {r['launches']}")
    out["sensor_10hz"] = r["launches"]
    r = _live_run("(b) 20 Hz", meta, 2.0)
    _live_line("(b) twice the pace", 2.0, r)
    out["sensor_20hz"] = r["launches"]

    d = os.path.join(root, "mulran")
    o = os.path.join(root, "out_player")
    r = _cli_run("player", ["player", "--mulran", d, "--rate", "1"], o,
                 ("trajectory.tum",), (A, B), prefix="[13 live]")
    stats = json.loads(r["stdout"].splitlines()[0])
    ds = MulranDataset.load(d)
    traj = r["traj"]
    ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], ds.gt_stamps,
                             ds.gt_poses[:, :, 3])
    _check(ate < CLI_MULRAN_ATE, f"cli player: ATE {ate:.4f} m")
    span = float(ds.imu_stamps[-1] - ds.imu_stamps[0])
    print(f"[13 live] (c) cli player --rate 1: {stats['n_events']} events "
          f"over {span:.2f} s of data in {r['wall']:.2f} s wall (the player "
          f"{stats['wall_time']:.2f} s); {len(traj)} poses, ATE {ate:.4f} m; "
          f"host syncs {r['host_syncs']} "
          f"({r['host_syncs'] / max(len(traj), 1):.2f}/scan); no thread "
          f"exception; launches {r['launches']}", flush=True)
    out["player"] = r["launches"]
    print(f"[13 live] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def _batch_cfg():
    """scripts/bench_batch.py:57-67's full-width configuration."""
    from noetic_slam_tpu_torch.config import (
        CapacityConfig,
        DlioConfig,
        KeyframeConfig,
        TsdfConfig,
    )

    return DlioConfig(
        capacity=CapacityConfig(
            max_points=8192, max_ds_points=4096, max_deskew_frames=1024,
            max_imu_window=128, max_keyframes=64, max_submap_kf=16,
            max_trajectory=4096),
        adaptive=False, keyframe=KeyframeConfig(thresh_dist=0.5,
                                                thresh_rot=45.0),
        tsdf=TsdfConfig(voxel_size=0.2, truncation=0.6, max_blocks=8192,
                        space_carving=False, scan_block_cap=2048))


def phase_batch(root: str) -> dict:
    """Phase 14: the B = 1/2/4/8 ladder of scripts/bench_batch.py on the
    card at its full width, one ``make_sim(seed=77)`` shared by every
    sequence, the sequence length cut; then ``cli batch --synthetic 2
    --duration 4 --mulran <phase 12(c)'s directory> --max-scans 25
    --checkpoint`` and a ``--resume`` from its checkpoint that runs the
    feeds on to their end.
    Returns the launches of each kernel per run."""
    import os

    import torch

    from noetic_slam_tpu_torch.runtime import multi
    from noetic_slam_tpu_torch.runtime.multi import (
        ArrayFeed,
        MultiSequencePipeline,
        run_lockstep,
    )
    from noetic_slam_tpu_torch.utils import synthetic

    A = "nn1_fused"
    t_phase = time.perf_counter()
    cfg = _batch_cfg()
    t0 = time.perf_counter()
    sim = synthetic.make_sim(duration=BATCH_SECONDS, calib_time=3.1,
                             n_points=cfg.capacity.max_points, seed=77)
    scans = [sim.scan(i) for i in range(len(sim.scan_stamps))]
    print(f"[14 batch] scripts/bench_batch.py's configuration at full width "
          f"({cfg.capacity.max_points} points, {cfg.capacity.max_ds_points} "
          f"kept, {cfg.capacity.max_deskew_frames} deskew frames, "
          f"{cfg.capacity.max_imu_window}-sample IMU window, "
          f"{cfg.capacity.max_keyframes} keyframes, "
          f"{cfg.capacity.max_submap_kf} submap keyframes); the sequence "
          f"cut from 12 s to {BATCH_SECONDS:g} s ({len(scans)} scans after "
          f"the 3.1 s hold, made in {time.perf_counter() - t0:.1f} s), one "
          f"sim shared by every sequence", flush=True)
    counters = _counters()
    out = {}
    rows = []
    for B in BATCH_LADDER:
        probes = _Probes()
        feeds = [ArrayFeed(sim.imu_stamps, sim.imu_ang, sim.imu_acc,
                           sim.scan_stamps, lambda i: scans[i])
                 for _ in range(B)]
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for fn in counters.values():
            fn.launches = 0
        with probes:
            mp = MultiSequencePipeline(cfg, n_seq=B)
            t0 = time.perf_counter()
            trajs = run_lockstep(mp, feeds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        _check(all(d.type == "cuda" for d in mp.seq_device),
               f"batch B={B}: not on the card")
        _check(probes.plain_calls == 0, f"batch B={B}: "
               f"{probes.plain_calls} calls reached a plain version")
        _check(launches[A] > 0 and launches["block_accumulate"] == 0
               and launches["logodds_accumulate"] == 0,
               f"batch B={B}: launches {launches}")
        total = sum(len(t) for t in trajs)
        ates = [synthetic.ate_rmse(t[:, 0], t[:, 1:4], sim.gt_stamps,
                                   sim.gt_pos) for t in trajs]
        for i, a in enumerate(ates):
            _check(len(trajs[i]) > 0 and a < BATCH_ATE,
                   f"batch B={B}: sequence {i} ATE {a:.4f} m")
        equal = all(np.array_equal(t, trajs[0]) for t in trajs)
        spread = max(float(np.abs(t[:, 1:4] - trajs[0][:, 1:4]).max())
                     if t.shape == trajs[0].shape else float("inf")
                     for t in trajs)
        _check(equal, f"batch B={B}: the copies of one sequence are not "
               f"bitwise equal (largest |dp| {spread:.2e} m)")
        peak = torch.cuda.max_memory_allocated()
        rows.append((B, total / wall))
        print(f"[14 batch] B={B}: {total} scans in {wall:.2f} s = "
              f"{total / wall:.2f} scans/s total, {total / wall / B:.2f} per "
              f"sequence; {mp.rounds} rounds, host syncs/round "
              f"{mp.host_syncs / mp.rounds:.2f} "
              f"({mp.host_syncs / total:.2f}/scan); launches of A "
              f"{launches[A]} ({launches[A] / total:.2f}/scan); peak memory "
              f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB before); ATE "
              f"{', '.join(f'{a:.4f}' for a in ates)} m; trajectories "
              f"bitwise equal: {equal} (largest |dp| from sequence 0 "
              f"{spread:.2e} m)", flush=True)
        out[f"B{B}"] = launches
        del mp, trajs
    print(f"[14 batch] scaling (total scans/s over B=1's): "
          + ", ".join(f"B={b} {r / rows[0][1]:.2f}x" for b, r in rows),
          flush=True)

    d = os.path.join(root, "mulran")
    o = os.path.join(root, "out_batch")
    argv = ["batch", "--synthetic", "2", "--duration", "4", "--mulran", d]
    files = ("00_mulran.tum", "01_synthetic.tum", "02_synthetic.tum")
    r = _cli_run("batch", argv + ["--max-scans", "25", "--checkpoint"], o,
                 files + ("batch_state.nst.npz",), (A,), prefix="[14 batch]",
                 traj_file=None,
                 instances=_Instances(multi, "MultiSequencePipeline"))
    summary = json.loads(r["stdout"].splitlines()[-1])
    for e in summary["sequences"]:
        _check(e["n_poses"] > 0 and e.get("ate_rmse_m", 0.0) < CLI_MULRAN_ATE,
               f"cli batch: {e}")
    mp = r["made"]
    print(f"[14 batch] cli batch: {summary['total_poses']} poses of "
          f"{len(summary['sequences'])} sequences in {r['wall']:.2f} s wall "
          f"({summary['scans_per_sec']} scans/s over the run); host "
          f"syncs/round {r['host_syncs'] / max(mp.rounds, 1):.2f}; launches "
          f"{r['launches']}", flush=True)
    out["cli"] = r["launches"]
    ck = os.path.join(o, "batch_state.nst.npz")
    r = _cli_run("batch resume", argv + ["--resume", ck], o + "_resume",
                 (), (), prefix="[14 batch]", traj_file=None,
                 instances=_Instances(multi, "MultiSequencePipeline"))
    resumed = json.loads(r["stdout"].splitlines()[-1])
    _check(f"at round {summary['rounds']}" in r["stdout"]
           and resumed["rounds"] > summary["rounds"],
           f"cli batch resume: {resumed}")
    print(f"[14 batch] cli batch --resume: from round {summary['rounds']} "
          f"to {resumed['rounds']}, {resumed['total_poses']} more poses in "
          f"{r['wall']:.2f} s; launches {r['launches']}", flush=True)
    out["cli_resume"] = r["launches"]
    print(f"[14 batch] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# The grid NN engine (phase 15) and the sharded paths (phase 16)
# ---------------------------------------------------------------------------

GRID_ATE = 0.05          # m: every grid run, as the main path
SHARDED_SCANS = 12       # scans of phase 6's sequence through the sharded step
SHARDED_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
SHARDED_KEEP_ALIGN = 10  # kernel A is checked on this align's first search
SHARDED_STEP_TOL = 0.02  # m: a sharded step against the one-process step
                         # from the same state (ROADMAP's parity tolerance)
BA_TOL = 1e-3            # m: sharded against one-process pose-graph solves
RANK_TIMEOUT = 600.0     # s: a launch whose ranks are not done fails


def _grid_cfg(cov_engine: str, engine: str = "grid"):
    import dataclasses

    cfg = _main_cfg()
    return cfg.replace(gicp=dataclasses.replace(
        cfg.gicp, nn_engine=engine, cov_engine=cov_engine))


def _pose_gap(traj, ref) -> float:
    _check(traj.shape == ref.shape and np.array_equal(traj[:, 0], ref[:, 0]),
           f"trajectories of {len(traj)} and {len(ref)} poses differ in "
           f"their stamps")
    return float(np.linalg.norm(traj[:, 1:4] - ref[:, 1:4], axis=-1).max())


def phase_grid(sim, scans, n_scans: int, brute_traj, root: str) -> dict:
    """Phase 15: ``nn_engine="grid"`` at the main path's full width over
    phase 6's scans, (a) with ``cov_engine="radius"`` (beside phase 6's
    brute-engine run) and (b) with ``"knn"`` (grid covariances; beside a
    brute-engine ``"knn"`` run of the same scans); (c) ``cli slam
    --config <nn_engine: grid> --mulran <phase 12's directory>`` beside
    the same command on the default (brute) configuration. Kernel A must
    not launch on the grid's correspondences (it may in ``verify_loop``).
    Returns the launches of each kernel per run."""
    import os

    t_phase = time.perf_counter()
    A, B = "nn1_fused", "block_accumulate"
    out = {}
    for tag, cov in (("a", "radius"), ("b", "knn")):
        if cov == "radius":
            ref, ref_line = brute_traj[:n_scans], "phase 6's"
        else:
            _, ref, _, rst = _drive(f"grid ({tag}) brute reference",
                                    _grid_cfg(cov, "brute"), sim, scans,
                                    n_scans)
            ref_line = f"{rst['rate']:.2f} scans/s, ATE {rst['ate']:.4f} m"
        pipe, traj, launches, st = _drive(f"grid ({tag})", _grid_cfg(cov),
                                          sim, scans, n_scans)
        _check(launches[B] == n_scans, f"grid ({tag}): kernel B launched "
               f"{launches[B]} times for {n_scans} scans")
        gap = _pose_gap(traj, ref)
        print(f"[15 grid] ({tag}) nn_engine=grid, cov_engine={cov}, "
              f"{n_scans} scans x 32768 points, tsdf: {_path_line(st, pipe)}"
              f"; largest per-pose distance to the brute engine's run "
              f"({ref_line}) {gap:.4f} m; launches {launches}", flush=True)
        out[f"{cov}"] = launches
        del pipe

    d = os.path.join(root, "mulran")
    yaml = os.path.join(root, "grid.yaml")
    with open(yaml, "w") as f:
        f.write("gicp:\n  nn_engine: grid\n")
    runs = {}
    for tag, extra in (("brute", []), ("grid", ["--config", yaml])):
        r = _cli_run(f"slam {tag}", ["slam", "--mulran", d] + extra,
                     os.path.join(root, f"out_grid_{tag}"),
                     ("trajectory.tum", "dlio_map.pcd"), (B,),
                     prefix="[15 grid]")
        line = [ln for ln in r["stdout"].splitlines()
                if ln.startswith("ATE RMSE vs ground truth:")]
        _check(len(line) == 1, f"cli slam {tag}: no ATE line")
        r["ate"] = float(line[0].split(":")[1].split("m")[0])
        runs[tag] = r
    r = runs["grid"]
    _check(r["ate"] < GRID_ATE, f"grid (c): ATE {r['ate']:.4f} m")
    n = len(r["traj"])
    gap = _pose_gap(r["traj"], runs["brute"]["traj"])
    print(f"[15 grid] (c) cli slam --config (nn_engine: grid) --mulran: {n} "
          f"scans in {r['wall']:.2f} s wall = {n / r['wall']:.2f} scans/s "
          f"(brute {runs['brute']['wall']:.2f} s); ATE {r['ate']:.4f} m "
          f"(brute {runs['brute']['ate']:.4f}); largest per-pose distance "
          f"to the brute run {gap:.4f} m; closures {r['closures']}; host "
          f"syncs {r['host_syncs'] / max(n, 1):.2f}/scan; launches "
          f"{r['launches']} (brute {runs['brute']['launches']})",
          flush=True)
    out["cli"] = r["launches"]
    print(f"[15 grid] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def _ba_graph(pg, K: int, dev):
    """A K-node chain around a 12 m circle with noisy node estimates and
    one loop edge (0, K-1) measuring the true relative pose: K edges."""
    import torch

    th = np.linspace(0, 1.9 * np.pi, K).astype(np.float32)
    gt = np.stack([12 * np.cos(th), 12 * np.sin(th), 0 * th],
                  -1).astype(np.float32)
    est = gt + np.random.default_rng(9).normal(
        scale=0.08, size=gt.shape).astype(np.float32)
    qs = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (K, 1))
    g = pg.init_graph(K, K, device=dev)
    g = pg.add_nodes_chain(g, qs, est, K)
    t = lambda a: torch.as_tensor(a, device=dev)          # noqa: E731
    dq, dp = pg.relative_pose(t(qs[0]), t(gt[0]), t(qs[K - 1]), t(gt[K - 1]))
    return pg.add_edge(g, t(np.int32(0)), t(np.int32(K - 1)), dq, dp,
                       w_rot=2.0, w_trans=2.0)


def _accum_within_bound(pre, got, want, r, stream):
    """Kernel B's fusion ``got`` against the plain version's ``want``, both
    from the TSDF ``pre`` on the sorted ``stream`` of ``r``'s entries: a
    voxel no sample hits must be bitwise unchanged in both; a hit voxel's
    weight and wsum must differ by no more than two f32 summations of its
    n samples and old value in different orders can, 2 (n + 1) u times the
    sum of their magnitudes (u = 2^-24), plus, for wsum, the clamp's
    rescaling of that weight difference and 4 u of the result; the
    whole bound times 1.1. On the main path a voxel takes hundreds of
    samples in one scan (the plain version's ``index_add_`` sums in
    another order), so a fixed 1e-5 tolerance does not hold there.
    Returns (within, largest error over bound, largest |error|, n max)."""
    import torch

    from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import entry_sums

    ivox, w, wd = stream
    idx, (n, aw, awd, sw) = entry_sums(r.rows, r.starts, r.cnts, ivox,
                                       (torch.ones_like(w), w.abs(),
                                        wd.abs(), w))
    u = 2.0 ** -24
    W0, S0 = pre.weight.view(-1)[idx], pre.wsum.view(-1)[idx]
    bw = 2 * (n + 1) * u * (W0.abs() + aw)
    ws = want.wsum.view(-1)[idx]
    bs = (2 * (n + 1) * u * (S0.abs() + awd)
          + ws.abs() * bw / torch.clamp(W0 + sw, min=1e-12)
          + 4 * u * ws.abs())
    ok, ratio, err = True, 0.0, 0.0
    for f, bound in (("weight", 1.1 * bw), ("wsum", 1.1 * bs)):
        d = (getattr(got, f) - getattr(want, f)).abs().view(-1)
        rest = torch.ones_like(d, dtype=torch.bool)
        rest[idx] = False
        ok &= bool((d[idx] <= bound).all()) and bool((d[rest] == 0).all())
        ratio = max(ratio, float((d[idx] / torch.clamp(bound, min=1e-30)
                                  ).max()))
        err = max(err, float(d.max()))
    return ok, ratio, err, int(n.max())


def _sharded_rank(inp: dict) -> dict:
    """Phase 16's body on one rank (every rank on the card): (a) the
    odometry pipeline with ``make_sharded_align`` over the scans, beside
    each step the one-process step from a copy of the same state, then
    kernel A against its plain version on the operands of the rank's
    first shard search in align ``SHARDED_KEEP_ALIGN``; (b) the
    sharded TSDF over the steps' deskewed clouds, beside each fusion the
    same replicate-then-filter masks through the plain path from a copy of
    the same shard; (c) the sharded
    pose-graph solves beside the one-process ones. Launches made for a
    comparison are not counted."""
    import torch
    import torch.distributed as dist

    from noetic_slam_tpu_torch.config import TsdfConfig
    from noetic_slam_tpu_torch.models import posegraph as pg
    from noetic_slam_tpu_torch.models import tsdf as tsdf_mod
    from noetic_slam_tpu_torch.models.odometry import (
        OdomState,
        make_odometry_step,
    )
    from noetic_slam_tpu_torch.ops import neighbors
    from noetic_slam_tpu_torch.ops.cuda import nn_kernel as nk
    from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import (
        block_accumulate_plain,
    )
    from noetic_slam_tpu_torch.ops.pointcloud import SENTINEL
    from noetic_slam_tpu_torch.parallel import mesh as pmesh
    from noetic_slam_tpu_torch.parallel.bundle_adjustment import (
        sharded_optimize,
    )
    from noetic_slam_tpu_torch.parallel.registration import (
        make_sharded_align,
    )
    from noetic_slam_tpu_torch.parallel.tsdf import (
        gather_sharded_state,
        init_sharded_tsdf,
        make_sharded_integrate,
    )
    from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline

    mesh = pmesh.make_mesh(devices="cuda:0")
    D, my = mesh.size(), mesh.index()
    counters = _counters()
    A, B = "nn1_fused", "block_accumulate"

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    for fn in counters.values():
        fn.launches = 0
    out = {"rank": dist.get_rank(), "backend": dist.get_backend()}

    # (a) the odometry step with the sharded align
    cfg = _main_cfg()
    align = make_sharded_align(mesh)
    aligns, now, kept = [], {"align": -1}, {}
    inner_nn = neighbors.nn1

    def keeping(query, target, t_count=None, max_dist=None):
        if now["align"] == SHARDED_KEEP_ALIGN and "args" not in kept:
            kept["args"] = (query.clone(), target.clone(), t_count, max_dist)
        return inner_nn(query, target, t_count, max_dist)

    def counted_align(*a, **k):
        b0, c0 = mesh.reduce_bytes, mesh.reduce_calls
        now["align"] = len(aligns)
        res = align(*a, **k)
        now["align"] = -1
        aligns.append((mesh.reduce_bytes - b0, mesh.reduce_calls - c0))
        return res

    pipe = OdometryPipeline(cfg, align_fn=counted_align)
    sharded, one = pipe._step, make_odometry_step(cfg)
    gaps, clouds, t_step, ref_a = [], [], [0.0], [0]

    def step(state, x):
        a0 = counters[A].launches
        _, ref = one(OdomState(*(t.clone() for t in state)), x)
        ref_a[0] += counters[A].launches - a0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, o = sharded(state, x)
        torch.cuda.synchronize()
        t_step[0] += time.perf_counter() - t0
        gaps.append(torch.linalg.vector_norm(o.lidar_p - ref.lidar_p))
        clouds.append((o.world_xyz.clone(), o.world_valid.clone(),
                       o.lidar_p.clone()))
        return state, o

    pipe._step = step
    stamps, ang, acc = inp["imu"]
    imu_i = 0
    torch.cuda.reset_peak_memory_stats()
    neighbors.nn1 = keeping
    try:
        for h, xyz, pt in inp["scans"]:
            while (imu_i < len(stamps)
                   and stamps[imu_i] <= h + pt.max() + 0.02):
                pipe.push_imu(stamps[imu_i], ang[imu_i], acc[imu_i])
                imu_i += 1
            pipe.process_scan(h, xyz, pt)
    finally:
        neighbors.nn1 = inner_nn
    traj = pipe.flush()
    n = len(inp["scans"])
    la = launches()
    out["odometry"] = {
        "traj": traj, "gaps": [float(g) for g in gaps],
        "syncs": pipe.host_syncs, "steps_per_s": n / t_step[0],
        "A": la[A] - ref_a[0], "B": la[B], "aligns": aligns,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    # kernel A on the shard: uncapped, no target count, sentinel rows in
    # the shard (after the path's counts were read: not counted)
    _check("args" in kept, f"sharded D={D} rank {my}: align "
           f"{SHARDED_KEEP_ALIGN} made no shard search")
    q, shard, t_count, max_dist = kept.pop("args")
    _check(t_count is None and max_dist is None and shard.shape[0]
           == cfg.capacity.max_submap_kf * cfg.capacity.max_ds_points // D,
           f"sharded D={D} rank {my}: the shard search got {shard.shape[0]} "
           f"rows, t_count {t_count}, max_dist {max_dist}")
    _, ties, nn_err, _ = nn_check(f"sharded D={D} rank {my}", nk.nn1_fused,
                                  q, shard, None, None)
    out["nn"] = {"queries": q.shape[0], "rows": shard.shape[0],
                 "sentinel_rows": int((shard == SENTINEL).all(dim=1).sum()),
                 "ties": ties, "max_abs_err": nn_err}
    del q, shard

    # (b) the sharded TSDF over the steps' clouds; beside each fusion, the
    # same masks through the plain path from a copy of the same shard.
    # Every rank owns the default one-device capacity: a shard allocates
    # from the global count (JAX's counters), and past max_blocks / D in
    # all it reuses slots that hold blocks, so two entries of one fusion
    # can share a payload row (ROADMAP Queue 3), which kernel B's contract
    # excludes
    tcfg = TsdfConfig(max_blocks=D * TsdfConfig().max_blocks)
    integ = make_sharded_integrate(tcfg, mesh)
    st = init_sharded_tsdf(tcfg, mesh)
    for fn in counters.values():
        fn.launches = 0
    t_fuse, same_dir, close, err, worst, n_max = 0.0, True, True, 0.0, 0, 0
    local_deltas, global_deltas, peak = [], [], 0
    for xyz, valid, origin in clouds:
        pre = type(st)(*(t.clone() for t in st))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = integ(st, xyz, valid, origin)
        torch.cuda.synchronize()
        t_fuse += time.perf_counter() - t0
        pos, sdf, w = tsdf_mod._ray_samples(tcfg, xyz, valid, origin)
        keys, _ = tsdf_mod.sample_keys(pos, tcfg.voxel_size, w != 0.0)
        mine = (keys != tsdf_mod.KEY_PAD) & ((keys % D) == my)
        plain, r, stream = tsdf_mod.block_stream(
            tcfg, pre, pos, sdf, torch.where(mine, w, 0.0))
        block_accumulate_plain(plain.weight, plain.wsum, r.rows, r.starts,
                               r.cnts, *stream, tcfg.max_weight)
        same_dir &= all(bool(torch.equal(getattr(st, f), getattr(plain, f)))
                        for f in ("dir_keys", "dir_slots"))
        # this rank's change to the global counters (the plain path) and
        # the summed change every rank applied
        for deltas, x in ((local_deltas, plain), (global_deltas, st)):
            deltas.append((int(x.num_blocks - pre.num_blocks),
                           int(x.dropped - pre.dropped)))
        peak = max(peak, int(st.num_blocks))
        ok, ratio, e, n = _accum_within_bound(pre, st, plain, r, stream)
        close &= ok
        err, worst, n_max = max(err, e), max(worst, ratio), max(n_max, n)
        del pre, plain
    lb = launches()
    merged = gather_sharded_state(tcfg, st, mesh)
    out["tsdf"] = {"held": int((st.dir_keys != tsdf_mod.KEY_PAD).sum()),
                   "counts": (int(st.num_blocks), int(st.dropped)),
                   "local_deltas": local_deltas,
                   "global_deltas": global_deltas, "peak": peak,
                   "capacity": st.dir_keys.shape[0],
                   "merged_blocks": int(merged.num_blocks),
                   "merged_keys": int((merged.dir_keys
                                       != tsdf_mod.KEY_PAD).sum()),
                   "same_dir": same_dir, "max_abs_err": err, "close": close,
                   "bound_ratio": worst, "n_max": n_max,
                   "B": lb[B], "A": lb[A], "fuse_s": t_fuse}
    del st, merged, clouds

    # (c) the pose graph: CG on 2,048 nodes, dense on 64
    ba = {}
    for name, K, kw in (("cg", 2048, dict(iters=3, method="cg",
                                          cg_iters=50)),
                        ("dense", 64, dict(iters=10, method="dense"))):
        g = _ba_graph(pg, K, mesh.device)
        ref = pg.optimize(g, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sharded_optimize(mesh, g, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        dp = float(torch.linalg.vector_norm(got.node_p - ref.node_p,
                                            dim=-1).max())
        dots = torch.abs(torch.sum(got.node_q * ref.node_q, -1))
        ba[name] = {"dp": dp, "dot": float((1.0 - dots).abs().max()),
                    "moved": float(torch.linalg.vector_norm(
                        got.node_p - g.node_p, dim=-1).max()),
                    "s": dt, "node_p": got.node_p.cpu().numpy()}
    out["ba"] = ba
    return out


def phase_sharded(sim, scans) -> dict:
    """Phase 16: the sharded paths on D = 1 rank under NCCL and D = 2 and
    4 ranks under gloo, every rank on the card (``parallel.mesh.launch``;
    ``_sharded_rank``), over the first ``SHARDED_SCANS`` of phase 6's
    scans at the main path's width. Every rank's trajectory must be rank
    0's bitwise and every step within ``SHARDED_STEP_TOL`` of the
    one-process step from the same state; A and B must launch on every
    rank and agree with its plain version on a shard search of every
    rank; each rank's TSDF shard must equal the plain path's on the same
    masks, and the global block counters the sum of the ranks' changes;
    the pose-graph solves must agree with the one-process solves;
    the bytes handed to ``all_reduce`` per align must be the traffic
    model's. Returns the launches of A and B per rank and world."""
    from noetic_slam_tpu_torch.parallel import mesh as pmesh
    from noetic_slam_tpu_torch.parallel.registration import (
        collective_traffic_per_align,
    )
    from noetic_slam_tpu_torch.utils import synthetic

    t_phase = time.perf_counter()
    cfg = _main_cfg()
    nq = cfg.capacity.max_ds_points
    last = scans[SHARDED_SCANS - 1]
    n_imu = int(np.searchsorted(sim.imu_stamps, last[0] + last[2].max()
                                + 0.02, side="right"))
    inp = {"scans": scans[:SHARDED_SCANS],
           "imu": (sim.imu_stamps[:n_imu], sim.imu_ang[:n_imu],
                   sim.imu_acc[:n_imu])}
    out = {}
    ref_traj = None
    for world, backend in SHARDED_WORLDS:
        t0 = time.perf_counter()
        ranks = pmesh.launch(_sharded_rank, world, inp, backend=backend,
                             timeout=RANK_TIMEOUT)
        wall = time.perf_counter() - t0
        tag = f"D={world} {backend}"
        r0 = ranks[0]
        traj = r0["odometry"]["traj"]
        _check(len(traj) == SHARDED_SCANS and np.isfinite(traj).all(),
               f"sharded {tag}: {len(traj)} poses")
        for r in ranks[1:]:
            _check(np.array_equal(r["odometry"]["traj"], traj),
                   f"sharded {tag}: rank {r['rank']}'s poses differ from "
                   f"rank 0's")
            _check(r["odometry"]["syncs"] == r0["odometry"]["syncs"],
                   f"sharded {tag}: rank {r['rank']} read the host "
                   f"{r['odometry']['syncs']} times, rank 0 "
                   f"{r0['odometry']['syncs']}")
        ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                                 sim.gt_pos)
        gap = max(max(r["odometry"]["gaps"]) for r in ranks)
        _check(gap < SHARDED_STEP_TOL, f"sharded {tag}: a step {gap:.4f} m "
               f"from the one-process step")
        _check(ate < GRID_ATE, f"sharded {tag}: ATE {ate:.4f} m")
        for r in ranks:
            o, t = r["odometry"], r["tsdf"]
            _check(o["A"] > 0 and t["B"] == SHARDED_SCANS,
                   f"sharded {tag}: rank {r['rank']} launched A {o['A']}, "
                   f"B {t['B']} times")
            _check(t["same_dir"] and t["close"],
                   f"sharded {tag}: rank {r['rank']}'s TSDF shard differs "
                   f"from the plain path's (directory {t['same_dir']}, "
                   f"max |err| {t['max_abs_err']:.3e}, "
                   f"{t['bound_ratio']:.3f} of the summation bound)")
            for calls_bytes in o["aligns"]:
                nbytes, calls = calls_bytes
                iters = calls // 4
                model = collective_traffic_per_align(cfg.gicp, nq, world,
                                                     iters)
                _check(calls == 4 * iters and nbytes == iters * 4
                       * model["per_relinearize_reduce_elements"],
                       f"sharded {tag}: an align handed {nbytes} bytes in "
                       f"{calls} all_reduces, the model "
                       f"{model['per_relinearize_reduce_elements'] * 4} "
                       f"bytes per iteration")
            for name, b in r["ba"].items():
                _check(b["dp"] < BA_TOL and b["dot"] < 1e-5,
                       f"sharded {tag}: {name} solve {b['dp']:.2e} m from "
                       f"the one-process solve")
                _check(np.array_equal(b["node_p"],
                                      r0["ba"][name]["node_p"]),
                       f"sharded {tag}: rank {r['rank']}'s {name} solve "
                       f"differs from rank 0's")
        counts = r0["tsdf"]["counts"]
        held = [r["tsdf"]["held"] for r in ranks]
        _check(all(r["tsdf"]["counts"] == counts for r in ranks)
               and r0["tsdf"]["merged_blocks"] == counts[0]
               == r0["tsdf"]["merged_keys"] == sum(held)
               and r0["tsdf"]["peak"] <= r0["tsdf"]["capacity"],
               f"sharded {tag}: blocks held {held}, gathered "
               f"{r0['tsdf']['merged_keys']}, counters {counts}, the "
               f"global count up to {r0['tsdf']['peak']} of a shard's "
               f"{r0['tsdf']['capacity']} slots")
        summed = [tuple(map(sum, zip(*f))) for f in
                  zip(*(r["tsdf"]["local_deltas"] for r in ranks))]
        _check(all(r["tsdf"]["global_deltas"] == summed for r in ranks),
               f"sharded {tag}: the global block counters did not advance "
               f"by the sum of the ranks' changes")
        o = r0["odometry"]
        its = [c // 4 for _, c in o["aligns"]]
        per_iter = [b // max(c // 4, 1) for b, c in o["aligns"]]
        model = collective_traffic_per_align(cfg.gicp, nq, world)
        vs_one = ("" if ref_traj is None else
                  f"; largest per-pose distance to D=1's run "
                  f"{_pose_gap(traj, ref_traj):.4f} m")
        print(f"[16 sharded] {tag} ({wall:.1f} s with the spawn): (a) "
              f"{SHARDED_SCANS} scans x 32768 points, every rank's poses "
              f"bitwise rank 0's; {o['steps_per_s']:.2f} steps/s (sharded "
              f"step alone, synchronised); largest step gap to the "
              f"one-process step {gap:.4f} m; ATE {ate:.4f} m{vs_one}; "
              f"host syncs {o['syncs'] / SHARDED_SCANS:.2f}/scan; peak "
              f"memory rank 0 {o['peak_gib']:.3f} GiB; {len(its)} aligns, "
              f"{sum(its)} outer iterations; all_reduce bytes per "
              f"iteration {sorted(set(per_iter))} = the model's "
              f"{model['per_relinearize_reduce_elements'] * 4} (ring recv "
              f"model {model['per_relinearize_reduce_recv_bytes']} + "
              f"{model['per_relinearize_psum_bytes']} B)", flush=True)
        nn = [r["nn"] for r in ranks]
        print(f"[16 sharded] {tag}: (a) kernel A against its plain version "
              f"on each rank's first shard search of align "
              f"{SHARDED_KEEP_ALIGN} (uncapped, no target count): "
              f"{nn[0]['queries']} queries x {nn[0]['rows']} rows a rank, "
              f"sentinel rows {[x['sentinel_rows'] for x in nn]}, idx ties "
              f"{[x['ties'] for x in nn]}, max |dsqd| "
              f"{max(x['max_abs_err'] for x in nn):.3e}", flush=True)
        t = [r["tsdf"] for r in ranks]
        print(f"[16 sharded] {tag}: (b) TSDF (TsdfConfig, "
              f"{r0['tsdf']['capacity']} blocks a rank): blocks held "
              f"per rank {held}, gathered {r0['tsdf']['merged_keys']} (the "
              f"global count never above a shard's slots); "
              f"global counters num_blocks {counts[0]}, dropped "
              f"{counts[1]}, each fusion's change the sum of the ranks'; "
              f"kernel "
              f"B vs the plain path on the same masks, fusion by fusion: "
              f"max |err| {max(x['max_abs_err'] for x in t):.3e}, "
              f"{max(x['bound_ratio'] for x in t):.3f} of the summation "
              f"bound (up to {max(x['n_max'] for x in t)} samples a voxel), "
              f"directories equal; "
              f"fuse {t[0]['fuse_s']:.2f} s for {SHARDED_SCANS} scans",
              flush=True)
        ba = r0["ba"]
        print(f"[16 sharded] {tag}: (c) pose graph: cg 2048 nodes "
              f"{ba['cg']['s']:.2f} s, max |dp| to one process "
              f"{max(r['ba']['cg']['dp'] for r in ranks):.2e} m (nodes "
              f"moved up to {ba['cg']['moved']:.3f} m); dense 64 nodes "
              f"{ba['dense']['s']:.2f} s, max |dp| "
              f"{max(r['ba']['dense']['dp'] for r in ranks):.2e} m",
              flush=True)
        print(f"[16 sharded] {tag}: launches per rank: A "
              f"{[r['odometry']['A'] for r in ranks]}, B "
              f"{[r['tsdf']['B'] for r in ranks]}", flush=True)
        out[f"D{world}"] = {
            "nn1_fused": [r["odometry"]["A"] for r in ranks],
            "block_accumulate": [r["tsdf"]["B"] for r in ranks],
            "logodds_accumulate": [0] * world}
        if ref_traj is None:
            ref_traj = traj
    print(f"[16 sharded] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# The benchmark (phase 17)
# ---------------------------------------------------------------------------

BENCH_ATE = 0.05         # m: bench.py's ATEs, tests/test_odometry_e2e.py:53
TRACE_SCANS = 10         # main-path scans under device_trace


def _trace_device_time(logdir: str) -> tuple[int, float]:
    """(kernel events, their summed duration in ms) of the one trace that
    ``device_trace`` wrote into ``logdir``."""
    import glob
    import os

    files = glob.glob(os.path.join(logdir, "*.json"))
    _check(len(files) == 1, f"device_trace wrote {len(files)} traces")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return len(kernels), sum(float(e.get("dur", 0.0)) for e in kernels) / 1e3


def phase_bench(cfg, sim, scans) -> dict:
    """Phase 17: ``cli bench`` at full size in this process (counters set
    to 0 just before, read just after, plain-version calls counted), its
    JSON line checked; then TRACE_SCANS main-path scans under
    ``device_trace``."""
    import contextlib
    import io

    import torch

    from noetic_slam_tpu_torch import cli
    from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
    from noetic_slam_tpu_torch.runtime.profiling import device_trace

    t_phase = time.perf_counter()
    counters = _counters()
    probes = _Probes()
    buf = io.StringIO()
    gc.collect()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    with probes, contextlib.redirect_stdout(buf):
        rc = cli.main(["bench"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    _check(rc == 0 and len(lines) == 1, f"bench: exit {rc}, {len(lines)} "
           "JSON lines")
    print(f"[17 bench] {lines[0]}", flush=True)
    r = json.loads(lines[0])
    ex = r["extras"]
    for key in ("ate_rmse_m_synthetic", "ate_rmse_m_mulran_fixture"):
        _check(ex[key] is not None and ex[key] < BENCH_ATE,
               f"bench: {key} {ex[key]} (limit {BENCH_ATE} m)")
    _check(ex["submap_overflow"] == 0,
           f"bench: submap_overflow {ex['submap_overflow']}")
    _check(ex["slam_system_lost_keyframes"] == 0,
           f"bench: {ex['slam_system_lost_keyframes']} keyframes lost")
    _check(ex["backend"] == "torch-cuda", f"bench: backend {ex['backend']}")
    _check(probes.plain_calls == 0,
           f"bench: {probes.plain_calls} calls reached a plain version")
    for name in ("nn1_fused", "block_accumulate"):
        _check(launches[name] > 0, f"bench: {name} never launched")
    print(f"[17 bench] {r['value']} scans/s (K=8), online "
          f"{ex['online_scans_per_sec_k1']} scans/s (p50 "
          f"{ex['online_latency_ms_p50']} / p95 {ex['online_latency_ms_p95']}"
          f" ms), fused {ex['slam_fused_scans_per_sec']}, system "
          f"{ex['slam_system_scans_per_sec']} ({ex['slam_system_closures']} "
          f"closures, {ex['slam_system_raced_attempts']} raced), TSDF "
          f"{ex['tsdf_integrations_per_sec']} integrations/s; ATE synthetic "
          f"{ex['ate_rmse_m_synthetic']} m, MulRan "
          f"{ex['ate_rmse_m_mulran_fixture']} m; host syncs/scan "
          f"{ex['host_syncs_per_scan']}; {ex['device']}, "
          f"{ex['power_limit_w']} W; launches {launches}; no plain-version "
          f"call; {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ten main-path scans under device_trace, after ten untraced ones
    pipe = OdometryPipeline(cfg, with_tsdf=True)
    feed = _feeder(pipe, sim)

    def run(lo, hi):
        for h, xyz, pt in scans[lo:hi]:
            feed(h + pt.max() + 0.02)
            pipe.process_scan(h, xyz, pt)

    run(0, TRACE_SCANS)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        t0 = time.perf_counter()
        with device_trace(d) as started:
            run(TRACE_SCANS, 2 * TRACE_SCANS)
        wall = time.perf_counter() - t0
        _check(started, "device_trace: the profiler did not start")
        n_kernels, dev_ms = _trace_device_time(d)
    print(f"[17 bench] device_trace over {TRACE_SCANS} main-path scans: "
          f"started {started}; the trace holds {n_kernels} kernel events, "
          f"{dev_ms:.1f} ms of device time ({dev_ms / TRACE_SCANS:.2f} ms "
          f"a scan) in {wall:.2f} s wall under the profiler; device time "
          f"{'present' if dev_ms > 0 else 'absent'}", flush=True)
    print(f"[17 bench] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=40,
                    help="synthetic scans on the main path (default 40)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after each path's timed window, run N more "
                         "scans under torch.profiler and print where the "
                         "device time goes")
    args = ap.parse_args(argv)

    dev, gpu_line = phase_device()
    import torch

    from noetic_slam_tpu_torch.utils import synthetic

    phase_build()
    kernels = [phase_nn(dev), phase_tsdf(dev), phase_logodds(dev)]

    # one synthetic sequence for both paths
    t0 = time.perf_counter()
    total = max(args.scans, OCC_SCANS) + args.profile
    sim = synthetic.make_sim(duration=total / 10.0 + 0.3, n_points=32768,
                             calib_time=3.1, seed=7)
    scans = [sim.scan(i) for i in range(min(total, len(sim.scan_stamps)))]
    print(f"[sim] {len(scans)} scans x 32768 points in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    cfg = _main_cfg()
    tsdf_pipe, tsdf_traj, launches, kept = phase_main_path(
        cfg, sim, scans, args.scans, args.profile)
    kernels[0].update(phase_nn_main_shape(kept))
    del kept
    occ_pipe, occ_traj, occ_launches = phase_occupancy_path(
        cfg, sim, scans, OCC_SCANS, args.profile)
    phase_map_products(cfg.tsdf, tsdf_pipe.tsdf_state, tsdf_traj,
                       cfg.occupancy, occ_pipe.tsdf_state, occ_traj)
    del tsdf_pipe, occ_pipe
    # A and B from the main path, C from the occupancy path
    launches["logodds_accumulate"] = occ_launches["logodds_accumulate"]

    probes = _Probes()
    system_launches = phase_system(probes)
    closure_launches = phase_closure(probes)
    _check(probes.verify_a > 0, "no verify_loop call launched kernel A")
    extra = phase_system_kernels(probes)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        cli_launches, capture = phase_cli(sim, scans, root)
        live_launches = phase_live(root, capture)
        batch_launches = phase_batch(root)
        grid_launches = phase_grid(sim, scans, args.scans, tsdf_traj, root)
    sharded_launches = phase_sharded(sim, scans)
    bench_launches = phase_bench(cfg, sim, scans)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        _check(k["launches"] > 0, f"{k['name']} never launched on its path")
        k["system_launches"] = system_launches[k["name"]]
        k["closure_launches"] = closure_launches[k["name"]]
        for key, runs in (("cli_launches", cli_launches),
                          ("live_launches", live_launches),
                          ("batch_launches", batch_launches),
                          ("grid_launches", grid_launches),
                          ("sharded_launches", sharded_launches)):
            k[key] = {run: n[k["name"]] for run, n in runs.items()}
        k["bench_launches"] = bench_launches[k["name"]]
        k.update(extra.get(k["name"], {}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_cold",
            "library_ms_cold")
    print(json.dumps({"kernels": [
        {**{key: k[key] for key in keys},
         **{key: v for key, v in k.items()
            if key.startswith(("main_shape", "system", "closure", "cli",
                               "live", "batch", "grid", "sharded",
                               "bench"))}}
        for k in kernels]}))
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
