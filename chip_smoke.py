#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``noetic_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--scans 60] [--profile N]

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
   ESDF region of the occupancy map.

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


def nn_check(label, nn1, q, tgt, count, cap):
    """Kernel A (``nn1``) twice and its plain version once on the same
    operands: two runs bitwise equal, found sets equal, not-found idx 0
    with sqd = cap^2, sqd within rtol TOL, idx equal or tied within it.
    Returns (found, idx ties, max |dsqd|, plain sqd)."""
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
    c2 = np.inf if cap is None else np.float32(cap) ** 2
    fk, fp = dk < c2, dp < c2
    _check(np.array_equal(fk, fp), f"nn {label}: found sets differ "
           f"({int((fk != fp).sum())} queries)")
    if cap is not None:
        _check(bool(np.all(ik[~fk] == 0)), f"nn {label}: not-found idx != 0")
        _check(bool(np.all(dk[~fk] == c2)), f"nn {label}: not-found sqd "
               "!= cap^2")
    np.testing.assert_allclose(dk[fk], dp[fp], rtol=TOL, atol=0.0)
    tie = ik != ip
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
    _check(launches["nn1_fused"] > 0, f"{tag}: kernel A never launched")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=60,
                    help="synthetic scans on the main path (default 60)")
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
    # A and B from the main path, C from the occupancy path
    launches["logodds_accumulate"] = occ_launches["logodds_accumulate"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        _check(k["launches"] > 0, f"{k['name']} never launched on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_cold",
            "library_ms_cold")
    print(json.dumps({"kernels": [
        {**{key: k[key] for key in keys},
         **{key: v for key, v in k.items() if key.startswith("main_shape")}}
        for k in kernels]}))
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
