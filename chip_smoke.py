#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``noetic_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--scans 60] [--profile N]

Phases, each printing its own line:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: the hand-written kernels (``noetic_slam_tpu_torch/csrc``) built
   with nvcc for sm_90a into ``build/torch_kernels/``;
3. kernel A (1-NN) against its plain version at the slice's shapes:
   8192 queries against 262,144 Morton-sorted targets, capped (0.5 m) and
   uncapped;
4. kernel B (TSDF block accumulation) against its plain version: one
   scan's 753,664-sample stream into a 65,536-row payload, clamped and in
   the NO_CLAMP signed case;
5. kernel C (occupancy log-odds accumulation) against its plain version:
   one scan's 819,200 beam samples into a 65,536-row payload, clamped at
   the ``OccupancyConfig`` defaults and unclamped (-/+1e30, sign -1);
6. the main path: ``OdometryPipeline(cfg, with_tsdf=True)`` (the card by
   default) over a synthetic 32,768-point sequence at the production
   capacities, with the launch counters reset just before it; the
   trajectory's ATE against ground truth must stay under 0.05 m;
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
TOL = 1e-5      # kernel vs plain: rtol and atol
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory, data sheet
F32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _time_ms(fn, iters: int) -> float:
    """Mean ms per call from CUDA events, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_row(name, source, replaces, max_err, ms, plain_ms, library_ms,
                nbytes, ops):
    bound_ms, bound_by = _bound(nbytes, ops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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


def phase_nn(dev):
    import torch

    from noetic_slam_tpu_torch.ops.cuda.nn_kernel import (
        Q_TILE,
        T_TILE,
        nn1_fused,
        nn1_plain,
        visit_lists,
    )
    from noetic_slam_tpu_torch.ops.pointcloud import SENTINEL, morton_sort_key

    rng = np.random.default_rng(0)
    n_live = N_TARGET - N_TARGET // 16        # padded submap: live rows first
    tgt = np.full((N_TARGET, 3), SENTINEL, np.float32)
    tgt[:n_live] = _planes_cloud(rng, n_live)
    valid = np.arange(N_TARGET) < n_live
    tgt_t = torch.from_numpy(tgt).to(dev)
    key = morton_sort_key(tgt_t, torch.from_numpy(valid).to(dev), 1.0)
    tgt_t = tgt_t[torch.sort(key, stable=True).indices].contiguous()
    # queries: a registration source - target points plus 5 cm noise, one
    # in eight moved off the surfaces by ~1 m (beyond the cap), Morton order
    pick = rng.choice(n_live, N_QUERY, replace=False)
    noise = rng.normal(0, 0.05, (N_QUERY, 3))
    noise[::8] = rng.normal(0, 1.0, (len(noise[::8]), 3))
    q = (tgt_t[torch.from_numpy(pick).to(dev)]
         + torch.from_numpy(noise.astype(np.float32)).to(dev))
    qkey = morton_sort_key(q, torch.ones(N_QUERY, dtype=torch.bool,
                                         device=dev), 1.0)
    q = q[torch.sort(qkey, stable=True).indices].contiguous()
    count = torch.full((), n_live, dtype=torch.int32, device=dev)

    max_err = 0.0
    res = {}
    for label, cap in (("capped", NN_CAP), ("uncapped", None)):
        cap_t = None if cap is None else torch.full((), cap, device=dev)
        ik, dk = nn1_fused(q, tgt_t, count, cap_t)
        ip, dp = nn1_plain(q, tgt_t, count, cap_t)
        torch.cuda.synchronize()
        ik, dk, ip, dp = (x.cpu().numpy() for x in (ik, dk, ip, dp))
        c2 = np.inf if cap is None else np.float32(cap) ** 2
        fk, fp = dk < c2, dp < c2
        _check(np.array_equal(fk, fp), f"nn {label}: found sets differ "
               f"({int((fk != fp).sum())} queries)")
        if cap is None:
            _check(bool(fk.all()), "nn uncapped: a query found nothing")
        else:
            _check(0.5 < fk.mean() < 0.99, f"nn capped: found share "
                   f"{fk.mean():.3f} does not exercise the cap")
            _check(bool(np.all(ik[~fk] == 0)), "nn capped: not-found idx != 0")
        np.testing.assert_allclose(dk[fk], dp[fp], rtol=TOL, atol=0.0)
        tie = ik != ip
        _check(bool(np.all(np.isclose(dk[tie], dp[tie], rtol=TOL, atol=0.0))),
               f"nn {label}: idx differ where distances do not tie")
        max_err = max(max_err, float(np.abs(dk[fk] - dp[fk]).max()))
        res[label] = (int(fk.sum()), int(tie.sum()))

    cap_t = torch.full((), NN_CAP, device=dev)
    ms = _time_ms(lambda: nn1_fused(q, tgt_t, count, cap_t), 20)
    plain_ms = _time_ms(lambda: nn1_plain(q, tgt_t, count, cap_t), 3)

    # bound: 8 f32 operations (3 sub, 3 mul, 2 add) per query-target pair
    # over the target tiles a best-first walk must visit (those whose box
    # bound beats the query tile's final worst best), counted by the plain
    # code that builds the visit lists; bytes: each input read once, each
    # output written once
    cap2 = torch.full((1,), NN_CAP ** 2, device=dev)
    vlist, vlb, _ = visit_lists(q, tgt_t, count.reshape(1), cap2)
    _, d_plain = nn1_plain(q, tgt_t, count, cap_t)
    worst = torch.minimum(d_plain, cap2).reshape(-1, Q_TILE).amax(dim=1)
    tile_rows = torch.clamp(n_live - vlist.long() * T_TILE, 0, T_TILE)
    pairs = int((torch.where(vlb < worst[:, None], tile_rows, 0).sum(dim=1)
                 * Q_TILE).sum())
    nbytes = N_QUERY * 12 + n_live * 12 + N_QUERY * 8

    def library():
        # brute force over the live targets (the port never calls cdist)
        for q0 in range(0, N_QUERY, 1024):
            torch.cdist(q[q0:q0 + 1024], tgt_t[:n_live]).amin(dim=1)

    library_ms = _time_ms(library, 3)
    row = _kernel_row("nn1_fused", "noetic_slam_tpu_torch/csrc/nn1.cu",
                      "noetic_slam_tpu/ops/pallas/nn_kernel.py:53", max_err,
                      ms, plain_ms, library_ms, nbytes, 8.0 * pairs)
    print(f"[3 nn1] {N_QUERY} x {N_TARGET} (live {n_live}): capped found "
          f"{res['capped'][0]}, uncapped found {res['uncapped'][0]}; idx "
          f"ties {res['capped'][1]}/{res['uncapped'][1]}; max |dsqd| "
          f"{max_err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"cdist+min {library_ms:.3f} ms (capped); {pairs} pairs needed "
          f"({pairs / (N_QUERY * n_live):.4f} of brute force), bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    return row


def phase_tsdf(dev):
    import torch

    from noetic_slam_tpu_torch.config import TsdfConfig
    from noetic_slam_tpu_torch.models import tsdf as tsdf_mod
    from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import (
        NO_CLAMP,
        block_accumulate,
        block_accumulate_plain,
    )

    rng = np.random.default_rng(1)
    tcfg = TsdfConfig()
    pts = torch.from_numpy(_planes_cloud(rng, 32768) * 0.5).to(dev)
    valid = torch.ones(32768, dtype=torch.bool, device=dev)
    origin = torch.zeros(3, device=dev)
    pos, sdf, w = tsdf_mod._ray_samples(tcfg, pts, valid, origin)
    _check(pos.shape[0] == 32768 * 23, f"tsdf: {pos.shape[0]} samples")

    max_err, times = 0.0, {}
    for label, max_weight, sign in (("clamped", tcfg.max_weight, 1.0),
                                    ("no_clamp", NO_CLAMP, -1.0)):
        st = tsdf_mod.init_tsdf(tcfg, dev)
        st, r, stream = tsdf_mod.block_stream(tcfg, st, pos, sdf, w * sign)
        # a payload with history: weights up to the clamp, signed sums
        W = torch.from_numpy(rng.uniform(0, 100, st.weight.shape)
                             .astype(np.float32)).to(dev)
        WS = W * torch.from_numpy(rng.uniform(-0.3, 0.3, st.weight.shape)
                                  .astype(np.float32)).to(dev)
        args = (r.rows, r.starts, r.cnts, *stream, max_weight)
        wk, wsk = W.clone(), WS.clone()
        block_accumulate(wk, wsk, *args)
        wp, wsp = W.clone(), WS.clone()
        block_accumulate_plain(wp, wsp, *args)
        torch.cuda.synchronize()
        n_blocks = int((r.cnts > 0).sum())
        _check(n_blocks > 1000, f"tsdf {label}: only {n_blocks} blocks")
        for a, b in ((wk, wp), (wsk, wsp)):
            torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
            max_err = max(max_err, float((a - b).abs().max()))
        touched = r.rows[r.cnts > 0].long()
        untouched = torch.ones(W.shape[0], dtype=torch.bool, device=dev)
        untouched[touched] = False
        _check(bool(torch.equal(wk[untouched], W[untouched])),
               f"tsdf {label}: an untouched row changed")
        if label == "clamped":
            _check(float(wk.max()) <= tcfg.max_weight,
                   "tsdf clamped: weight above max_weight")
        times[label] = (
            _time_ms(lambda: block_accumulate(wk, wsk, *args), 20),
            _time_ms(lambda: block_accumulate_plain(wp, wsp, *args), 5))
    ms, plain_ms = times["clamped"]
    ivox, ws, wd = stream
    flat, spos = _stream_addresses(r, ivox)
    pay = torch.zeros((W.numel(), 2), device=dev)
    vals = torch.stack([ws[spos], wd[spos]], dim=1)
    library_ms = _time_ms(lambda: pay.index_add_(0, flat, vals), 20)
    n_samples = int(spos.shape[0])
    n_vox = int(torch.unique(flat).shape[0])
    # bound: the entries and the stream read once (12 B per sample), each
    # voxel the samples change read and written once in both channels
    row = _kernel_row(
        "block_accumulate", "noetic_slam_tpu_torch/csrc/block_accum.cu",
        "noetic_slam_tpu/ops/pallas/tsdf_kernel.py:51", max_err, ms,
        plain_ms, library_ms,
        nbytes=12 * r.rows.shape[0] + 12 * n_samples + 16 * n_vox,
        ops=2 * n_samples + 5 * n_vox)
    print(f"[4 tsdf] {pos.shape[0]} samples ({n_samples} in real entries, "
          f"{n_vox} voxels), {n_blocks} blocks into "
          f"({tcfg.max_blocks}, 512), largest block {int(r.cnts.max())} "
          f"samples: max |d| {max_err:.3e}; kernel {ms:.3f} / "
          f"{times['no_clamp'][0]:.3f} ms, plain {plain_ms:.3f} / "
          f"{times['no_clamp'][1]:.3f} ms (clamped / no_clamp), index_add_ "
          f"{library_ms:.3f} ms; bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    return row


def _stream_addresses(runs, ivox):
    """(flat payload index, stream position) of every sample of a real
    entry: the operands of the one ``index_add_`` that computes a block
    accumulation's sums (the library yardstick), and what its bound
    counts (the distinct voxels it changes)."""
    from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import entry_addresses

    ent, pos = entry_addresses(runs.starts, runs.cnts)
    return runs.rows.long()[ent] * 512 + ivox[pos].long(), pos


def phase_logodds(dev):
    import torch

    from noetic_slam_tpu_torch.config import OccupancyConfig
    from noetic_slam_tpu_torch.models import occupancy as occ_mod
    from noetic_slam_tpu_torch.ops.cuda.logodds_kernel import (
        UNCLAMPED,
        logodds_accumulate,
        logodds_accumulate_plain,
    )

    rng = np.random.default_rng(2)
    ocfg = OccupancyConfig()
    pts = torch.from_numpy(_planes_cloud(rng, 32768) * 0.5).to(dev)
    valid = torch.ones(32768, dtype=torch.bool, device=dev)
    pos, delta = occ_mod._beam_samples(ocfg, pts, valid,
                                       torch.zeros(3, device=dev))
    _check(pos.shape[0] == 32768 * (1 + ocfg.miss_samples),
           f"logodds: {pos.shape[0]} samples")

    max_err, times = 0.0, {}
    for label, lo, hi, sign in (("clamped", ocfg.l_min, ocfg.l_max, 1.0),
                                ("signed", -UNCLAMPED, UNCLAMPED, -1.0)):
        st = occ_mod.init_occupancy(ocfg, dev)
        st, r, stream = occ_mod.delta_stream(ocfg, st, pos, delta * sign)
        # a payload with history, uniform in [l_min, l_max]
        L = torch.from_numpy(rng.uniform(ocfg.l_min, ocfg.l_max,
                                         st.logodds.shape)
                             .astype(np.float32)).to(dev)
        args = (r.rows, r.starts, r.cnts, *stream, lo, hi)
        lk, lk2, lp = L.clone(), L.clone(), L.clone()
        logodds_accumulate(lk, *args)
        logodds_accumulate(lk2, *args)
        logodds_accumulate_plain(lp, *args)
        torch.cuda.synchronize()
        n_blocks = int((r.cnts > 0).sum())
        _check(n_blocks > 1000, f"logodds {label}: only {n_blocks} blocks")
        _check(bool(torch.equal(lk, lk2)),
               f"logodds {label}: two kernel runs differ")
        err = float((lk - lp).abs().max())
        _check(err <= TOL, f"logodds {label}: max |dL| {err:.3e} > {TOL}")
        max_err = max(max_err, err)
        touched = r.rows[r.cnts > 0].long()
        untouched = torch.ones(L.shape[0], dtype=torch.bool, device=dev)
        untouched[touched] = False
        _check(bool(torch.equal(lk[untouched], L[untouched])),
               f"logodds {label}: an untouched row changed")
        if label == "clamped":
            _check(float(lk.min()) >= lo and float(lk.max()) <= hi,
                   "logodds clamped: outside [l_min, l_max]")
        else:
            _check(float(lk.max()) > ocfg.l_max,
                   "logodds signed: the +-1e30 clip was not the identity")
        times[label] = (_time_ms(lambda: logodds_accumulate(lk, *args), 20),
                        _time_ms(lambda: logodds_accumulate_plain(lp, *args),
                                 5))
    ms, plain_ms = times["clamped"]
    ivox, d_sorted = stream
    flat, spos = _stream_addresses(r, ivox)
    pay = torch.zeros(L.numel(), device=dev)
    vals = d_sorted[spos]
    library_ms = _time_ms(lambda: pay.index_add_(0, flat, vals), 20)
    n_samples = int(spos.shape[0])
    n_vox = int(torch.unique(flat).shape[0])
    largest = int(r.cnts.max())
    # bound: the entries and the stream read once (8 B per sample), each
    # voxel the samples change read and written once
    row = _kernel_row(
        "logodds_accumulate", "noetic_slam_tpu_torch/csrc/block_accum.cu",
        "noetic_slam_tpu/ops/pallas/tsdf_kernel.py:112", max_err, ms,
        plain_ms, library_ms,
        nbytes=12 * r.rows.shape[0] + 8 * n_samples + 8 * n_vox,
        ops=n_samples + 3 * n_vox)
    print(f"[5 logodds] {pos.shape[0]} samples ({n_samples} in real "
          f"entries, {n_vox} voxels), {n_blocks} blocks into "
          f"({ocfg.max_blocks}, 512), "
          f"largest block {largest} samples (mean "
          f"{n_samples / n_blocks:.0f}): max |dL| {max_err:.3e}; kernel "
          f"{ms:.3f} / {times['signed'][0]:.3f} ms, plain {plain_ms:.3f} / "
          f"{times['signed'][1]:.3f} ms (clamped / signed), index_add_ "
          f"{library_ms:.3f} ms; bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
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


def _drive(tag: str, cfg, sim, scans, n_scans: int, n_profile: int = 0):
    """``OdometryPipeline(cfg, with_tsdf=True)``, on the card by default,
    over ``scans[:n_scans]`` (the first ten untimed), with every launch
    counter set to 0 just before and read just after; then ``n_profile``
    more scans under torch.profiler. Checks the trajectory and returns
    (pipeline, trajectory, launches, stats)."""
    import torch

    from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
    from noetic_slam_tpu_torch.utils import synthetic

    counters = _counters()
    pipe = OdometryPipeline(cfg, with_tsdf=True)
    _check(pipe.device.type == "cuda", f"{tag}: not on the card")
    imu_i = 0

    def run(lo, hi):
        nonlocal imu_i
        for h, xyz, pt in scans[lo:hi]:
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

    pipe, traj, launches, stats = _drive("main path", cfg, sim, scans,
                                         n_scans, n_profile)
    _check(launches["block_accumulate"] > 0,
           "main path: kernel B never launched")
    _check(bool(torch.isfinite(pipe.tsdf_state.weight).all()),
           "main path: non-finite TSDF weight")
    print(f"[6 main path] {n_scans} scans x 32768 points, tsdf: "
          f"{_path_line(stats, pipe)}; launches {launches}", flush=True)
    return pipe, traj, launches


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
    tsdf_pipe, tsdf_traj, launches = phase_main_path(
        cfg, sim, scans, args.scans, args.profile)
    occ_pipe, occ_traj, occ_launches = phase_occupancy_path(
        cfg, sim, scans, OCC_SCANS, args.profile)
    phase_map_products(cfg.tsdf, tsdf_pipe.tsdf_state, tsdf_traj,
                       cfg.occupancy, occ_pipe.tsdf_state, occ_traj)
    # A and B from the main path, C from the occupancy path
    launches["logodds_accumulate"] = occ_launches["logodds_accumulate"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        _check(k["launches"] > 0, f"{k['name']} never launched on its path")
    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")} for k in kernels]}))
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
