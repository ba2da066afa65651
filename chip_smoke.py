#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``noetic_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--scans 60]

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
5. the main path: ``OdometryPipeline(cfg, with_tsdf=True, device="cuda")``
   over a synthetic 32,768-point sequence at the production capacities,
   with the launch counters reset just before it; the trajectory's ATE
   against ground truth must stay under 0.05 m.

Then one JSON line with every kernel's launches, error and times, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``. Any failed
phase exits non-zero before the last line. Needs a CUDA device: without
one it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_QUERY = 8192
N_TARGET = 262144
NN_CAP = 0.5
TOL = 1e-5       # kernel vs plain: rtol and atol


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

    from noetic_slam_tpu_torch.ops.cuda.nn_kernel import nn1_fused, nn1_plain
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
    print(f"[3 nn1] {N_QUERY} x {N_TARGET} (live {n_live}): capped found "
          f"{res['capped'][0]}, uncapped found {res['uncapped'][0]}; idx "
          f"ties {res['capped'][1]}/{res['uncapped'][1]}; max |dsqd| "
          f"{max_err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(capped)", flush=True)
    return {"name": "nn1_fused", "route": "cuda",
            "source": "noetic_slam_tpu_torch/csrc/nn1.cu",
            "replaces": "noetic_slam_tpu/ops/pallas/nn_kernel.py:53",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


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
        st, s = tsdf_mod.block_stream(tcfg, st, pos, sdf, w * sign)
        # a payload with history: weights up to the clamp, signed sums
        W = torch.from_numpy(rng.uniform(0, 100, st.weight.shape)
                             .astype(np.float32)).to(dev)
        WS = W * torch.from_numpy(rng.uniform(-0.3, 0.3, st.weight.shape)
                                  .astype(np.float32)).to(dev)
        args = (s.rows, s.starts, s.cnts, s.ivox, s.w, s.wd, max_weight)
        wk, wsk = W.clone(), WS.clone()
        block_accumulate(wk, wsk, *args)
        wp, wsp = W.clone(), WS.clone()
        block_accumulate_plain(wp, wsp, *args)
        torch.cuda.synchronize()
        n_blocks = int((s.cnts > 0).sum())
        _check(n_blocks > 1000, f"tsdf {label}: only {n_blocks} blocks")
        for a, b in ((wk, wp), (wsk, wsp)):
            torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
            max_err = max(max_err, float((a - b).abs().max()))
        touched = s.rows[s.cnts > 0].long()
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
    print(f"[4 tsdf] {pos.shape[0]} samples, {n_blocks} blocks into "
          f"({tcfg.max_blocks}, 512): max |d| {max_err:.3e}; kernel "
          f"{ms:.3f} / {times['no_clamp'][0]:.3f} ms, plain {plain_ms:.3f} / "
          f"{times['no_clamp'][1]:.3f} ms (clamped / no_clamp)", flush=True)
    return {"name": "block_accumulate", "route": "cuda",
            "source": "noetic_slam_tpu_torch/csrc/tsdf_accum.cu",
            "replaces": "noetic_slam_tpu/ops/pallas/tsdf_kernel.py:51",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _profile(run, lo: int, hi: int) -> None:
    """torch.profiler over scans [lo, hi): wall and device-busy time per
    scan, stream syncs, the kernels that take the device time, and each
    step stage (the ``record_function`` ranges of models/odometry.py):
    host time in it, device time of the kernels it launched, and its span
    on the device timeline (gaps included). The profiler slows the host
    side; take rates from the unprofiled window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stage_prefix = ("odometry.", "tsdf.")
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
    print(f"[profile] {n} scans: wall {wall_us / n / 1e3:.2f} ms/scan, device "
          f"busy {busy / n / 1e3:.2f} ms/scan ({100 * busy / wall_us:.1f}%); "
          f"per scan: {sum(e.count for e in kernels) / n:.0f} kernels, "
          f"cudaStreamSynchronize "
          f"{calls.get('cudaStreamSynchronize', 0) / n:.1f}, "
          f"cudaMemcpyAsync {calls.get('cudaMemcpyAsync', 0) / n:.1f}",
          flush=True)
    for e in kernels[:10]:
        print(f"[profile]   {dev_us(e) / n / 1e3:8.3f} ms/scan "
              f"{e.count / n:7.1f} calls/scan  {e.key[:90]}", flush=True)
    stages = {}
    for e in evs:
        if e.key.startswith(stage_prefix):
            stages.setdefault(e.key, {})[e.device_type] = e
    for key in sorted(stages, key=lambda k: -stages[k][DeviceType.CPU]
                      .cpu_time_total):
        host = stages[key][DeviceType.CPU]
        span = stages[key].get(DeviceType.CUDA)
        print(f"[profile]   stage {key:<26} host "
              f"{host.cpu_time_total / n / 1e3:7.3f} ms, device work "
              f"{host.device_time_total / n / 1e3:6.3f} ms, device span "
              f"{(span.device_time_total if span else 0.0) / n / 1e3:7.3f} "
              f"ms per scan", flush=True)


def phase_main_path(dev, n_scans: int, n_profile: int = 0):
    import torch

    from noetic_slam_tpu_torch.config import (
        CapacityConfig,
        DlioConfig,
        KeyframeConfig,
    )
    from noetic_slam_tpu_torch.ops.cuda import nn_kernel, tsdf_kernel
    from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
    from noetic_slam_tpu_torch.utils import synthetic

    cfg = DlioConfig(
        capacity=CapacityConfig(
            max_points=32768, max_ds_points=8192, max_deskew_frames=2048,
            max_imu_window=128, max_keyframes=128, max_submap_kf=32),
        adaptive=False, keyframe=KeyframeConfig(thresh_dist=0.5))
    t0 = time.perf_counter()
    total = n_scans + n_profile
    sim = synthetic.make_sim(duration=total / 10.0 + 0.3, n_points=32768,
                             calib_time=3.1, seed=7)
    scans = [sim.scan(i) for i in range(min(total, len(sim.scan_stamps)))]
    gen_s = time.perf_counter() - t0

    pipe = OdometryPipeline(cfg, device=dev, with_tsdf=True)
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

    nn_kernel.nn1_fused.launches = 0
    tsdf_kernel.block_accumulate.launches = 0
    torch.cuda.reset_peak_memory_stats()
    warm = min(10, len(scans) // 3)
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
    n_timed = n_scans - warm
    syncs1 = pipe.host_syncs
    ev_ms = start.elapsed_time(end)
    launches = {"nn1_fused": nn_kernel.nn1_fused.launches,
                "block_accumulate": tsdf_kernel.block_accumulate.launches}
    peak = torch.cuda.max_memory_allocated()
    if n_profile:
        _profile(run, n_scans, len(scans))

    traj = pipe.flush()
    _check(len(traj) == len(scans), f"main path: {len(traj)} of "
           f"{len(scans)} scans processed")
    _check(bool(np.isfinite(traj).all()), "main path: non-finite pose")
    ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                             sim.gt_pos)
    overflow = pipe.submap_overflow
    blocks = int(pipe.tsdf_state.num_blocks)
    _check(launches["nn1_fused"] > 0, "main path: kernel A never launched")
    _check(launches["block_accumulate"] > 0,
           "main path: kernel B never launched")
    _check(overflow == 0, f"main path: submap_overflow {overflow}")
    _check(blocks > 0, "main path: empty TSDF")
    _check(bool(torch.isfinite(pipe.tsdf_state.weight).all()),
           "main path: non-finite TSDF weight")
    _check(ate < 0.05, f"main path: ATE {ate:.4f} m >= 0.05 m")
    print(f"[5 main path] {len(scans)} scans x 32768 points (sim {gen_s:.1f}"
          f" s): steady {n_timed} scans in {ev_ms:.1f} ms CUDA events = "
          f"{1e3 * n_timed / ev_ms:.2f} scans/s (wall {n_timed / wall:.2f} "
          f"scans/s); host_syncs/scan "
          f"{(syncs1 - syncs0) / n_timed:.2f}; peak memory "
          f"{peak / 2**30:.3f} GiB; ATE {ate:.4f} m; tsdf blocks {blocks}, "
          f"dropped {int(pipe.tsdf_state.dropped)}; submap_overflow "
          f"{overflow}; launches {launches}", flush=True)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=60,
                    help="synthetic scans on the main path (default 60)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the timed window, run N more scans under "
                         "torch.profiler and print where the device time "
                         "goes")
    args = ap.parse_args(argv)

    dev, gpu_line = phase_device()
    import torch

    phase_build()
    kernels = [phase_nn(dev), phase_tsdf(dev)]
    launches = phase_main_path(dev, args.scans, args.profile)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms",
                                 "plain_ms")} for k in kernels]}))
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
