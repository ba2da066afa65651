"""Benchmark of the port: odometry scans/sec on one card (synthetic replay).

    python -m noetic_slam_tpu_torch.bench [--device cpu] [--mulran DIR]

The port of root ``bench.py``: the same sections, configurations, seeds,
window sizes and environment knobs, run through ``noetic_slam_tpu_torch``
on the card (``--device`` left unset; without a card it raises). Prints
ONE JSON line with root ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``extras``), then a ``#`` line on stderr.

``vs_baseline`` IS A REAL-TIME FACTOR: the reference runs online at the
LiDAR sensor rate, 10 Hz, so vs_baseline = scans_per_sec / 10
(``extras.vs_baseline_semantics``).

Sections (each rate from the slope between windows of fresh scans, each
window ending in a host read of state that depends on its work, which on
the card waits for the work):
- ``value``: the K = 8 micro-batched replay (``process_scans``) at the
  production capacities, the median of three pairwise slopes;
- ``extras.tsdf_integrations_per_sec``: TSDF fusion of scans staged on the
  device;
- ``extras.online_*``: K = 1 submission, with p50/p95 per-scan latency
  including a dependent pose fetch;
- ``extras.slam_fused_scans_per_sec``: odometry + TSDF fusion per scan;
- ``extras.slam_system_*``: the whole ``SlamSystem`` (sync, archive,
  descriptors, closures), wall clock over a steady stretch;
- ``extras.roofline``: kernel A at 8,192 x 65,536 and the TSDF traffic
  floor against the card's f32 and HBM peaks (``runtime.profiling``);
- ``extras.ate_rmse_m_mulran_fixture``: the MulRan fixture through the
  real readers and replay loop.

``extras`` also names the run: ``backend`` (``torch-cuda`` or
``torch-cpu``), ``device`` (the card's name), ``power_limit_w`` (from
nvidia-smi, null where unreadable) and ``host_syncs_per_scan`` (each
section's ``host_syncs`` over its timed scans).

Env knobs: BENCH_TINY=1 (small capacities for a CPU smoke run),
BENCH_SCANS=N (default 180), BENCH_BATCH=K (default 8),
BENCH_SKIP_{ONLINE,SLAM,SYSTEM,ROOFLINE}=1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

DEFAULT_MULRAN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "fixtures", "mulran_mini")


def power_limit_w(dev: torch.device):
    """The card's power limit [W] from nvidia-smi; None off the card or
    where nvidia-smi cannot say."""
    if dev.type != "cuda":
        return None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(device=None, mulran: str | None = DEFAULT_MULRAN) -> dict:
    """Run the benchmark on ``device`` (None: the card) and print its JSON
    line; returns the printed object. ``mulran``: the MulRan fixture for
    the ATE (skipped when it is not a directory)."""
    from noetic_slam_tpu_torch import resolve_device
    from noetic_slam_tpu_torch.config import (
        CapacityConfig,
        DlioConfig,
        KeyframeConfig,
    )
    from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
    from noetic_slam_tpu_torch.utils import synthetic

    dev = resolve_device(device)
    tiny = os.environ.get("BENCH_TINY") == "1"
    n_scans = int(os.environ.get("BENCH_SCANS", "20" if tiny else "180"))

    if tiny:
        cap = CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=32, max_submap_kf=8)
        n_pts = 2048
    else:
        # Production capacities: OS1-64-class scans (~65k raw points,
        # ~8k after 0.25 m voxel downsample). max_submap_kf=32 holds the
        # full reference-equivalent selection (knn+kcv+kcc = 30 distinct
        # keyframes at most); submap_overflow is reported below.
        cap = CapacityConfig(
            max_points=32768, max_ds_points=8192, max_deskew_frames=2048,
            max_imu_window=128, max_keyframes=128, max_submap_kf=32)
        n_pts = 32768
    # Fixed 0.5 m keyframe spacing: the submap reaches its full
    # max_submap_kf occupancy within the warm-up, so the steady state timed
    # carries a production-shaped registration target.
    cfg = DlioConfig(capacity=cap, adaptive=False,
                     keyframe=KeyframeConfig(thresh_dist=0.5))

    dur = n_scans / 10.0 + 0.3
    sim = synthetic.make_sim(duration=dur, n_points=n_pts, calib_time=3.1,
                             seed=7)
    # all scans made first (host-side data preparation is not timed)
    scans = [sim.scan(i) for i in range(min(n_scans, len(sim.scan_stamps)))]

    pipe = OdometryPipeline(cfg, device=dev)
    imu_i = 0

    def feed_imu(through):
        nonlocal imu_i
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= through):
            pipe.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1

    # Each window ends in a host read of state that depends on every scan
    # it ran (on the card, the read waits for the work), and the rate is
    # the slope between windows, so the read's fixed cost cancels.
    K = min(int(os.environ.get("BENCH_BATCH", "8")), max(1, len(scans) // 16))

    def run_window(lo, hi):
        # micro-batched submission (one process_scans call per K scans)
        for b0 in range(lo, hi, K):
            chunk = scans[b0: min(b0 + K, hi)]
            feed_imu(max(h + pt.max() for h, _, pt in chunk) + 0.02)
            pipe.process_scans([(h, xyz, pt) for h, xyz, pt in chunk])
        return float(torch.sum(pipe.state.lidar_p))   # dependent fetch

    # Whole K-multiples; the untimed first window takes the kernels' first
    # load and the bootstrap scan. Three consecutive windows (a < b < c)
    # give three pairwise slopes whose median survives one stall inside
    # one window.
    w0 = 2 * K
    rem = (len(scans) - w0) // K * K
    a = max(K, rem // 6 // K * K)
    b, c = 2 * a, 3 * a
    run_window(0, w0)                    # first load + bootstrap
    syncs0 = pipe.host_syncs
    t0 = time.perf_counter()
    run_window(w0, w0 + a)
    t1 = time.perf_counter()
    run_window(w0 + a, w0 + a + b)
    t2 = time.perf_counter()
    run_window(w0 + a + b, w0 + a + b + c)
    t3 = time.perf_counter()
    Ta, Tb, Tc = t1 - t0, t2 - t1, t3 - t2
    n_timed = a + b + c
    syncs = {"odometry_k8": (pipe.host_syncs - syncs0) / n_timed}
    slopes = [(Tb - Ta) / (b - a), (Tc - Tb) / (c - b),
              (Tc - Ta) / (c - a)]
    print(f"# k8 windows s: {Ta:.2f}/{a} {Tb:.2f}/{b} {Tc:.2f}/{c} "
          f"slopes ms: {[round(s * 1e3, 2) for s in slopes]}",
          file=sys.stderr)
    ms_per_scan = sorted(slopes)[1] * 1e3
    scans_per_sec = 1e3 / ms_per_scan

    traj = pipe.flush()
    ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                             sim.gt_pos)

    # TSDF fusion throughput (odometry output stream -> map), measured
    # separately on the same scans (slope method again), on scans staged
    # on the device: the timed quantity is the device integration rate.
    from noetic_slam_tpu_torch.models import tsdf as tsdf_mod

    tcfg = cfg.tsdf
    base_dev = [torch.as_tensor(scans[i][1][: cap.max_points],
                                dtype=torch.float32, device=dev)
                for i in range(min(len(scans), 17))]
    ones_dev = torch.ones((base_dev[0].shape[0],), dtype=torch.bool,
                          device=dev)
    origin = torch.zeros(3, device=dev)

    def run_tsdf(st, lo, hi):
        for i in range(lo, hi):
            # a per-call offset keeps every scan's data fresh
            pts = base_dev[i % len(base_dev)] + np.float32(0.001 * i)
            st = tsdf_mod.integrate(tcfg, st, pts, ones_dev, origin)
        # a payload-dependent read over the whole payload (num_blocks alone
        # does not depend on the voxel update)
        return st, float(torch.sum(st.weight[:, 0]))

    tstate = tsdf_mod.init_tsdf(tcfg, dev)
    tstate, _ = run_tsdf(tstate, 0, 2)
    t0 = time.perf_counter()
    tstate, _ = run_tsdf(tstate, 2, 7)
    t1 = time.perf_counter()
    tstate, _ = run_tsdf(tstate, 7, 17)
    t2 = time.perf_counter()
    tsdf_per_sec = 1.0 / max(((t2 - t1) - (t1 - t0)) / 5, 1e-9)

    # ---- Online (K=1) operating point + per-scan latency percentiles ----
    # The reference runs online at the sensor rate (odom.cc:1966-1971): one
    # submission per scan. The rate comes from the slope method; latency
    # percentiles include a dependent per-scan pose fetch (what a live
    # consumer experiences end to end).
    online = {}
    if os.environ.get("BENCH_SKIP_ONLINE") != "1":
        n_on = 24 if tiny else 96
        sim2 = synthetic.make_sim(duration=n_on / 10.0 + 0.4,
                                  n_points=n_pts, calib_time=3.1, seed=11)
        scans2 = [sim2.scan(i)
                  for i in range(min(n_on, len(sim2.scan_stamps)))]
        pipe2 = OdometryPipeline(cfg, device=dev)
        imu_j = 0

        def feed2(through):
            nonlocal imu_j
            while (imu_j < len(sim2.imu_stamps)
                   and sim2.imu_stamps[imu_j] <= through):
                pipe2.push_imu(sim2.imu_stamps[imu_j], sim2.imu_ang[imu_j],
                               sim2.imu_acc[imu_j])
                imu_j += 1

        feed2(1e9)

        def run_k1(lo, hi):
            for i in range(lo, hi):
                h, xyz, pt = scans2[i]
                pipe2.process_scan(h, xyz, pt)
            return float(torch.sum(pipe2.state.lidar_p))

        ow0 = min(6, len(scans2) // 4)
        a1 = max(2, (len(scans2) - ow0) // 5)
        a2 = min(2 * a1, len(scans2) - ow0 - a1 - 8)
        run_k1(0, ow0)                      # first load + bootstrap
        syncs2 = pipe2.host_syncs
        t0 = time.perf_counter()
        run_k1(ow0, ow0 + a1)
        t1 = time.perf_counter()
        run_k1(ow0 + a1, ow0 + a1 + a2)
        t2 = time.perf_counter()
        syncs["online_k1"] = (pipe2.host_syncs - syncs2) / (a1 + a2)
        k1_ms = ((t2 - t1) - (t1 - t0)) / max(a2 - a1, 1) * 1e3
        lat = []
        for i in range(ow0 + a1 + a2, len(scans2)):
            h, xyz, pt = scans2[i]
            t0 = time.perf_counter()
            out = pipe2.process_scan(h, xyz, pt)
            float(torch.sum(out.lidar_p))   # dependent per-scan fetch
            lat.append(time.perf_counter() - t0)
        lat_a = np.asarray(lat[1:]) if len(lat) > 1 else np.asarray(lat)
        online = {
            "online_scans_per_sec_k1": round(1e3 / max(k1_ms, 1e-9), 2),
            "online_latency_ms_p50": round(
                float(np.percentile(lat_a, 50)) * 1e3, 2),
            "online_latency_ms_p95": round(
                float(np.percentile(lat_a, 95)) * 1e3, 2),
            "online_latency_includes_fetch": True,
        }

    # ---- Fused odometry+TSDF (make_slam_step): the `cli slam` rate ----
    slam_fused = {}
    if os.environ.get("BENCH_SKIP_SLAM") != "1":
        pipe3 = OdometryPipeline(cfg, device=dev, with_tsdf=True)
        imu_k = 0

        def feed3(through):
            nonlocal imu_k
            while (imu_k < len(sim.imu_stamps)
                   and sim.imu_stamps[imu_k] <= through):
                pipe3.push_imu(sim.imu_stamps[imu_k], sim.imu_ang[imu_k],
                               sim.imu_acc[imu_k])
                imu_k += 1

        def run_fused(lo, hi):
            for b0 in range(lo, hi, K):
                chunk = scans[b0: min(b0 + K, hi)]
                feed3(max(h + pt.max() for h, _, pt in chunk) + 0.02)
                pipe3.process_scans([(h, xyz, pt) for h, xyz, pt in chunk])
            return (float(torch.sum(pipe3.state.lidar_p))
                    + float(torch.sum(pipe3.tsdf_state.weight[:, 0])))

        fw0 = 2 * K
        fn1 = max(K, (len(scans) - fw0) // 4 // K * K)
        fn2 = max(K, min(3 * fn1, (len(scans) - fw0 - fn1) // K * K))
        run_fused(0, fw0)                   # first load + bootstrap
        syncs3 = pipe3.host_syncs
        t0 = time.perf_counter()
        run_fused(fw0, fw0 + fn1)
        t1 = time.perf_counter()
        run_fused(fw0 + fn1, fw0 + fn1 + fn2)
        t2 = time.perf_counter()
        syncs["slam_fused"] = (pipe3.host_syncs - syncs3) / (fn1 + fn2)
        fused_ms = ((t2 - t1) - (t1 - t0)) / (fn2 - fn1) * 1e3
        slam_fused = {"slam_fused_scans_per_sec": round(
            1e3 / max(fused_ms, 1e-9), 2)}

    # ---- Whole-system rate: SlamSystem end to end ----
    # The number `cli slam` sustains: the fused step plus per-batch
    # keyframe sync (outbox drain), archive fusion, descriptor extraction
    # and matching, and loop-closure attempts; overall wall over a steady
    # multi-lap stretch, closures firing.
    slam_system = {}
    if os.environ.get("BENCH_SKIP_SYSTEM") != "1":
        from noetic_slam_tpu_torch.config import TsdfConfig
        from noetic_slam_tpu_torch.runtime.slam import SlamSystem
        from noetic_slam_tpu_torch.utils.synthetic import spiral_pose_of

        n_sys = 48 if tiny else 240
        cap4 = CapacityConfig(
            max_points=2048 if tiny else 8192,
            max_ds_points=1024 if tiny else 4096,
            max_deskew_frames=512 if tiny else 1024,
            max_imu_window=64 if tiny else 128,
            max_keyframes=32 if tiny else 128,
            max_submap_kf=8 if tiny else 16, max_trajectory=4096)
        cfg4 = DlioConfig(
            capacity=cap4, adaptive=False,
            keyframe=KeyframeConfig(thresh_dist=0.5, thresh_rot=45.0),
            tsdf=TsdfConfig(voxel_size=0.2, truncation=0.6,
                            max_blocks=4096 if tiny else 16384,
                            space_carving=False,
                            scan_block_cap=1024 if tiny else 2048))
        sim4 = synthetic.make_sim(
            duration=n_sys / 10.0 + 0.4, n_points=cap4.max_points,
            calib_time=3.1, seed=23, pose_fn=spiral_pose_of,
            imu_noise=0.0005)
        scans4 = [sim4.scan(i)
                  for i in range(min(n_sys, len(sim4.scan_stamps)))]
        slam4 = SlamSystem(cfg4, enable_tsdf=True, enable_loop_closure=True,
                           loop_radius=4.0, loop_min_gap=15, pipelined=True,
                           device=dev)
        imu_m = 0

        def feed4(through):
            nonlocal imu_m
            while (imu_m < len(sim4.imu_stamps)
                   and sim4.imu_stamps[imu_m] <= through):
                slam4.push_imu(sim4.imu_stamps[imu_m], sim4.imu_ang[imu_m],
                               sim4.imu_acc[imu_m])
                imu_m += 1

        def run_system(lo, hi):
            for b0 in range(lo, hi, K):
                chunk = scans4[b0: min(b0 + K, hi)]
                feed4(max(h + pt.max() for h, _, pt in chunk) + 0.02)
                slam4.process_scans([(h, xyz, pt) for h, xyz, pt in chunk])
                # sync rides maybe_close_loop's pipelined drain (a 3-batch
                # cadence, ~16 new keyframes, inside the 32-slot outbox)
                if b0 % (3 * K) == 0 and b0 > 0:
                    slam4.maybe_close_loop()
            return float(torch.sum(slam4.odometry.state.lidar_p))

        sw0 = 4 * K
        slam4.warmup()                      # the closure stack's first loads
        run_system(0, sw0)                  # first load + bootstrap
        syncs4 = slam4.host_syncs
        t0 = time.perf_counter()
        run_system(sw0, len(scans4))
        t1 = time.perf_counter()
        syncs["slam_system"] = ((slam4.host_syncs - syncs4)
                                / (len(scans4) - sw0))
        slam_system = {
            "slam_system_scans_per_sec": round(
                (len(scans4) - sw0) / (t1 - t0), 2),
            "slam_system_includes":
                "fused step + sync + archive + descriptors + closures",
            "slam_system_closures": slam4.loop_closures,
            "slam_system_lost_keyframes": slam4.sync_lost_keyframes,
            "slam_system_raced_attempts": slam4.loop_raced,
        }

    # ---- In-run roofline lines against the card's peaks ----
    roofline = {}
    if os.environ.get("BENCH_SKIP_ROOFLINE") != "1" and not tiny:
        roofline = _roofline(dev, cap, tcfg, tsdf_per_sec,
                             int(tstate.num_blocks))

    # Real-ingest ATE on the committed MulRan-format fixture (through the
    # MulRan reader and the replay loop).
    mulran_ate = None
    if mulran and os.path.isdir(mulran) and not tiny:
        from noetic_slam_tpu_torch.io.mulran import MulranDataset
        from noetic_slam_tpu_torch.io.replay import replay_dataset

        ds = MulranDataset.load(mulran)
        mp = OdometryPipeline(DlioConfig(capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=128,
            max_imu_window=64, max_keyframes=64, max_submap_kf=32,
            max_trajectory=512)), device=dev)
        replay_dataset(ds, mp, rate=0.0, batch=8)
        mtraj = mp.flush()
        mulran_ate = synthetic.ate_rmse(mtraj[:, 0], mtraj[:, 1:4],
                                        ds.gt_stamps, ds.gt_poses[:, :, 3])

    backend = f"torch-{dev.type}"
    result = {
        "metric": "odometry_scans_per_sec_1chip",
        "value": round(scans_per_sec, 3),
        "unit": "scans/s",
        "vs_baseline": round(scans_per_sec / 10.0, 3),
        "extras": {
            "vs_baseline_semantics":
                "realtime_factor_vs_10hz_sensor_rate (driver.launch:15-21)",
            "tsdf_integrations_per_sec": round(tsdf_per_sec, 1),
            "ate_rmse_m_synthetic": round(ate, 4),
            "ate_rmse_m_mulran_fixture": (None if mulran_ate is None
                                          else round(mulran_ate, 4)),
            "submap_overflow": pipe.submap_overflow,
            **online,
            **slam_fused,
            **slam_system,
            **({"roofline": roofline} if roofline else {}),
            "backend": backend,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else dev.type),
            "power_limit_w": power_limit_w(dev),
            "host_syncs_per_scan": {k: round(v, 3)
                                    for k, v in syncs.items()},
        },
    }
    print(json.dumps(result), flush=True)
    print(f"# ate_rmse_m={ate:.4f} n_timed={n_timed} "
          f"keyframes={int(pipe.state.kf_count)} "
          f"submap_overflow={pipe.submap_overflow} "
          f"tsdf_integrations_per_sec={tsdf_per_sec:.1f} "
          f"online={online} slam_fused={slam_fused} "
          f"slam_system={slam_system} "
          f"backend={backend}", file=sys.stderr, flush=True)
    return result


def _roofline(dev, cap, tcfg, tsdf_per_sec: float, n_blocks: int) -> dict:
    """Kernel A at 8,192 queries x 65,536 targets (capped at 0.5 m) through
    ``neighbors.nn1``, and the TSDF fusion's traffic floor, against the
    card's peaks: operations against the f32 CUDA-core peak (the port's
    kernels run in f32), bytes against HBM."""
    from noetic_slam_tpu_torch.ops import neighbors
    from noetic_slam_tpu_torch.ops.pointcloud import morton_sort_key
    from noetic_slam_tpu_torch.runtime.profiling import (
        chip_peaks,
        slope_timer,
    )

    peaks, chip = chip_peaks()
    rngr = np.random.default_rng(0)
    n_t, n_q = 65536, 8192
    planes = rngr.integers(0, 6, n_t)
    tpts = rngr.uniform(-30, 30, (n_t, 3)).astype(np.float32)
    for ax in range(3):
        tpts[planes == ax, ax] = -30.0
        tpts[planes == ax + 3, ax] = 30.0
    t_all = torch.as_tensor(tpts, device=dev)
    mk = morton_sort_key(t_all, torch.ones(n_t, dtype=torch.bool,
                                           device=dev), 1.0)
    order = np.argsort(mk.cpu().numpy(), kind="stable")
    tgt = t_all[torch.as_tensor(order, device=dev)].contiguous()
    cap_d = torch.tensor(0.5, device=dev)

    def f_nn(c):
        q = tgt[:n_q] + c * 1e-4 + 0.02
        idx, sqd = neighbors.nn1(q, tgt, n_t, max_dist=cap_d)
        return c + torch.sum(sqd) * 1e-12 + idx[0] * 1e-12

    def run_nn(k):
        y = torch.zeros((), device=dev)
        for i in range(k):
            y = f_nn(y + np.float32(i) * np.float32(1e-6))
        return float(y)

    # long windows + median of 3: a call (~0.03 ms on the card) is far
    # below the host's jitter
    nn_sec = sorted(slope_timer(run_nn, n1=8, n2=32) for _ in range(3))[1]
    nn_gflops = 8.0 * n_q * n_t / nn_sec / 1e9

    # TSDF integrate basis: lower-bound traffic = 1R+1W of the 4-stream
    # sample payload + the touched rows
    n_band = int(round(2.0 * tcfg.truncation / tcfg.voxel_size)) + 1
    S_samp = cap.max_points * (n_band + (tcfg.carving_samples
                                         if tcfg.space_carving else 0))
    tsdf_ms = 1e3 / max(tsdf_per_sec, 1e-9)
    tsdf_bytes = 2 * S_samp * 16 + n_blocks * 512 * 4 * 2 * 2
    tsdf_gbps = tsdf_bytes / (tsdf_ms * 1e-3) / 1e9

    def pct(x, i, scale=1.0):
        return round(x / (peaks[i] * scale) * 100, 2) if peaks else None

    return {
        "chip": chip,
        "peak_bf16_tflops": peaks[0] if peaks else None,
        "peak_hbm_gbps": peaks[1] if peaks else None,
        "peak_f32_tflops": peaks[2] if peaks else None,
        "nn1_capped_8192x65536_ms": round(nn_sec * 1e3, 3),
        "nn1_dense_equiv_gflops": round(nn_gflops, 1),
        "nn1_pct_mxu_peak": pct(nn_gflops, 0, 1e3),
        "nn1_pct_f32_peak": pct(nn_gflops, 2, 1e3),
        "nn1_flops_basis": "dense-equivalent (kernel prunes; floor); "
                           "mxu = bf16 tensor-core peak, the kernel runs "
                           "f32 on the CUDA cores",
        "tsdf_integrate_ms": round(tsdf_ms, 3),
        "tsdf_lower_bound_gbps": round(tsdf_gbps, 1),
        "tsdf_pct_hbm_peak": pct(tsdf_gbps, 1),
        "tsdf_bytes_basis": "1R+1W sample streams + touched rows (floor)",
    }


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--mulran", default=DEFAULT_MULRAN,
                    help="MulRan fixture for the ATE (default: "
                         "tests/fixtures/mulran_mini beside the package)")
    args = ap.parse_args(argv)
    main(device=args.device, mulran=args.mulran)
    return 0


if __name__ == "__main__":
    sys.exit(_main())
