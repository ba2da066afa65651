"""Long-soak SLAM run of the port (counterpart of ``scripts/soak.py``).

Drives ``SlamSystem`` (odometry + fused dense map + pose graph + loop
closure + keyframe archive) through >= SOAK_SCANS scans of a repeated-loop
trajectory and writes one JSON record of the long-run properties:

- keyframe eviction active (kf_total >> resident capacity);
- pose-graph growth past the initial node capacity, optimizer on the CG
  path (> 192 nodes);
- >= 3 loop closures applied, each corrected incrementally through the
  keyframe archive (closure cost = O(moved keyframes), logged per
  closure);
- post-closure map coverage monotone (allocated archive blocks never
  shrink);
- sustained scans/s over successive windows (no degradation);
- one mid-run checkpoint + resume with a bitwise-identical odometry
  continuation.

On the card:   python -m noetic_slam_tpu_torch.harness.soak   (~2000 scans)
On the CPU:    SOAK_TINY=1 python -m noetic_slam_tpu_torch.harness.soak \\
                   --device cpu
Knobs: SOAK_TINY, SOAK_SCANS, SOAK_BATCH (default 8), SOAK_OUT (default
build/harness/soak.json), SOAK_TRAJ (default beside SOAK_OUT). The
checkpoint of the resume check goes in a temporary directory of its own.

Added to the script's keys: ``device``, ``power_limit_w``,
``kernel_launches`` (A and B over the run after ``warmup()``),
``warmup_kernel_launches`` (those of ``warmup()``), ``peak_memory_gib``,
and per window ``host_syncs`` and ``peak_memory_gib``.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from noetic_slam_tpu_torch.harness import (
    Window,
    ate_profile,
    device_extras,
    launches,
    launches_since,
    output_path,
    parse_device,
)


def build_cfg(tiny: bool):
    from noetic_slam_tpu_torch.config import (
        CapacityConfig,
        DlioConfig,
        GicpConfig,
        KeyframeConfig,
        TsdfConfig,
    )

    if tiny:
        cap = CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=24, max_submap_kf=8,
            max_trajectory=4096)
        tsdf = TsdfConfig(voxel_size=0.25, truncation=0.75, max_blocks=4096,
                          space_carving=False, scan_block_cap=1024)
    else:
        cap = CapacityConfig(
            max_points=8192, max_ds_points=4096, max_deskew_frames=1024,
            max_imu_window=128, max_keyframes=128, max_submap_kf=16,
            max_trajectory=16384)
        tsdf = TsdfConfig(voxel_size=0.2, truncation=0.6, max_blocks=16384,
                          space_carving=False, scan_block_cap=2048)
    # full GICP solver budget: the soak proves long-run correctness at the
    # production operating point, not under an artificially starved solver
    return DlioConfig(capacity=cap, adaptive=False,
                      keyframe=KeyframeConfig(thresh_dist=0.5,
                                              thresh_rot=45.0),
                      gicp=GicpConfig(),
                      tsdf=tsdf)


def _host(state) -> dict:
    """Host copies of every tensor field of an ``OdomState`` (one fetch)."""
    from noetic_slam_tpu_torch.utils.host import PendingFetch

    return {k: torch.from_numpy(v) for k, v in PendingFetch(
        {f: x for f, x in state._asdict().items() if x is not None}
    ).wait().items()}


def _closure_stages(table: dict) -> dict:
    """The entries of a span table that are the closure path's stages
    (``runtime/slam.py``: names without a layer prefix), which do not
    overlap; the step's spans nest in the scans and in the stages."""
    return {k: v for k, v in table.items() if "." not in k}


def run(dev, tiny: bool, n_scans: int, K: int, out_path: str,
        traj_path: str, graph: tuple | None = None) -> tuple[dict, bool]:
    """The soak on ``dev``; writes ``out_path`` and ``traj_path`` and
    returns (the result, the pass verdict). ``graph``: the pose graph's
    initial (nodes, edges), default (16, 16) tiny and (256, 512) full."""
    from noetic_slam_tpu_torch.models import posegraph as pg
    from noetic_slam_tpu_torch.runtime import compile_cache
    from noetic_slam_tpu_torch.runtime.profiling import RECORDER
    from noetic_slam_tpu_torch.runtime.slam import SlamSystem
    from noetic_slam_tpu_torch.utils import synthetic
    from noetic_slam_tpu_torch.utils.synthetic import (
        loop_pose_of,
        spiral_pose_of,
    )

    cfg = build_cfg(tiny)
    # 10 Hz scans: the odometry's designed operating point (the prior is
    # accurate over 0.1 s). Tiny mode shrinks the lap (period/radius), not
    # the rate, so one CI run still covers a full loop + closure.
    scan_hz = 10.0
    # Tiny: one small closed lap. Full: an expanding spiral of laps — a
    # repeated identical circle stops creating keyframes after lap 1
    # (revisits inside thresh_dist), which starves eviction/growth; the
    # spiral keeps covering new ground at ~0.6 m/lap offset while each lap
    # stays in closure range of the previous one.
    pose_fn = (functools.partial(loop_pose_of, period=12.0, radius=5.0)
               if tiny else spiral_pose_of)
    dur = n_scans / scan_hz + 0.4
    n_pts = 2048 if tiny else 8192
    print(f"soak: {n_scans} scans, {dur:.0f} s sim, backend=torch-"
          f"{dev.type}", file=sys.stderr)
    sim = synthetic.make_sim(duration=dur, scan_hz=scan_hz, n_points=n_pts,
                             calib_time=3.1, seed=17, pose_fn=pose_fn,
                             imu_noise=0.0005)

    # The kernels' build directory: warm (an existing library is loaded)
    # unless NOETIC_SLAM_NO_CACHE=1 (a cold build into a fresh directory).
    cache_dir = compile_cache.enable()

    # pipelined=True: the real-time sync protocol. Tiny mode applies every
    # verified closure (floor 0): its healthy lap drifts only mm, and the
    # CI twin must exercise the apply/archive path, not just the gates.
    slam = SlamSystem(cfg, enable_tsdf=True, enable_loop_closure=True,
                      loop_radius=4.0, loop_min_gap=15, pipelined=True,
                      min_closure_correction=0.0 if tiny else None,
                      device=dev)
    # start below the expected keyframe total so that growth past
    # saturation is exercised (~1200 keyframes over the full run)
    nodes, edges = graph or ((16, 16) if tiny else (256, 512))
    slam.graph = pg.init_graph(nodes, edges, device=slam.device)
    slam.max_graph_nodes = nodes

    imu_i = 0

    def feed(sys_, through):
        nonlocal imu_i
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= through):
            sys_.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1

    # Closure attempts every 2 batches: attempting often catches drift
    # while corrections are still small.
    closure_every = 10 if tiny else 2 * K
    cooldown = 20 if tiny else 30
    ckpt_at = (n_scans * 3) // 5 // K * K
    cmp_scans = 2 * K                     # bitwise continuation window
    ckpt_dir = tempfile.TemporaryDirectory(prefix="soak_ckpt_")
    ckpt_path = os.path.join(ckpt_dir.name, "soak_ckpt.nst.npz")

    window = max(4 * K, (40 if tiny else 200) // K * K)
    windows = []
    blocks_log = []                       # archive volume blocks per closure
    last_closure_scan = -10**9
    resume_ok = None
    resume_diff = []

    def fetch_sync(sys_):
        return float(torch.sum(sys_.odometry.state.lidar_p))

    def submit(sys_, lo, hi, closures=True):
        nonlocal last_closure_scan
        for b0 in range(lo, hi, K):
            chunk = [scans[i] for i in range(b0, min(b0 + K, hi))]
            feed(sys_, max(h + pt.max() for h, _, pt in chunk) + 0.02)
            sys_.process_scans([(h, x, p) for h, x, p in chunk])
            if closures and (b0 // K) % 2 == 1:
                # pipelined sync every 2nd batch, unconditionally: the
                # sync cadence must not ride the closure-attempt cadence
                # (cooldowns stacked with attempt gaps let the un-drained
                # span exceed the outbox ring: lost keyframes)
                sys_.sync_pipelined()
            if closures and (b0 - last_closure_scan >= cooldown) \
                    and (b0 % closure_every < K):
                if sys_.maybe_close_loop():
                    last_closure_scan = b0
                    blocks_log.append({
                        "scan": b0,
                        "archive_blocks": int(
                            sys_.archive.volume.num_blocks),
                        **sys_.closure_log[-1]})

    scans = []
    t_gen = time.perf_counter()
    for i in range(min(n_scans, len(sim.scan_stamps))):
        scans.append(sim.scan(i))
    print(f"scan gen: {time.perf_counter() - t_gen:.1f} s", file=sys.stderr)
    n_scans = len(scans)

    launches0 = launches()
    t_warm = time.perf_counter()
    slam.warmup()        # the kernel library's build or load, the step's
                         # first use, cuBLAS and cuSOLVER up front (not
                         # mid-run)
    warmup_s = time.perf_counter() - t_warm
    print(f"warmup: {warmup_s:.1f} s", file=sys.stderr)
    warmup_launches = launches_since(launches0)
    launches0 = launches()

    RECORDER.enable()       # stage table = post-warmup steady state

    t_start = time.perf_counter()
    done = 0
    while done < n_scans:
        hi = min(done + window, n_scans)
        snap0 = RECORDER.snapshot()
        n_clo0, cap0 = len(slam.closure_log), slam.graph.node_q.shape[0]
        win = Window(dev, slam)
        t0 = time.perf_counter()
        submit(slam, done, hi)
        fetch_sync(slam)
        t1 = time.perf_counter()
        # per-window attribution: stage deltas + event markers
        w = {"scans": hi - done,
             "scans_per_sec": round((hi - done) / (t1 - t0), 2),
             "stages": _closure_stages(
                 RECORDER.delta(snap0, RECORDER.snapshot())),
             "closures": len(slam.closure_log) - n_clo0,
             **win.extras()}
        if slam.graph.node_q.shape[0] != cap0:
            w["graph_grew"] = [cap0, slam.graph.node_q.shape[0]]
        if not windows:
            w["note"] = ("first window absorbs the first use of each op "
                         "and library handle")
        windows.append(w)
        done = hi

        if ckpt_at and done >= ckpt_at and resume_ok is None:
            # ---- checkpoint + bitwise-resume check ----
            slam.flush()
            slam.save(ckpt_path)
            slam2 = SlamSystem(cfg, enable_tsdf=True,
                               enable_loop_closure=True,
                               loop_radius=4.0, loop_min_gap=15, device=dev)
            slam2.load(ckpt_path)
            end = min(done + cmp_scans, n_scans)
            # run both for the comparison window (no closures: archive
            # replay reconstructs the volume to ulp, not bitwise; the
            # odometry state itself restores exactly)
            imu_i0 = imu_i
            submit(slam, done, end, closures=False)
            imu_saved = imu_i
            imu_i = imu_i0            # re-feed the same IMU span to slam2
            RECORDER.on = False       # slam2 stays out of the stage tables
            submit(slam2, done, end, closures=False)
            RECORDER.on = True        # (paused: enable() would restart)
            imu_i = imu_saved
            a, b = _host(slam.odometry.state), _host(slam2.odometry.state)
            diffs = [f for f in slam.odometry.state._fields
                     if (f in a) != (f in b)
                     or (f in a and not torch.equal(a[f], b[f]))]
            resume_ok = not diffs
            resume_diff = [
                {"field": f, "max_abs_diff": float(
                    (a[f].double() - b[f].double()).abs().max())}
                for f in diffs if f in a and f in b
                and a[f].shape == b[f].shape and a[f].numel()]
            print(f"resume bitwise: {resume_ok} (diff fields: {diffs})",
                  file=sys.stderr)
            del slam2
            done = end
    ckpt_dir.cleanup()

    wall = time.perf_counter() - t_start
    slam.sync_graph()        # exact final drain (pipelined leaves a tail)

    # label every slow window (< 0.5x median) with its dominant cause
    rates = [w["scans_per_sec"] for w in windows[1:]] or \
            [w["scans_per_sec"] for w in windows]
    med_rate = float(np.median(rates))
    for i, w in enumerate(windows):
        if w["scans_per_sec"] >= 0.5 * med_rate:
            continue
        causes = []
        if i == 0:
            causes.append("first use of each op")
        if w.get("graph_grew"):
            causes.append(f"graph growth {w['graph_grew']}")
        if w.get("closures"):
            causes.append(f"{w['closures']} closures applied")
        st_d = w.get("stages", {})
        if st_d:
            top = max(st_d, key=lambda k: st_d[k]["total_s"])
            causes.append(f"top stage {top} {st_d[top]['total_s']}s")
        w["slow_cause"] = "; ".join(causes) or "unattributed"

    traj = slam.flush()
    ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                             sim.gt_pos)

    # ---- descriptor place-recognition recall/precision vs ground truth --
    # Node n <-> n-th keyframe in trajectory order (hand-off is lossless:
    # sync_lost_keyframes == 0 is required below). A query is a positive
    # when a >= min_gap-older keyframe truly lies within 3 m (gt); a hit
    # when the returned candidate is truly within 5 m at score >= thresh.
    gt_of = lambda t: np.stack(  # noqa: E731
        [np.interp(t, sim.gt_stamps, sim.gt_pos[:, k]) for k in range(3)],
        -1)
    kf_stamps = np.asarray([e.stamp for e in slam.odometry.trajectory
                            if e.is_keyframe])
    node_gt = gt_of(kf_stamps)
    positives = hits = matches = true_matches = 0
    min_gap = 15
    for qrec in slam.desc_log:
        n, cand, score = qrec["node"], qrec["cand"], qrec["score"]
        if n >= len(node_gt):
            continue
        old = node_gt[: max(n - min_gap + 1, 0)]
        is_pos = len(old) and (np.linalg.norm(
            old - node_gt[n], axis=-1).min() < 3.0)
        matched = (cand >= 0 and score >= slam.desc_min_score
                   and cand < len(node_gt))
        is_true = matched and (np.linalg.norm(
            node_gt[cand] - node_gt[n]) < 5.0)
        positives += bool(is_pos)
        hits += bool(is_pos and is_true)
        matches += bool(matched)
        true_matches += bool(is_true)
    # ROC sweep over the logged best-candidate scores: the recall /
    # precision each threshold would yield on this run
    labeled = []
    for qrec in slam.desc_log:
        n, cand, score = qrec["node"], qrec["cand"], qrec["score"]
        if n >= len(node_gt) or cand < 0 or cand >= len(node_gt):
            continue
        old = node_gt[: max(n - min_gap + 1, 0)]
        is_pos = len(old) and (np.linalg.norm(
            old - node_gt[n], axis=-1).min() < 3.0)
        is_true = np.linalg.norm(node_gt[cand] - node_gt[n]) < 5.0
        labeled.append((score, bool(is_pos), bool(is_true)))
    roc = {}
    for t in (0.45, 0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8):
        n_pos_t = sum(1 for _, p, _ in labeled if p)
        rec_t = (sum(1 for s, p, tr in labeled if p and tr and s >= t)
                 / n_pos_t) if n_pos_t else None
        n_m = sum(1 for s, _, _ in labeled if s >= t)
        prec_t = (sum(1 for s, _, tr in labeled if s >= t and tr)
                  / n_m) if n_m else None
        roc[str(t)] = [None if rec_t is None else round(rec_t, 3),
                       None if prec_t is None else round(prec_t, 3)]
    desc_stats = {
        "descriptor_queries": len(slam.desc_log),
        "descriptor_positives": positives,
        "descriptor_recall": round(hits / positives, 3) if positives
        else None,
        "descriptor_precision": round(true_matches / matches, 3) if matches
        else None,
        "descriptor_score_roc": roc,
        "descriptor_min_score": slam.desc_min_score,
    }
    ate_prof = ate_profile(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                           sim.gt_pos)
    np.savez(traj_path, traj=traj, gt_stamps=sim.gt_stamps,
             gt_pos=sim.gt_pos)
    st = slam.odometry.state
    from noetic_slam_tpu_torch.utils.host import PendingFetch

    h = PendingFetch({"reg_rejected": st.reg_rejected,
                      "kf_total": st.kf_total,
                      "n_nodes": slam.graph.n_nodes,
                      "n_edges": slam.graph.n_edges}).wait()
    kf_total, n_nodes = int(h["kf_total"]), int(h["n_nodes"])
    surf = slam.surface_points(min_weight=0.5)
    span = (surf[:, :2].max(0) - surf[:, :2].min(0)).tolist() if len(surf) \
        else [0.0, 0.0]

    steady = [w["scans_per_sec"] for w in windows[1:]] or \
             [w["scans_per_sec"] for w in windows]
    archive_blocks = [b["archive_blocks"] for b in blocks_log]
    closure_secs = sorted(c["seconds"] for c in blocks_log) or [0.0]
    closure_p95 = closure_secs[min(int(0.95 * len(closure_secs)),
                                   len(closure_secs) - 1)]
    peaks = [w["peak_memory_gib"] for w in windows
             if w["peak_memory_gib"] is not None]
    stages = _closure_stages(RECORDER.stage_table())
    RECORDER.disable()
    result = {
        "artifact": "long-soak SLAM run "
                    "(noetic_slam_tpu_torch.harness.soak)",
        "backend": f"torch-{dev.type}",
        "scans": n_scans,
        "wall_seconds": round(wall, 1),
        "warmup_seconds": round(warmup_s, 1),
        "compile_cache_dir": cache_dir,
        "loop_raced": slam.loop_raced,
        "scans_per_sec_overall": round(n_scans / wall, 2),
        # steady state = median window after the first
        "scans_per_sec_steady": round(float(np.median(steady)), 2),
        "windows": windows,
        # Degradation = the trend: median of the second-half windows vs
        # median of the first half (robust to single-window spikes)
        "sustained_no_degradation": bool(
            float(np.median(steady[len(steady) // 2:]))
            >= 0.7 * float(np.median(steady[: len(steady) // 2])))
        if len(steady) >= 4 else (bool(steady[-1] >= 0.7 * max(steady))
                                  if steady else None),
        "reg_rejected": int(h["reg_rejected"]),
        "kf_total": kf_total,
        "kf_resident_capacity": cfg.capacity.max_keyframes,
        "eviction_active": bool(kf_total > cfg.capacity.max_keyframes),
        "graph_nodes": n_nodes,
        "graph_node_capacity": slam.graph.node_q.shape[0],
        "graph_edges": int(h["n_edges"]),
        "cg_path": n_nodes > 192,
        "loop_closures_applied": slam.loop_closures,
        "loop_closures_descriptor": slam.loop_closures_descriptor,
        "loop_rejected_budget": slam.loop_rejected_budget,
        "loop_skipped_small": slam.loop_skipped_small,
        "closure_log": blocks_log,
        "closure_seconds_p95": round(closure_p95, 3),
        "archived_keyframes": len(slam.archive) if slam.archive else 0,
        "sync_lost_keyframes": slam.sync_lost_keyframes,
        "kf_total_minus_graph_nodes": kf_total - n_nodes,
        **desc_stats,
        "stage_table": {
            k: {"calls": v["calls"], "total_s": round(v["total_s"], 2),
                "mean_ms": round(1e3 * v["total_s"] / v["calls"], 1)}
            for k, v in sorted(stages.items(),
                               key=lambda kv: -kv[1]["total_s"])},
        "archive_blocks_monotone": bool(
            all(b2 >= b1 for b1, b2 in zip(archive_blocks,
                                           archive_blocks[1:]))),
        "checkpoint_resume_bitwise": resume_ok,
        "checkpoint_resume_diff": resume_diff,
        "ate_rmse_m": round(ate, 4),
        "ate_profile_deciles": ate_prof,
        "surface_points": int(len(surf)),
        "surface_span_xy_m": [round(s, 1) for s in span],
        **device_extras(dev),
        "kernel_launches": launches_since(launches0),
        "warmup_kernel_launches": warmup_launches,
        "peak_memory_gib": max(peaks) if peaks else None,
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("windows", "closure_log")}, indent=1))
    ok = bool(result["eviction_active"]
              and result["graph_nodes"] > (16 if tiny else 192)
              and result["loop_closures_applied"] >= (1 if tiny else 3)
              and result["checkpoint_resume_bitwise"]
              and result["archive_blocks_monotone"]
              and result["sync_lost_keyframes"] == 0)
    print(f"SOAK {'OK' if ok else 'FAILED'}", file=sys.stderr)
    return result, ok


def main(argv=None) -> int:
    dev = parse_device(argv, __doc__)
    tiny = os.environ.get("SOAK_TINY") == "1"
    n_scans = int(os.environ.get("SOAK_SCANS", "150" if tiny else "2000"))
    out_path = output_path("SOAK_OUT", "soak.json")
    traj_path = os.environ.get(
        "SOAK_TRAJ", os.path.splitext(out_path)[0] + "_traj.npz")
    K = int(os.environ.get("SOAK_BATCH", "8"))
    _, ok = run(dev, tiny, n_scans, K, out_path, traj_path)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
