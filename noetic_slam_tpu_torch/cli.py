"""Command-line interface of the PyTorch/CUDA port (port of
``noetic_slam_tpu.cli``): the replacement for the reference's launch and
shell orchestration (scripts/dlio-launch.sh, roslaunch XML).

Subcommands:
  slam     Run the full SLAM system (``SlamSystem``) over a MulRan
           directory, a ROS1 bag, an Ouster capture or a synthetic
           sequence, writing the trajectory (TUM), the sparse map (PCD),
           the dense map (PLY) and, on request, the mesh, an ESDF region,
           a checkpoint and renders.
  batch    Several sequences (MulRan directories and synthetic ones) in
           lockstep through the multi-sequence odometry
           (``runtime.multi``), one TUM trajectory each, with a batch
           checkpoint and resume.
  live     SLAM on a live Ouster sensor: UDP packets into ``SlamSystem``
           (``runtime.live``), with IMU-rate pose output.
  player   Interactive MulRan player (pause, speed, loop, seek) feeding
           ``SlamSystem``.
  export   Write a MulRan sequence's ground truth and radar images to a
           rosbag (the file player's SaveRosbag).
  eval     ATE of a TUM trajectory against ground truth.
  info     Print the config and torch's device inventory.
  bench    The synthetic benchmark (``noetic_slam_tpu_torch.bench``, the
           port of root bench.py): one JSON line.

Every subcommand that computes runs on the card unless ``--device`` names
another device (``--device cpu``); without a card and without
``--device`` it raises.

Examples:
  python -m noetic_slam_tpu_torch.cli slam --mulran /data/KAIST03 --out out/
  python -m noetic_slam_tpu_torch.cli slam --pcap cap.pcap --metadata m.json
  python -m noetic_slam_tpu_torch.cli slam --synthetic 10 --device cpu
  python -m noetic_slam_tpu_torch.cli batch --mulran A --mulran B --synthetic 2
  python -m noetic_slam_tpu_torch.cli live --metadata m.json --duration 60
  python -m noetic_slam_tpu_torch.cli player --mulran /data/KAIST03 --out out/
  python -m noetic_slam_tpu_torch.cli info
  BENCH_TINY=1 python -m noetic_slam_tpu_torch.cli bench --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def cmd_info(args) -> int:
    import torch

    from noetic_slam_tpu_torch import resolve_device
    from noetic_slam_tpu_torch.config.params import load_config

    cfg = load_config(args.config)
    dev = resolve_device(args.device)
    print("backend:", dev.type)
    print("devices:", [torch.cuda.get_device_name(i)
                       for i in range(torch.cuda.device_count())]
          if dev.type == "cuda" else [str(dev)])
    print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
    return 0


def cmd_slam(args) -> int:
    import numpy as np

    from noetic_slam_tpu_torch.config.params import load_config
    from noetic_slam_tpu_torch.io.export import write_ply, write_tum_trajectory
    from noetic_slam_tpu_torch.io.replay import replay_dataset
    from noetic_slam_tpu_torch.models.mapping import KeyframeMap
    from noetic_slam_tpu_torch.runtime.metrics import SlamMetrics
    from noetic_slam_tpu_torch.runtime.slam import SlamSystem

    cfg = load_config(args.config)
    if args.map_backend:
        cfg = cfg.replace(map_backend=args.map_backend)
    os.makedirs(args.out, exist_ok=True)
    slam = SlamSystem(cfg, enable_tsdf=not args.no_tsdf,
                      enable_loop_closure=not args.no_loop_closure,
                      pipelined=not args.exact_sync, device=args.device)
    if args.warmup:
        # load the kernels' library and the closure path's solvers before
        # ingest, so that none loads mid-run (SlamSystem.warmup)
        print("warmup: loading the closure stack...", file=sys.stderr)
        t_w = time.perf_counter()
        slam.warmup()
        print(f"warmup: {time.perf_counter() - t_w:.1f} s", file=sys.stderr)
    metrics = SlamMetrics()

    t0 = time.perf_counter()
    if args.bag:
        from noetic_slam_tpu_torch.io.rosbag import replay_bag

        stats = replay_bag(args.bag, slam, pointcloud_topic=args.pcl_topic,
                           imu_topic=args.imu_topic,
                           max_scans=args.max_scans)
        print("bag replay:", stats)
        gt = None
    elif args.pcap:
        # Ouster capture replay: packets -> ScanBatcher -> XYZ LUT ->
        # odometry (the OusterReplay nodelet role, os_replay_nodelet.cpp)
        from noetic_slam_tpu_torch.io import ouster as ou
        from noetic_slam_tpu_torch.io.pcap import replay_pcap_scans
        from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu

        if not args.metadata:
            raise SystemExit("slam --pcap requires --metadata JSON")
        with open(args.metadata) as f:
            info = ou.SensorInfo.from_json(f.read())
        direction, offset = ou.make_xyz_lut(info)
        n_scans = 0
        pending = None

        def do_scan(scan):
            nonlocal n_scans
            xyz, rel_t, valid, scan_ts = ou.scan_to_points(
                scan, direction, offset)
            xyz = np.where(valid[:, None], xyz, np.float32(np.nan))
            slam.process_scan(scan_ts * 1e-9, xyz,
                              rel_t.astype(np.float64))
            n_scans += 1
            if args.loop_every and n_scans % args.loop_every == 0:
                slam.maybe_close_loop()

        for ev in replay_pcap_scans(args.pcap, info):
            if ev[0] == "imu":
                _, ts_ns, accel, gyro = ev
                slam.push_imu(ts_ns * 1e-9, gyro, accel)
                if pending is not None:
                    try:
                        do_scan(pending)
                        pending = None
                    except NeedMoreImu:
                        pass
            else:
                if not slam.calibrated:
                    continue
                try:
                    do_scan(ev[2])
                except NeedMoreImu:
                    pending = ev[2]
            if args.max_scans and n_scans >= args.max_scans:
                break
        print(f"pcap replay: {n_scans} scans")
        gt = None
    elif args.mulran:
        from noetic_slam_tpu_torch.io.mulran import MulranDataset

        ds = MulranDataset.load(args.mulran)
        print(f"loaded MulRan: {len(ds.scan_stamps)} scans, "
              f"{len(ds.imu_stamps)} imu samples (v{ds.imu_version})")

        def on_scan(idx, out):
            metrics.scan_done(float(ds.scan_stamps[idx]),
                              time.perf_counter() - t0, [0, 0, 0], False)
            if idx % args.loop_every == 0 and idx > 0:
                slam.maybe_close_loop()
            if args.progress and idx % 50 == 0:
                print(f"scan {idx}", file=sys.stderr)

        if args.batch > 1:
            def on_batch(n):
                slam.maybe_close_loop()
                if args.progress:
                    print(f"scan {n}", file=sys.stderr)

            stats = replay_dataset(ds, slam, rate=0.0,
                                   max_scans=args.max_scans,
                                   batch=args.batch, on_batch=on_batch)
        else:
            stats = replay_dataset(ds, slam, rate=args.rate,
                                   max_scans=args.max_scans, on_scan=on_scan)
        print("replay:", stats)
        gt = (np.column_stack([ds.gt_stamps, ds.gt_poses[:, :, 3]])
              if ds.gt_stamps is not None else None)
    else:
        from noetic_slam_tpu_torch.utils import synthetic

        sim = synthetic.make_sim(duration=float(args.synthetic),
                                 calib_time=3.1, n_points=4096, seed=11)
        imu_i = 0
        for s in range(len(sim.scan_stamps)):
            header, xyz, pt = sim.scan(s)
            sweep_end = header + pt.max()
            while (imu_i < len(sim.imu_stamps)
                   and sim.imu_stamps[imu_i] <= sweep_end + 0.02):
                slam.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                              sim.imu_acc[imu_i])
                imu_i += 1
            slam.process_scan(header, xyz, pt)
            if s % args.loop_every == 0 and s > 0:
                slam.maybe_close_loop()
        gt = np.column_stack([sim.gt_stamps, sim.gt_pos])

    overflow = slam.odometry.submap_overflow
    if overflow:
        print(f"WARNING: {overflow} selected submap keyframes dropped "
              "(capacity.max_submap_kf too small for submap.knn+kcv+kcc)",
              file=sys.stderr)

    if slam.enable_loop_closure:
        n_arch = len(slam.archive) if slam.archive is not None else 0
        print(f"loop closure: {slam.loop_closures} applied "
              f"({slam.loop_closures_descriptor} via descriptors), "
              f"{slam.loop_rejected_budget} budget-rejected; "
              f"{n_arch} keyframes archived, "
              f"graph {int(slam.graph.n_nodes)} nodes / "
              f"{int(slam.graph.n_edges)} edges")

    traj = slam.flush()
    if len(traj):
        write_tum_trajectory(os.path.join(args.out, "trajectory.tum"), traj)
        print(f"trajectory: {len(traj)} poses -> trajectory.tum")
        if gt is not None:
            from noetic_slam_tpu_torch.utils.synthetic import ate_rmse

            ate = ate_rmse(traj[:, 0], traj[:, 1:4], gt[:, 0], gt[:, 1:4])
            print(f"ATE RMSE vs ground truth: {ate:.4f} m")

    km = KeyframeMap(leaf_size=cfg.map.sparse_leaf_size)
    km.update(slam.odometry.state)
    if km.save_pcd(cfg.map.sparse_leaf_size, args.out):
        print(f"sparse map: {len(km.cloud())} pts -> dlio_map.pcd")

    if slam.tsdf is not None:
        surf = slam.surface_points()
        name = ("occupied.ply" if cfg.map_backend == "occupancy"
                else "tsdf_surface.ply")
        if len(surf):
            write_ply(os.path.join(args.out, name), surf)
            print(f"{cfg.map_backend} map: {len(surf)} pts -> {name}")
        if args.mesh and cfg.map_backend == "tsdf":
            from noetic_slam_tpu_torch.io.export import write_ply_mesh
            from noetic_slam_tpu_torch.io.meshing import extract_mesh

            verts, faces = extract_mesh(cfg.tsdf, slam.tsdf)
            if len(faces):
                write_ply_mesh(os.path.join(args.out, "tsdf_mesh.ply"),
                               verts, faces)
                print(f"tsdf mesh: {len(verts)} verts / {len(faces)} tris "
                      "-> tsdf_mesh.ply")

    if args.esdf and slam.tsdf is not None:
        # a dense ESDF region around the final pose (npz) and a
        # mid-height slice rendering, computed on the map's device
        import torch

        from noetic_slam_tpu_torch.io import viz as vz
        from noetic_slam_tpu_torch.models import esdf as esdf_mod

        shape = (96, 96, 24)
        mcfg = (cfg.occupancy if cfg.map_backend == "occupancy"
                else cfg.tsdf)
        v = mcfg.voxel_size
        center = (traj[-1, 1:4] if len(traj) else np.zeros(3))
        lo = center - 0.5 * v * np.asarray(shape)
        fn = (esdf_mod.esdf_region_occupancy
              if cfg.map_backend == "occupancy" else esdf_mod.esdf_region)
        field, observed, _ = fn(
            mcfg, slam.tsdf,
            torch.as_tensor(lo, dtype=torch.float32, device=slam.device),
            shape=shape, max_dist=3.0)
        field, observed = field.cpu().numpy(), observed.cpu().numpy()
        np.savez_compressed(os.path.join(args.out, "esdf.npz"),
                            esdf=field, observed=observed, origin=lo,
                            voxel_size=v)
        z = shape[2] // 2
        sl = field[:, :, z]
        img = np.zeros(sl.shape + (3,), np.uint8)
        pos = np.clip(sl / 3.0, 0, 1)
        neg = np.clip(-sl / 1.0, 0, 1)
        img[..., 1] = (pos * 255).astype(np.uint8)          # green: free
        img[..., 0] = (neg * 255).astype(np.uint8)          # red: inside
        img[~observed[:, :, z]] = (40, 40, 120)             # blue: unknown
        vz.write_png(os.path.join(args.out, "esdf_slice.png"), img)
        print(f"esdf: {int(observed.sum())} observed voxels -> "
              "esdf.npz, esdf_slice.png")

    if args.checkpoint:
        slam.save(os.path.join(args.out, "state.nst.npz"))
        print("checkpoint -> state.nst.npz")

    if args.viz:
        from noetic_slam_tpu_torch.io import viz as vz

        if len(traj):
            vz.write_png(os.path.join(args.out, "trajectory.png"),
                         vz.render_trajectory(traj[:, 1:4]))
        cloud = (slam.surface_points() if slam.tsdf is not None
                 else km.cloud())
        if len(cloud):
            vz.write_png(os.path.join(args.out, "map_views.png"),
                         vz.render_views(cloud))
            vz.write_html_viewer(os.path.join(args.out, "map_viewer.html"),
                                 cloud)
            print("viz -> trajectory.png, map_views.png, map_viewer.html")

    print(json.dumps(metrics.summary()))
    return 0


def cmd_live(args) -> int:
    """Live Ouster sensor mode (os_driver + odometry in one process)."""
    from noetic_slam_tpu_torch.config.params import load_config
    from noetic_slam_tpu_torch.io.ouster import SensorInfo
    from noetic_slam_tpu_torch.runtime.live import LiveDriver
    from noetic_slam_tpu_torch.runtime.slam import SlamSystem

    cfg = load_config(args.config)
    with open(args.metadata) as f:
        info = SensorInfo.from_json(f.read())
    slam = SlamSystem(cfg, enable_tsdf=not args.no_tsdf, pipelined=True,
                      device=args.device)
    highrate = []
    if args.pose_rate > 0:
        # IMU-rate pose output (the reference publishes odom/pose at
        # ~100 Hz from its IMU callback + timer, odom.cc:315-488): the
        # host extrapolator serves pose queries between scans from the
        # buffered IMU samples (runtime/poseext.py) with no device
        # traffic. Collected here; a live consumer would query
        # slam.pose_at(t) directly.
        slam.enable_pose_extrapolation()
    drv = LiveDriver(slam, info, lidar_port=args.lidar_port,
                     imu_port=args.imu_port,
                     timestamp_mode=args.timestamp_mode)
    print(f"listening on udp {args.lidar_port}/{args.imu_port} "
          f"({info.pixels_per_column}x{info.columns_per_frame})")
    try:
        if args.pose_rate > 0:
            period = 1.0 / args.pose_rate
            next_q = None
            t0 = time.monotonic()
            while (args.duration is None
                   or time.monotonic() - t0 < args.duration):
                drv.poll_once()
                ex = slam.extrapolator
                if ex is not None and ex.seed_stamp is not None:
                    if next_q is None:
                        next_q = ex.seed_stamp
                    # serve every due stamp up to the newest IMU sample
                    horizon = (slam.odometry._imu_stamps[-1]
                               if len(slam.odometry._imu_stamps) else None)
                    while horizon is not None and next_q <= horizon:
                        q, p = slam.pose_at(next_q)
                        highrate.append((next_q, *p, *q))
                        next_q += period
        else:
            drv.run(duration_s=args.duration)
    except KeyboardInterrupt:
        pass
    finally:
        # the ring's drop count is read before the source closes (the JAX
        # CLI reads it after, through a freed handle)
        dropped = drv.source.lidar_dropped if drv.source else 0
        drv.close()
    if highrate:
        import numpy as np

        from noetic_slam_tpu_torch.io.export import write_tum_trajectory

        out = args.pose_out or "pose_highrate.tum"
        write_tum_trajectory(out, np.asarray(highrate))
        print(f"high-rate pose: {len(highrate)} samples @ "
              f"{args.pose_rate:.0f} Hz -> {out}")
    print(f"scans={drv.n_scans} imu={drv.n_imu} dropped={dropped}")
    return 0


def cmd_player(args) -> int:
    """Interactive MulRan player (the reference Qt GUI's role,
    mainwindow.cpp:6-206): keyboard pause/speed/loop/seek while the SLAM
    pipeline consumes the stream."""
    from noetic_slam_tpu_torch.config.params import load_config
    from noetic_slam_tpu_torch.io.mulran import MulranDataset
    from noetic_slam_tpu_torch.io.player import InteractivePlayer
    from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu
    from noetic_slam_tpu_torch.runtime.slam import SlamSystem

    cfg = load_config(args.config)
    ds = MulranDataset.load(args.mulran)
    slam = SlamSystem(cfg, enable_tsdf=not args.no_tsdf, device=args.device)
    pending = {"scan": None}

    def on_event(stamp, kind, idx):
        if kind == "imu":
            slam.push_imu(ds.imu_stamps[idx], ds.imu_gyro[idx],
                          ds.imu_accel[idx])
            if pending["scan"] is not None:
                try:
                    s, i = pending["scan"]
                    slam.process_scan(s, ds.read_scan(i)[:, :3])
                    pending["scan"] = None
                except NeedMoreImu:
                    pass
        elif kind == "scan" and slam.odometry.calibrated:
            try:
                slam.process_scan(stamp, ds.read_scan(idx)[:, :3])
            except NeedMoreImu:
                pending["scan"] = (stamp, idx)

    def on_seek(stamp):
        pending["scan"] = None
        print(f"\nseek -> t={stamp:.3f} (odometry continues from its "
              "current state, as with the reference player)",
              file=sys.stderr)

    player = InteractivePlayer(
        ds, on_event, rate=args.rate, loop=args.loop, on_seek=on_seek,
        skip_stop_region=(tuple(args.skip_region)
                          if args.skip_region else None),
        keyboard=True, status=True)
    stats = player.run(max_events=args.max_events)
    print(json.dumps(stats))
    if args.out:
        from noetic_slam_tpu_torch.io.export import write_tum_trajectory

        traj = slam.flush()
        if len(traj):
            os.makedirs(args.out, exist_ok=True)
            write_tum_trajectory(os.path.join(args.out, "trajectory.tum"),
                                 traj)
            print(f"trajectory: {len(traj)} poses -> trajectory.tum")
    return 0


def cmd_eval(args) -> int:
    """ATE evaluation: TUM trajectory vs ground truth (TUM or MulRan
    global_pose.csv)."""
    import numpy as np

    from noetic_slam_tpu_torch.utils.synthetic import ate_rmse

    traj = np.loadtxt(args.trajectory)      # stamp x y z qx qy qz qw
    if args.gt.endswith(".csv"):
        rows = np.loadtxt(args.gt, delimiter=",", ndmin=2)
        gt_stamps = rows[:, 0] * 1e-9
        gt_pos = rows[:, 1:].reshape(-1, 3, 4)[:, :, 3]
    else:
        gt = np.loadtxt(args.gt)
        gt_stamps, gt_pos = gt[:, 0], gt[:, 1:4]
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], gt_stamps, gt_pos)
    print(json.dumps({"ate_rmse_m": round(ate, 4),
                      "n_poses": len(traj),
                      "duration_s": round(traj[-1, 0] - traj[0, 0], 2)}))
    return 0


def cmd_export(args) -> int:
    """SaveRosbag parity (file player ROSThread.cpp:704-784): ground truth
    + radar polar images -> rosbag."""
    from noetic_slam_tpu_torch.io.export import export_mulran_bag
    from noetic_slam_tpu_torch.io.mulran import MulranDataset

    ds = MulranDataset.load(args.mulran)
    stats = export_mulran_bag(ds, args.bag, radar=not args.no_radar,
                              compression=args.compression)
    print(json.dumps(stats))
    return 0


def cmd_batch(args) -> int:
    """Multi-sequence odometry: B sequences advance in lockstep, one step
    each per round (runtime/multi), sequence i on the i-th contiguous
    block of ``--devices`` cards. The reference runs one bag per process
    tree (roslaunch); here N bags are one program."""
    import numpy as np
    import torch

    from noetic_slam_tpu_torch import resolve_device
    from noetic_slam_tpu_torch.config.params import load_config
    from noetic_slam_tpu_torch.io.export import write_tum_trajectory
    from noetic_slam_tpu_torch.runtime.multi import (
        ArrayFeed,
        MultiSequencePipeline,
        run_lockstep,
    )
    from noetic_slam_tpu_torch.utils.synthetic import ate_rmse

    cfg = load_config(args.config)
    os.makedirs(args.out, exist_ok=True)
    feeds, names, gts = [], [], []
    for d in args.mulran or []:
        from noetic_slam_tpu_torch.io.mulran import MulranDataset

        ds = MulranDataset.load(d)
        feeds.append(ArrayFeed.from_dataset(ds, max_scans=args.max_scans))
        base = os.path.basename(os.path.normpath(d)) or "seq"
        names.append(f"{len(names):02d}_{base}")
        gts.append(None if ds.gt_stamps is None else np.column_stack(
            [ds.gt_stamps, ds.gt_poses[:, :, 3]]))
    for k in range(args.synthetic):
        from noetic_slam_tpu_torch.utils import synthetic

        sim = synthetic.make_sim(duration=args.duration, calib_time=3.1,
                                 n_points=4096, seed=100 + k)
        scans = [sim.scan(i) for i in range(len(sim.scan_stamps))]
        feeds.append(ArrayFeed(sim.imu_stamps, sim.imu_ang, sim.imu_acc,
                               sim.scan_stamps,
                               lambda i, sc=scans: sc[i],
                               max_scans=args.max_scans))
        names.append(f"{len(names):02d}_synthetic")
        gts.append(np.column_stack([sim.gt_stamps, sim.gt_pos]))

    B = len(feeds)
    if B == 0:
        print("no sequences given (--mulran and/or --synthetic)",
              file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    D = args.devices or n_dev
    if D > n_dev:
        print(f"--devices {D} > {n_dev} available; clamping to {n_dev}",
              file=sys.stderr)
        D = n_dev
    while B % D:
        D -= 1                      # most devices dividing B
    devices = ([dev] if D == 1
               else [torch.device(dev.type, i) for i in range(D)])
    print(f"batch: {B} sequences over {D} device(s)")

    t0 = time.perf_counter()
    mp = MultiSequencePipeline(cfg, n_seq=B, devices=devices)
    if args.resume:
        mp.load(args.resume, feeds)
        print(f"resumed from {args.resume} at round {mp.rounds}")
    trajs = run_lockstep(mp, feeds,
                         rounds_per_dispatch=args.rounds_per_dispatch)
    wall = time.perf_counter() - t0
    if args.checkpoint:
        ck = os.path.join(args.out, "batch_state.nst.npz")
        mp.save(ck, feeds)
        print(f"checkpoint -> {ck}")

    per_seq = []
    total = 0
    for name, traj, gt in zip(names, trajs, gts):
        entry = {"name": name, "n_poses": int(len(traj))}
        if len(traj):
            write_tum_trajectory(
                os.path.join(args.out, f"{name}.tum"), traj)
            if gt is not None:
                entry["ate_rmse_m"] = round(float(ate_rmse(
                    traj[:, 0], traj[:, 1:4], gt[:, 0], gt[:, 1:4])), 4)
        total += entry["n_poses"]
        per_seq.append(entry)
    print(json.dumps({"sequences": per_seq, "devices": D,
                      "rounds": mp.rounds, "total_poses": total,
                      "wall_s": round(wall, 2),
                      "scans_per_sec": round(total / max(wall, 1e-9), 2)}))
    return 0


def cmd_bench(args) -> int:
    from noetic_slam_tpu_torch import bench

    bench.main(device=args.device)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="noetic_slam_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = ("torch device to run on (default: the card; raises "
                   "without one)")

    ps = sub.add_parser("slam", help="run SLAM over a dataset")
    ps.add_argument("--mulran", help="MulRan sequence directory")
    ps.add_argument("--bag", help="ROS1 bag file")
    ps.add_argument("--pcap", help="Ouster UDP capture (pcap/pcapng)")
    ps.add_argument("--metadata", help="sensor metadata JSON (with --pcap)")
    ps.add_argument("--pcl-topic", default=None,
                    help="PointCloud2 topic (default: auto by type)")
    ps.add_argument("--imu-topic", default=None)
    ps.add_argument("--synthetic", default=None,
                    help="simulate N seconds instead of a dataset")
    ps.add_argument("--out", default="out", help="output directory")
    ps.add_argument("--config", default=None, help="YAML config overrides")
    ps.add_argument("--rate", type=float, default=0.0,
                    help="replay pacing (0 = as fast as possible)")
    ps.add_argument("--max-scans", type=int, default=None)
    ps.add_argument("--loop-every", type=int, default=20,
                    help="attempt loop closure every N scans")
    ps.add_argument("--no-tsdf", action="store_true",
                    help="disable the dense map backend entirely")
    ps.add_argument("--map-backend", default=None,
                    choices=["tsdf", "occupancy"],
                    help="dense map backend (default: config, tsdf)")
    ps.add_argument("--mesh", action="store_true",
                    help="extract a surface-nets mesh from the TSDF")
    ps.add_argument("--no-loop-closure", action="store_true")
    ps.add_argument("--warmup", action="store_true",
                    help="load the closure stack before ingest (real-time "
                         "runs: nothing loads mid-run)")
    ps.add_argument("--exact-sync", action="store_true",
                    help="disable the pipelined (one-cadence-stale) "
                         "keyframe sync: every closure attempt blocks on "
                         "a fresh device fetch first")
    ps.add_argument("--checkpoint", action="store_true")
    ps.add_argument("--esdf", action="store_true",
                    help="write a dense ESDF region around the final pose "
                         "(esdf.npz + esdf_slice.png)")
    ps.add_argument("--progress", action="store_true")
    ps.add_argument("--viz", action="store_true",
                    help="render trajectory/map PNGs + HTML orbit viewer")
    ps.add_argument("--batch", type=int, default=1,
                    help="micro-batch size for scan submission (offline "
                         "throughput mode; requires --rate 0)")
    ps.add_argument("--device", default=None, help=device_help)
    ps.set_defaults(fn=cmd_slam)

    pbt = sub.add_parser(
        "batch", help="multi-sequence SLAM: N bags in lockstep as one "
                      "program over the cards")
    pbt.add_argument("--mulran", action="append", default=[],
                     help="MulRan sequence directory (repeatable)")
    pbt.add_argument("--synthetic", type=int, default=0,
                     help="add N synthetic sequences")
    pbt.add_argument("--duration", type=float, default=10.0,
                     help="synthetic sequence duration [s]")
    pbt.add_argument("--config", default=None)
    pbt.add_argument("--out", default="out_batch")
    pbt.add_argument("--max-scans", type=int, default=None)
    pbt.add_argument("--devices", type=int, default=0,
                     help="cards to spread the sequences over (0 = all; "
                          "rounded down to a divisor of the sequence "
                          "count; 1 with --device cpu)")
    pbt.add_argument("--rounds-per-dispatch", type=int, default=1,
                     help="lockstep rounds packed and uploaded at a time "
                          "(offline throughput mode)")
    pbt.add_argument("--checkpoint", action="store_true",
                     help="write batch_state.nst.npz (all sequences + feed "
                          "cursors) at the end")
    pbt.add_argument("--resume", default=None,
                     help="resume a multi-bag run from a batch checkpoint "
                          "(TUM outputs then cover the post-resume part)")
    pbt.add_argument("--device", default=None, help=device_help)
    pbt.set_defaults(fn=cmd_batch)

    px = sub.add_parser("export", help="export a MulRan sequence's ground "
                                       "truth + radar images to a rosbag "
                                       "(the file player's SaveRosbag)")
    px.add_argument("--mulran", required=True)
    px.add_argument("--bag", required=True)
    px.add_argument("--no-radar", action="store_true")
    px.add_argument("--compression", default="none",
                    choices=["none", "bz2", "lz4"])
    px.set_defaults(fn=cmd_export)

    pi = sub.add_parser("info", help="print config + devices")
    pi.add_argument("--config", default=None)
    pi.add_argument("--device", default=None, help=device_help)
    pi.set_defaults(fn=cmd_info)

    pl = sub.add_parser("live", help="live Ouster sensor SLAM")
    pl.add_argument("--metadata", required=True,
                    help="sensor metadata JSON file")
    pl.add_argument("--lidar-port", type=int, default=7502)
    pl.add_argument("--imu-port", type=int, default=7503)
    pl.add_argument("--timestamp-mode", default="sensor",
                    choices=["sensor", "host"])
    pl.add_argument("--duration", type=float, default=None)
    pl.add_argument("--config", default=None)
    pl.add_argument("--no-tsdf", action="store_true")
    pl.add_argument("--pose-rate", type=float, default=100.0,
                    help="IMU-rate pose output frequency [Hz] (host "
                         "extrapolator between scans; 0 = off). The "
                         "reference's 100 Hz publishPose role "
                         "(odom.cc:315-488)")
    pl.add_argument("--pose-out", default=None,
                    help="high-rate pose TUM output path")
    pl.add_argument("--device", default=None, help=device_help)
    pl.set_defaults(fn=cmd_live)

    pp = sub.add_parser("player", help="interactive dataset player "
                                       "(space/+/-/l/0-9/q)")
    pp.add_argument("--mulran", required=True)
    pp.add_argument("--rate", type=float, default=1.0,
                    help="initial playback rate (1 = real time)")
    pp.add_argument("--loop", action="store_true")
    pp.add_argument("--skip-region", nargs=2, type=float, default=None,
                    metavar=("T0", "T1"))
    pp.add_argument("--max-events", type=int, default=None)
    pp.add_argument("--out", default=None,
                    help="write trajectory.tum here on exit")
    pp.add_argument("--config", default=None)
    pp.add_argument("--no-tsdf", action="store_true")
    pp.add_argument("--device", default=None, help=device_help)
    pp.set_defaults(fn=cmd_player)

    pb = sub.add_parser("bench", help="synthetic benchmark")
    pb.add_argument("--device", default=None, help=device_help)
    pb.set_defaults(fn=cmd_bench)

    pe = sub.add_parser("eval", help="ATE: trajectory vs ground truth")
    pe.add_argument("trajectory", help="TUM trajectory file")
    pe.add_argument("gt", help="ground truth (TUM or MulRan global_pose.csv)")
    pe.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    if args.cmd == "slam" and not (args.mulran or args.synthetic
                                   or args.bag or args.pcap):
        p.error("slam requires --mulran DIR, --bag FILE, --pcap FILE or "
                "--synthetic SECONDS")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
