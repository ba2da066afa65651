"""Rank bodies of tests/test_torch_parallel.py: what every spawned gloo
rank runs on the CPU. Importable without JAX (the ranks never import it);
the parent process holds the results against the JAX package."""

import time

import numpy as np
import torch
import torch.distributed as dist

from noetic_slam_tpu_torch import convert
from noetic_slam_tpu_torch.config import GicpConfig, TsdfConfig
from noetic_slam_tpu_torch.models.odometry import OdomState, make_odometry_step
from noetic_slam_tpu_torch.models.tsdf import KEY_PAD
from noetic_slam_tpu_torch.parallel import mesh as pmesh
from noetic_slam_tpu_torch.parallel.bundle_adjustment import sharded_optimize
from noetic_slam_tpu_torch.parallel.registration import (
    make_sharded_align,
    sharded_gicp_align,
)
from noetic_slam_tpu_torch.parallel.tsdf import (
    gather_sharded_state,
    init_sharded_tsdf,
    make_sharded_integrate,
)
from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline


def _t(x):
    return torch.from_numpy(np.array(x))


def _align(mesh, inp):
    src, sv, scov, tgt, tcov = (_t(inp[k]) for k in
                                ("src", "sv", "src_cov", "tgt", "tgt_cov"))
    b0, c0 = mesh.reduce_bytes, mesh.reduce_calls
    res = sharded_gicp_align(mesh, src, sv, scov, mesh.shard(tgt),
                             mesh.shard(tcov), GicpConfig(**inp["gicp"]))
    return {"T": res.T.numpy(), "iters": int(res.iterations),
            "converged": bool(res.converged), "n": int(res.num_corr),
            "bytes": mesh.reduce_bytes - b0, "calls": mesh.reduce_calls - c0}


def _tsdf(mesh, cfg_kw, pts, n_int):
    cfg = TsdfConfig(**cfg_kw)
    st = init_sharded_tsdf(cfg, mesh)
    integ = make_sharded_integrate(cfg, mesh)
    valid = torch.ones(pts.shape[0], dtype=torch.bool)
    for _ in range(n_int):
        st = integ(st, _t(pts), valid, torch.zeros(3))
    merged = gather_sharded_state(cfg, st, mesh)
    return {"held": int((st.dir_keys != KEY_PAD).sum()),
            "counts": (int(st.num_blocks), int(st.dropped)),
            "merged": {k: v.numpy() for k, v in merged._asdict().items()}}


def _odometry(mesh, inp):
    """The pipeline with the sharded align; beside each step, the
    one-process step from a copy of the same state (the pose gap)."""
    cfg = inp["cfg"]
    pipe = OdometryPipeline(cfg, device="cpu",
                            align_fn=make_sharded_align(mesh))
    sharded, one = pipe._step, make_odometry_step(cfg)
    gaps = []

    def step(state, x):
        _, ref = one(OdomState(*(t.clone() for t in state)), x)
        state, out = sharded(state, x)
        gaps.append(float(torch.linalg.vector_norm(out.lidar_p
                                                   - ref.lidar_p)))
        return state, out

    pipe._step = step
    stamps, ang, acc = inp["imu"]
    for i in range(len(stamps)):
        pipe.push_imu(stamps[i], ang[i], acc[i])
    for scan in inp["scans"]:
        pipe.process_scan(*scan)
    return {"traj": pipe.flush(), "syncs": pipe.host_syncs, "gaps": gaps}


def rank_work(inp: dict) -> dict:
    """Every sharded path once on this rank (2 or 4 gloo CPU ranks)."""
    mesh = pmesh.make_mesh(devices="cpu")
    out = {"rank": dist.get_rank(), "align": _align(mesh, inp["align"])}
    for name, kw in (("ba_dense", dict(iters=10, method="dense")),
                     ("ba_cg", dict(iters=3, method="cg", cg_iters=60))):
        g = convert.posegraph_from_numpy(inp[name], "cpu")
        got = sharded_optimize(mesh, g, **kw)
        out[name] = {"node_q": got.node_q.numpy(),
                     "node_p": got.node_p.numpy()}
    for name, (cfg_kw, n_int) in inp["tsdf"].items():
        out[name] = _tsdf(mesh, cfg_kw, inp["tsdf_pts"], n_int)
    out["odometry"] = _odometry(mesh, inp["odometry"])
    if mesh.size() == 4:
        m2 = pmesh.make_mesh_2d(n_map=2, n_batch=2, devices="cpu")
        v = torch.tensor([float(dist.get_rank())])
        both = m2.all_reduce(m2.all_reduce(v, "sum", "map"), "sum", "batch")
        row = m2.all_reduce(v, "sum", "map")
        out["mesh2"] = {"both": float(both), "map": float(row),
                        "index": (m2.index("batch"), m2.index("map"))}
    return out


def raise_on_rank_one() -> None:
    mesh = pmesh.make_mesh(devices="cpu")
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    mesh.all_reduce(torch.ones(1))


def hang_on_rank_zero() -> None:
    """Rank 0 waits in a collective that rank 1 does not enter for a
    minute."""
    mesh = pmesh.make_mesh(devices="cpu")
    if dist.get_rank() == 0:
        mesh.all_reduce(torch.ones(1))
    else:
        time.sleep(60)
