"""The plain reference beside the port at a tiny size (CPU): the TSDF
fusion against ``models.tsdf``, the pose measures against known errors."""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from benchmark.harness.check import to_tf32, wire_points  # noqa: E402
from benchmark.reference import truth  # noqa: E402
from benchmark.reference.tsdf import (  # noqa: E402
    ReferenceTsdf,
    map_gap,
    payload_voxels,
)


def _scans(n_scans=4, n=1500, seed=0):
    """Points on three planes of a room, seen from a moving origin (the
    planes off the voxel faces, where f32 and f64 would split ties)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_scans):
        o = np.array([0.4 * k + 0.013, 0.1 * k + 0.027, 1.21])
        m = n // 3
        floor = np.c_[rng.uniform(-8, 8, (m, 2)), np.full(m, 0.03)]
        wall = np.c_[np.full(m, 6.07), rng.uniform(-8, 8, m),
                     rng.uniform(0, 3, m)]
        side = np.c_[rng.uniform(-8, 8, m), np.full(m, -5.11),
                     rng.uniform(0, 3, m)]
        out.append((np.concatenate([floor, wall, side]).astype(np.float32),
                    o.astype(np.float32)))
    return out


@pytest.mark.parametrize("carving,cap,blocks", [
    (False, 4096, 65536), (True, 4096, 65536),
    (True, 40, 65536),          # the scan's block cap drops blocks
    (False, 4096, 90)])         # the map's capacity drops blocks
def test_reference_tsdf_matches_the_port(carving, cap, blocks):
    from noetic_slam_tpu_torch.config.params import TsdfConfig
    from noetic_slam_tpu_torch.models import tsdf as port

    cfg = dict(voxel_size=0.2, block_size=8, truncation=0.6, max_weight=5.0,
               max_blocks=blocks, max_range=12.0, space_carving=carving,
               carving_samples=8, scan_block_cap=cap)
    pcfg = TsdfConfig(**cfg)
    state = port.init_tsdf(pcfg, "cpu")
    ref = ReferenceTsdf(cfg, torch.device("cpu"))
    for pts, o in _scans():
        state = port.integrate(pcfg, state, torch.from_numpy(pts),
                               torch.ones(len(pts), dtype=torch.bool),
                               torch.from_numpy(o))
        ref.fuse(torch.from_numpy(pts.astype(np.float64)),
                 torch.ones(len(pts), dtype=torch.bool),
                 torch.from_numpy(o.astype(np.float64)))
    prog = payload_voxels(state.dir_keys, state.weight, state.wsum,
                          state.dir_slots)
    assert len(prog[0]) > 1000
    assert map_gap(prog, (ref.ids, ref.w, ref.ws)) < 1e-3
    if blocks < 1000:
        assert int(state.num_blocks) == blocks == len(ref.blocks)
    # a wrong map is far off: half the weights
    bad = (prog[0], prog[1] * 0.5, prog[2])
    assert map_gap(bad, (ref.ids, ref.w, ref.ws)) > 0.1


def test_tf32_rounding():
    x = torch.tensor([1.0, 100.0 + 1e-3, 1.0 + 2 ** -11], dtype=torch.float64)
    y = to_tf32(x)
    assert y[0] == 1.0 and y[1] == 100.0 and y[2] in (1.0, 1.0 + 2 ** -10)


def test_wire_points_round_to_the_scale():
    xyz = np.array([[80.0, 0.0, 0.0], [0.001, 0.0, 1.2345], [0, 0, 0]],
                   np.float32)
    w = wire_points(xyz)
    step = 80.0 / 32766.0
    assert np.abs(w - xyz).max() <= step / 2 + 1e-9
    assert w[0, 0] == pytest.approx(80.0, abs=1e-5)


def _path(n=60, seed=1):
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(rng.normal(0, 0.05, n))
    p = np.cumsum(np.c_[np.cos(yaw), np.sin(yaw), np.zeros(n)], axis=0)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros((n, 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = (c, -s, s,
                                                                   c, 1)
    return R, p


def test_relative_error_ignores_the_world_frame():
    R, p = _path()
    A = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R2, p2 = A @ R, p @ A.T + [5.0, -3.0, 2.0]
    idx = np.arange(len(p))
    assert truth.relative_error(idx, R2, p2, R, p, 10).max() < 1e-9
    p3 = p2.copy()
    p3[30] += [0.0, 0.0, 0.2]             # one pose altered
    e = truth.relative_error(idx, R2, p3, R, p, 10)
    assert e.max() == pytest.approx(0.2)


def test_relative_error_skips_missing_scans():
    R, p = _path()
    idx = np.arange(len(p))
    keep = idx % 2 == 0                   # half the scans have no pose
    e = truth.relative_error(idx[keep], R[keep], p[keep], R[keep], p[keep],
                             10)
    assert len(e) == keep.sum() - 5


def test_aligned_error():
    R, p = _path()
    A = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    assert truth.aligned_error(p @ A.T + 3.0, p).max() < 1e-9
    q = p.copy()
    q[-1] += [1.0, 0.0, 0.0]
    assert truth.aligned_error(q, p).max() > 0.5


def test_quat_to_mat():
    q = np.array([[np.cos(0.3), 0.0, 0.0, np.sin(0.3)]])
    R = truth.quat_to_mat(q)[0]
    assert R[0, 0] == pytest.approx(np.cos(0.6))
    assert R[1, 0] == pytest.approx(np.sin(0.6))


def test_ate_is_the_ports():
    from noetic_slam_tpu_torch.utils.synthetic import ate_rmse

    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, 50)
    p = rng.normal(size=(50, 3)).cumsum(0)
    e = p + rng.normal(0, 0.1, (50, 3))
    assert truth.ate_rmse(t, e, t, p) == pytest.approx(ate_rmse(t, e, t, p),
                                                       rel=1e-12)
