"""The keyframe archive (``runtime/archive.py``) against the JAX one, and its
contracts: the signed fusion cancels, untouched voxels stay bit-identical,
an entry's contribution does not depend on its place in a batch, an
incremental pose update equals a fresh build, and the snapshot equals live
integration. Volumes are compared by block key (the two directories may
give a block different payload slots)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noetic_slam_tpu.runtime import archive as jarchive
from noetic_slam_tpu_torch.config import (
    CapacityConfig,
    DlioConfig,
    KeyframeConfig,
    OccupancyConfig,
    TsdfConfig,
)
from noetic_slam_tpu_torch.models import occupancy as occ_mod
from noetic_slam_tpu_torch.models import posegraph as pg
from noetic_slam_tpu_torch.models import tsdf as tsdf_mod
from noetic_slam_tpu_torch.runtime import archive as ar_mod
from noetic_slam_tpu_torch.runtime.archive import KeyframeArchive
from noetic_slam_tpu_torch.runtime.slam import SlamSystem
from noetic_slam_tpu_torch.utils import synthetic
from tests.test_archive import _cloud
from tests.torch_parity import jax_cfg, to_np, to_torch

torch.set_num_threads(1)
CPU = "cpu"
KEY_PAD = np.iinfo(np.int32).max
# Port against JAX on the same entries: the payload sums differ only by
# summation order (kernel B's plain version sums per entry, then adds;
# XLA scatters), ~1e-5 of weights up to ~20.
PAYLOAD_TOL = 1e-5


def _live():
    return TsdfConfig(voxel_size=0.2, truncation=0.6, max_blocks=2048,
                      space_carving=False, scan_block_cap=512)


def _by_key(state, *chans):
    """{block key: tuple of payload rows} of a TSDF / occupancy state."""
    keys, slots = to_np(state.dir_keys), to_np(state.dir_slots)
    rows = [to_np(c) for c in chans]
    return {int(k): tuple(r[s] for r in rows)
            for k, s in zip(keys, slots) if k != KEY_PAD}


def _same_by_key(a: dict, b: dict, atol):
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=atol)


def _entries(n, npts=256, seed=0):
    """n keyframes: local-frame rings quantized as the archive stores them,
    at poses along a line with some yaw."""
    rng = np.random.default_rng(seed)
    xyz_q = np.stack([np.clip(np.round(_cloud(i, n=npts, center=(5, 0, 0))
                                       / 2e-3), -32766, 32766)
                      for i in range(n)]).astype(np.int16)
    scale = np.full((n,), 2e-3, np.float32)
    valid = rng.random((n, npts)) > 0.05
    yaw = rng.uniform(-0.3, 0.3, n)
    q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)],
                 -1).astype(np.float32)
    p = np.stack([np.arange(n) * 0.7, rng.normal(0, 0.3, n),
                  np.zeros(n)], -1).astype(np.float32)
    return xyz_q, scale, valid, q, p


def _port_fuse(cfg, args, sign, backend="tsdf", vol=None):
    if vol is None:
        vol = (occ_mod.init_occupancy(cfg, CPU) if backend == "occupancy"
               else tsdf_mod.init_tsdf(cfg, CPU))
    return ar_mod._fuse_scan(cfg, vol, *map(to_torch, args),
                             np.asarray(sign, np.float32), backend=backend)


@pytest.mark.parametrize("backend", ["tsdf", "occupancy"])
def test_fuse_scan_matches_jax(backend):
    """Eight entries in two chunks, signs mixed (the last -1 cancels the
    first's +1 at the same pose), against JAX's ``_fuse_scan``."""
    if backend == "occupancy":
        cfg = dataclasses.replace(
            OccupancyConfig(voxel_size=0.2, max_blocks=2048,
                            scan_block_cap=512, miss_samples=8),
            l_min=-1e30, l_max=1e30)
        jvol = jarchive.occ_mod.init_occupancy(jax_cfg(cfg))
    else:
        cfg = dataclasses.replace(_live(), max_weight=tsdf_mod.NO_CLAMP)
        jvol = jarchive.tsdf_mod.init_tsdf(jax_cfg(cfg))
    xyz_q, scale, valid, q, p = _entries(8)
    xyz_q[7], q[7], p[7], valid[7] = xyz_q[0], q[0], p[0], valid[0]
    sign = np.asarray([1, 1, 1, 1, 1, 0, 1, -1], np.float32)
    args = (xyz_q, scale, valid, q, p)
    jvol = jarchive._fuse_scan(jax_cfg(cfg), jvol,
                               *map(jnp.asarray, args + (sign,)),
                               backend=backend)
    vol = _port_fuse(cfg, args, sign, backend)
    chans = ("logodds",) if backend == "occupancy" else ("weight", "wsum")
    _same_by_key(_by_key(vol, *(getattr(vol, c) for c in chans)),
                 _by_key(jvol, *(np.asarray(getattr(jvol, c))
                                 for c in chans)), atol=PAYLOAD_TOL)
    assert int(vol.num_blocks) == int(jvol.num_blocks) > 10
    assert int(vol.dropped) == int(jvol.dropped)


def test_signed_fusion_cancels():
    """+1 then -1 of the same stream returns exactly 0 (the plain version,
    like kernel B, sums an entry before it meets the payload); de-fusing
    an entry whose chunk mates differ from those it was added with cancels
    to ~1 ulp of the accumulated mass."""
    cfg = dataclasses.replace(_live(), max_weight=tsdf_mod.NO_CLAMP)
    pts = to_torch(_cloud())
    v = torch.ones(pts.shape[0], dtype=torch.bool)
    vol = tsdf_mod.init_tsdf(cfg, CPU)
    vol = tsdf_mod.integrate_signed(cfg, vol, pts, v, torch.zeros(3), 1.0)
    assert float(vol.weight.abs().max()) > 0.5
    vol = tsdf_mod.integrate_signed(cfg, vol, pts, v, torch.zeros(3), -1.0)
    assert float(vol.weight.abs().max()) == 0.0
    assert float(vol.wsum.abs().max()) == 0.0

    xyz_q, scale, valid, q, p = _entries(8)
    args = (xyz_q, scale, valid, q, p)
    vol = _port_fuse(cfg, args, np.ones(8))                  # 2 chunks
    peak = float(vol.weight.max())
    # remove all eight in another composition: entry order reversed
    rev = tuple(a[::-1].copy() for a in args)
    vol = _port_fuse(cfg, rev, -np.ones(8), vol=vol)
    assert float(vol.weight.abs().max()) < 1e-5 * peak
    assert float(vol.wsum.abs().max()) < 1e-5 * peak


def test_subtract_leaves_untouched_voxels_bit_identical():
    cfg = dataclasses.replace(_live(), max_weight=tsdf_mod.NO_CLAMP)
    near = to_torch(_cloud(0, center=(4.0, 0, 0)))
    far = to_torch(_cloud(1, center=(60.0, 0, 0)))
    v = torch.ones(near.shape[0], dtype=torch.bool)
    origin_far = torch.tensor([55.0, 0, 0])
    vol = tsdf_mod.init_tsdf(cfg, CPU)
    vol = tsdf_mod.integrate_signed(cfg, vol, near, v, torch.zeros(3), 1.0)
    vol = tsdf_mod.integrate_signed(cfg, vol, far, v, origin_far, 1.0)
    w0, ws0 = to_np(vol.weight).copy(), to_np(vol.wsum).copy()
    keys, slots = to_np(vol.dir_keys), to_np(vol.dir_slots)
    bx = (keys.astype(np.int64) & 0x7FF) - 1024
    live = keys != KEY_PAD
    near_rows = slots[live & ((bx + 1) * 8 * cfg.voxel_size < 40.0)]
    far_rows = slots[live & (bx * 8 * cfg.voxel_size > 40.0)]
    assert len(near_rows) > 10 and len(far_rows) > 10
    vol = tsdf_mod.integrate_signed(cfg, vol, far, v, origin_far, -1.0)
    np.testing.assert_array_equal(to_np(vol.weight)[near_rows], w0[near_rows])
    np.testing.assert_array_equal(to_np(vol.wsum)[near_rows], ws0[near_rows])
    assert np.abs(to_np(vol.weight)[far_rows]).max() < 1e-4


def test_contribution_independent_of_batch_position():
    """One entry fused at chunk position 0 of a one-chunk batch and at
    position 3 of the last chunk of a four-chunk batch (every other entry
    sign-0 padding): bitwise equal volumes."""
    cfg = dataclasses.replace(_live(), max_weight=tsdf_mod.NO_CLAMP)
    xyz_q, scale, valid, q, p = _entries(16, seed=3)
    a = _port_fuse(cfg, (xyz_q[5:9], scale[5:9], valid[5:9], q[5:9],
                         p[5:9]), [1, 0, 0, 0])
    perm = np.r_[0:5, 6:16, 5]                   # entry 5 at index 15
    sign = np.zeros(16)
    sign[15] = 1
    b = _port_fuse(cfg, tuple(x[perm] for x in (xyz_q, scale, valid, q, p)),
                   sign)
    for name in tsdf_mod.TsdfState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_archive_quantization_error():
    ar = KeyframeArchive(_live(), device=CPU)
    pts = _cloud(3, center=(8.0, 3.0, 0.5))
    q = np.asarray([0.9689124, 0.0, 0.0, 0.2474040], np.float32)
    p = np.asarray([1.0, -2.0, 0.3], np.float32)
    ar.add(0, q, p, pts, np.ones((pts.shape[0],), bool))
    e = ar.entries[0]
    world = to_np(ar_mod._world(to_torch(e.xyz_q), torch.tensor(e.scale),
                                to_torch(q), to_torch(p)))
    assert np.linalg.norm(world - pts, axis=-1).max() < 5e-3


def _add_four(ar):
    qs = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (4, 1))
    ps = np.asarray([[0, 0, 0], [2, 0, 0], [4, 0, 0], [6, 0, 0]],
                    np.float32)
    for i in range(4):
        ar.add(i, qs[i], ps[i], _cloud(i, center=(5.0, 2.0 * i, 0)),
               np.ones((512,), bool))
    return qs, ps


def test_apply_poses_incremental_equals_fresh():
    ar = KeyframeArchive(_live(), device=CPU)
    qs, ps = _add_four(ar)
    new_p = ps.copy()
    new_p[2] += [0.4, -0.2, 0.1]
    new_p[3] += [0.8, -0.4, 0.2]
    assert ar.apply_poses(qs, new_p) == 2
    np.testing.assert_array_equal(ar.pose_of(3)[1], new_p[3])
    fresh = KeyframeArchive(_live(), device=CPU)
    for i in range(4):
        e = ar.entries[i]
        fresh.entries[i] = e
        fresh.volume = ar_mod._fuse_entry(
            fresh.cfg, fresh.volume, to_torch(e.xyz_q), torch.tensor(e.scale),
            to_torch(e.valid), to_torch(qs[i]), to_torch(new_p[i]), 1.0)
    a, b = ar.snapshot_live(), fresh.snapshot_live()
    ka, kb = _by_key(a, a.weight, a.wsum), _by_key(b, b.weight, b.wsum)
    # blocks the moved entries vacated hold ~0 in the incremental volume
    for k in ka.keys() - kb.keys():
        assert np.abs(ka[k][0]).max() < 1e-5
    _same_by_key({k: ka[k] for k in kb}, kb, atol=1e-4)


def test_snapshot_matches_sequential_live_integration():
    live = _live()
    ar = KeyframeArchive(live, device=CPU)
    poses = [(np.asarray([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)),
             (np.asarray([1.0, 0, 0, 0], np.float32),
              np.asarray([0.5, 0.2, 0], np.float32))]
    for i, (q, p) in enumerate(poses):
        pts = _cloud(i, center=(5.0 + i, 0, 0))
        ar.add(i, q, p, pts, np.ones((pts.shape[0],), bool))
    snap = ar.snapshot_live()
    ref = tsdf_mod.init_tsdf(live, CPU)
    for i, (q, p) in enumerate(poses):
        e = ar.entries[i]
        ref = ar_mod._fuse_entry(live, ref, to_torch(e.xyz_q),
                                 torch.tensor(e.scale), to_torch(e.valid),
                                 to_torch(e.q), to_torch(e.p), 1.0)
    _same_by_key(_by_key(snap, snap.weight, snap.wsum),
                 _by_key(ref, ref.weight, ref.wsum), atol=1e-5)
    # the snapshot owns its tensors (the live map is updated in place)
    assert snap.weight.data_ptr() != ar.volume.weight.data_ptr()


def test_pack_unpack_across_packages():
    """A JAX archive's pack() loads in the port's unpack() and replays to
    the JAX volume; the port's pack() loads back in JAX."""
    jar = jarchive.KeyframeArchive(jax_cfg(_live()))
    for i in range(5):
        jar.add(i, np.asarray([1.0, 0, 0, 0], np.float32),
                np.asarray([0.5 * i, 0, 0], np.float32),
                _cloud(i, center=(5.0 + i, 0, 0)), np.ones((512,), bool))
    ar = KeyframeArchive(_live(), device=CPU)
    ar.unpack(jar.pack())
    assert len(ar) == 5
    for k, v in jar.pack().items():
        np.testing.assert_array_equal(ar.pack()[k], v, err_msg=k)
    jv = jar.volume
    _same_by_key(_by_key(ar.volume, ar.volume.weight, ar.volume.wsum),
                 _by_key(jv, np.asarray(jv.weight), np.asarray(jv.wsum)),
                 atol=PAYLOAD_TOL)
    back = jarchive.KeyframeArchive(jax_cfg(_live()))
    back.unpack(ar.pack())
    assert sorted(back.entries) == list(range(5))


def test_occupancy_backend_roundtrip():
    live = OccupancyConfig(voxel_size=0.2, max_blocks=2048,
                           scan_block_cap=512, miss_samples=8)
    ar = KeyframeArchive(live, backend="occupancy", device=CPU)
    q = np.asarray([1.0, 0, 0, 0], np.float32)
    for i in range(2):
        pts = _cloud(i, center=(5.0 + i, 0, 0))
        ar.add(i, q, np.asarray([0.2 * i, 0, 0], np.float32), pts,
               np.ones((pts.shape[0],), bool))
    assert ar.apply_poses(np.stack([q, q]),
                          np.asarray([[0, 0, 0], [0.6, 0.1, 0]],
                                     np.float32)) == 1
    snap = ar.snapshot_live()
    assert float(snap.logodds.max()) <= live.l_max + 1e-6
    assert float(snap.logodds.min()) >= live.l_min - 1e-6
    centers, _, mask = occ_mod.extract_occupied(live, snap)
    occ = to_np(centers)[to_np(mask)]
    assert len(occ) > 50
    d0 = np.abs(np.linalg.norm(occ[:, :2] - [5.0, 0.0], axis=-1) - 2.0)
    d1 = np.abs(np.linalg.norm(occ[:, :2] - [6.6, 0.1], axis=-1) - 2.0)
    assert np.median(np.minimum(d0, d1)) < 0.3


def test_apply_poses_fusion_calls_bounded(monkeypatch):
    """Moving B archived keyframes costs O(B / bucket) fuse dispatches; a
    padding-only chunk runs no fusion call at all."""
    live = TsdfConfig(voxel_size=0.25, truncation=0.75, max_blocks=2048,
                      space_carving=False, scan_block_cap=1024)
    ar = KeyframeArchive(live, device=CPU)
    B = 30
    qs = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (B, 1))
    ps = np.zeros((B, 3), np.float32)
    ps[:, 0] = np.arange(B)
    clouds = np.stack([_cloud(i, n=32, center=(5.0, i, 0)) for i in range(B)])
    calls = {"scan": 0, "fuse": 0}
    real_scan, real_fuse = ar_mod._fuse_scan, tsdf_mod._integrate_samples

    def scan(*a, **kw):
        calls["scan"] += 1
        return real_scan(*a, **kw)

    def fuse(*a, **kw):
        calls["fuse"] += 1
        return real_fuse(*a, **kw)

    monkeypatch.setattr(ar_mod, "_fuse_scan", scan)
    monkeypatch.setattr(tsdf_mod, "_integrate_samples", fuse)
    ar.add_batch(list(range(B)), qs, ps, clouds, np.ones((B, 32), bool))
    assert calls == {"scan": 1, "fuse": 8}       # 64-entry bucket, 8 chunks
    new_p = ps.copy()
    new_p[:, 1] += 1.0
    calls.update(scan=0, fuse=0)
    assert ar.apply_poses(qs, new_p) == B
    assert calls == {"scan": 1, "fuse": 15}      # 60 entries, 15 chunks


def test_entry_points_default_to_the_card():
    """``device=None`` means the card: without one, the system, the
    archive, the descriptor store and the graph raise instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    from noetic_slam_tpu_torch.models.placedesc import DescriptorStore

    for make in (lambda: SlamSystem(DlioConfig()),
                 lambda: KeyframeArchive(_live()),
                 lambda: DescriptorStore(),
                 lambda: pg.init_graph(8, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def _small_slam(warm: bool = False):
    """A small SlamSystem run (25 scans, a graph started at 8 nodes,
    maybe_close_loop every sixth scan)."""
    cfg = DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=16, max_submap_kf=4),
        keyframe=KeyframeConfig(thresh_dist=0.25, thresh_rot=45.0),
        adaptive=False,
        tsdf=TsdfConfig(voxel_size=0.2, truncation=0.6, max_blocks=4096,
                        space_carving=False))
    sim = synthetic.make_sim(duration=2.5, n_points=1024, calib_time=3.1,
                             seed=9)
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]
    slam = SlamSystem(cfg, device=CPU, loop_min_gap=5)
    slam.graph = pg.init_graph(8, 8, device=CPU)
    if warm:
        slam.warmup()
    imu_i = 0
    for s, (h, xyz, pt) in enumerate(scans):
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= h + pt.max() + 0.02):
            slam.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1
        slam.process_scan(h, xyz, pt)
        if s % 6 == 5:
            slam.maybe_close_loop()
    return slam


def test_slam_warmup_noop_and_graph_growth():
    """SlamSystem: warmup() before a run leaves every later result bitwise
    equal; a graph started at 8 nodes grows past them without dangling
    ids, and every synced keyframe is archived."""
    a, b = _small_slam(False), _small_slam(True)
    n = int(a.graph.n_nodes)
    assert n == a._synced_total > 8 and a.graph.node_q.shape[0] >= n
    assert len(a.archive) == n
    assert all(0 <= v < n for v in a._slot_node.values())
    for x, y, what in ((a.odometry.state, b.odometry.state, "state"),
                       (a.graph, b.graph, "graph"), (a.tsdf, b.tsdf, "tsdf"),
                       (a.archive.volume, b.archive.volume, "archive")):
        for name in x._fields:
            assert torch.equal(getattr(x, name), getattr(y, name)), \
                f"{what}.{name}"


def test_set_keyframe_poses_moves_graph_state_and_map():
    """set_keyframe_poses: the graph becomes an odometry chain through the
    given poses (zero cost, no closure edge), the synced keyframes' state
    follows, every keyframe moved beyond the archive's threshold is
    re-fused, and the live map is the archive's snapshot."""
    slam = _small_slam()
    slam.sync_graph()
    n = slam._synced_total
    q, p = to_np(slam.graph.node_q)[:n], to_np(slam.graph.node_p)[:n]
    q2, p2 = synthetic.linear_drift(q, p, 0.05, (0.4, -0.2, 0.1))
    moved = slam.set_keyframe_poses(q2, p2)
    g = slam.graph
    assert int(g.n_nodes) == n and int(g.n_edges) == n - 1
    np.testing.assert_array_equal(to_np(g.node_q)[:n], q2)
    np.testing.assert_array_equal(to_np(g.node_p)[:n], p2)
    assert float(pg.graph_cost(g)) < 1e-8
    st = slam.odometry.state
    for slot, node in slam._slot_node.items():
        np.testing.assert_array_equal(to_np(st.kf_pos)[slot], p2[node])
    assert moved == n - 1                     # all but the first node
    snap = slam.archive.snapshot_live()
    for name in slam.tsdf._fields:
        assert torch.equal(getattr(slam.tsdf, name), getattr(snap, name)), \
            name
