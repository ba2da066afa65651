"""Full SLAM system: odometry + dense-map fusion + pose graph + loop closure
(port of ``noetic_slam_tpu.runtime.slam``).

The composition root, with the JAX class's constructor arguments and
methods plus ``device``:

- the odometry pipeline (``runtime.pipeline.OdometryPipeline``) with the
  dense map fused into its step;
- the keyframe sync: every keyframe leaves the device through the outbox
  ring (``models.odometry``); ``sync_dispatch`` gathers the new ones and
  queues their copies to the host, ``_sync_complete`` waits for those
  copies (a batch later on the pipelined path) and commits them to the
  pose graph, the keyframe archive and the descriptor store;
- two-stage loop detection (pose proximity over the resident store, then
  descriptor matches over every keyframe ever created), GICP verification
  (``models.posegraph.verify_loop``; kernel A on the card), a drift
  budget, Gauss-Newton optimisation, the deformation of the odometry
  state, and the archive's O(moved) re-fusion (kernel B or C on the card)
  whose snapshot becomes the live map.

Porting notes:
- every device -> host read waits on its own copies only
  (``utils.host.PendingFetch``) and is counted in ``host_syncs`` beside
  the odometry step's reads;
- the JAX class's graph-capacity pre-warm helpers (``_graph_avatar``,
  ``_warm_graph_capacity``, ``_prewarm_async``, ``_ensure_capacity_warm``)
  only compiled XLA programs ahead of use; eager torch compiles nothing,
  so they are left out, and ``warmup()`` loads the kernels, runs the
  step on throwaway scans and loads the library handles of the closure
  path.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from noetic_slam_tpu_torch.config import DlioConfig
from noetic_slam_tpu_torch.models import occupancy as occ_mod
from noetic_slam_tpu_torch.models import posegraph as pg
from noetic_slam_tpu_torch.models import tsdf as tsdf_mod
from noetic_slam_tpu_torch.models.placedesc import (
    N_RINGS,
    N_SECTORS,
    DescriptorStore,
    match_store_batch,
    ring_descriptor,
)
from noetic_slam_tpu_torch.ops import gicp as gicp_ops
from noetic_slam_tpu_torch.ops.gicp import HostSyncs
from noetic_slam_tpu_torch.ops.pointcloud import take
from noetic_slam_tpu_torch.runtime import checkpoint as ck
from noetic_slam_tpu_torch.runtime.archive import KeyframeArchive
from noetic_slam_tpu_torch.runtime.pipeline import OdometryPipeline
from noetic_slam_tpu_torch.runtime.poseext import PoseExtrapolator
from noetic_slam_tpu_torch.runtime.profiling import span
from noetic_slam_tpu_torch.utils.geometry import (
    make_se3,
    make_se3_np,
    mat_to_quat_np,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    quat_to_mat_np,
)
from noetic_slam_tpu_torch.utils.host import PendingFetch, to_device


def _guarded_verdict(accepted, kf_seq, slots, expects):
    """Fold the slot seq guards into the verification verdict on the
    device: (accepted and guards hold, guards hold)."""
    ok = torch.all(kf_seq[slots] == expects)
    return accepted & ok, ok


def _gather_sync(st, n_nodes, n_edges, prev_total: int, k_max: int) -> dict:
    """Everything a graph sync needs, as device tensors: the keyframe-store
    metadata, the outbox ring headers, the clouds of outbox sequences
    (prev_total, prev_total + k_max] in insertion order (rows beyond the
    really new ones hold stale ring contents; the host checks each
    sequence against ``ob_seq``), and the fused-state seed of the IMU-rate
    pose extrapolator (propagated to ``prop_off``, not the header)."""
    Q = st.ob_seq.shape[0]
    seqs = prev_total + 1 + torch.arange(k_max, device=st.ob_seq.device)
    return {
        "total": st.kf_total, "seq": st.kf_seq, "q": st.kf_quat,
        "p": st.kf_pos, "count": st.kf_count,
        "n_nodes": n_nodes, "n_edges": n_edges,
        "ob_seq": st.ob_seq, "ob_q": st.ob_q, "ob_p": st.ob_p,
        "ob_slot": st.ob_slot, "new_xyz": st.ob_xyz[(seqs - 1) % Q],
        "cur_q": st.q, "cur_p": st.p, "cur_v": st.v,
        "bg": st.bg, "ba": st.ba, "prop_off": st.prop_off,
    }


def _deform_state(st, new_q, new_p):
    """Apply optimised per-slot keyframe poses to the odometry state: rigid
    cloud/covariance deformation (``pg.apply_pose_update``), the live pose
    corrected by the NEWEST keyframe's pose delta (max insertion sequence,
    not slot kf_count - 1: once the store evicts, slot order is not age
    order), and the submap invalidated. Returns a new state."""
    q, p, xyz, cov = pg.apply_pose_update(
        st.kf_quat, st.kf_pos, st.kf_xyz, st.kf_valid, st.kf_cov,
        new_q, new_p, st.kf_count)
    last = torch.argmax(st.kf_seq)
    dq = quat_normalize(quat_mul(take(q, last),
                                 quat_conj(take(st.kf_quat, last))))
    dp = take(p, last) - quat_rotate(dq, take(st.kf_pos, last))
    lidar_p = quat_rotate(dq, st.lidar_p) + dp
    lidar_q = quat_normalize(quat_mul(dq, st.lidar_q))
    return st._replace(
        kf_quat=q, kf_pos=p, kf_xyz=xyz, kf_cov=cov,
        lidar_q=lidar_q, lidar_p=lidar_p,
        q=quat_normalize(quat_mul(dq, st.q)),
        p=quat_rotate(dq, st.p) + dp,
        v=quat_rotate(dq, st.v), prev_vel=quat_rotate(dq, st.prev_vel),
        T=make_se3(lidar_q, lidar_p),
        submap_mask=torch.zeros_like(st.submap_mask))


class SlamSystem:
    def __init__(self, cfg: DlioConfig | None = None, enable_tsdf: bool = True,
                 enable_loop_closure: bool = True, loop_radius: float = 3.0,
                 loop_min_gap: int = 10, max_edges: int = 4096,
                 drift_budget_frac: float = 0.05,
                 drift_budget_min: float = 0.3,
                 archive: bool | None = None,
                 archive_eps_t: float | None = None,
                 archive_eps_r: float | None = None,
                 use_descriptors: bool = True,
                 desc_min_score: float = 0.55,
                 pipelined: bool = False,
                 min_closure_correction: float | None = None,
                 device=None):
        self.cfg = cfg or DlioConfig()
        self.odometry = OdometryPipeline(self.cfg, device=device,
                                         with_tsdf=enable_tsdf)
        self.device = self.odometry.device
        self.enable_tsdf = enable_tsdf
        self.enable_loop_closure = enable_loop_closure
        self.loop_radius = loop_radius
        self.loop_min_gap = loop_min_gap
        self._syncs = HostSyncs()   # this class's own device->host waits
        map_cfg = (self.cfg.occupancy if self.cfg.map_backend == "occupancy"
                   else self.cfg.tsdf)
        # keyframe archive (every keyframe ever created + the incrementally
        # corrected archive volume); on whenever closures can deform the map
        if archive is None:
            archive = enable_tsdf and enable_loop_closure
        self.archive = None
        if archive and enable_tsdf:
            self.archive = KeyframeArchive(map_cfg,
                                           backend=self.cfg.map_backend,
                                           device=self.device)
        # None -> map-resolution thresholds (KeyframeArchive.apply_poses)
        self.archive_eps_t = archive_eps_t
        self.archive_eps_r = archive_eps_r
        self.closure_log: list = []     # per-closure {moved, seconds, ...}
        # descriptor place recognition over every keyframe ever created;
        # desc_min_score as calibrated for the JAX package
        self.desc_store = None
        if enable_loop_closure and use_descriptors:
            self.desc_store = DescriptorStore(device=self.device)
        self.desc_min_score = desc_min_score
        self._node_slot: dict = {}       # graph node -> resident slot
        self._last_desc_query_node = -1
        self._pending_desc = None        # in-flight query batch (pipelined)
        self._desc_match_hist: dict = {} # node -> (matched cand, shift)
        self.loop_closures_descriptor = 0
        self.desc_log: list = []         # per-query {node, cand, score}
        self.sync_lost_keyframes = 0     # outbox overruns (contract: 0)
        # drift budget: a verified closure whose correction exceeds
        # drift_budget_frac x (path length around the loop) + slack is
        # treated as a geometric alias
        self.drift_budget_frac = drift_budget_frac
        self.drift_budget_min = drift_budget_min
        self.loop_rejected_budget = 0
        # minimum correction worth applying (a tenth of a voxel by default)
        if min_closure_correction is None:
            min_closure_correction = (0.1 * map_cfg.voxel_size
                                      if enable_tsdf else 0.02)
        self.min_closure_correction = min_closure_correction
        self.loop_skipped_small = 0
        self._attempt_raced = False
        # the pose graph outlives the bounded keyframe store: node capacity
        # covers keyframes ever created and grows by doubling
        self.max_graph_nodes = max(4 * self.cfg.capacity.max_keyframes, 512)
        self.graph = pg.init_graph(self.max_graph_nodes, max_edges,
                                   device=self.device)
        self._slot_node: dict = {}       # resident slot -> graph node
        self._synced_total = 0
        self._last_kf_pose = None        # (q, p) of the newest synced kf
        self._kf_host = None     # host stash of keyframe metadata
        self._edges_host = 0     # host mirror of graph.n_edges
        self.loop_closures = 0
        self.loop_raced = 0      # attempts rejected by the seq guard
        # pipelined sync: (pending fetch, synced_total at dispatch, scans
        # submitted at dispatch)
        self._pending_sync = None
        self._gather_k = min(self.cfg.capacity.outbox_slots, 24)
        # pipelined=True: maybe_close_loop syncs one cadence stale, with
        # the fetch overlapped (the real-time callers' mode)
        self.pipelined = pipelined
        self.extrapolator = None  # PoseExtrapolator fed by _sync_complete

    @property
    def host_syncs(self) -> int:
        """Device->host reads so far: the odometry step's control-flow
        reads plus this class's fetches and verification GICP reads."""
        return self.odometry.host_syncs + self._syncs.n

    def _fetch(self, tensors: dict) -> dict:
        """One counted, blocking device->host read of ``tensors``."""
        self._syncs.n += 1
        return PendingFetch(tensors).wait()

    # ------------------------------------------------- shared solver params
    def _verify_cfg(self):
        """Verification GICP config: the full solver budget."""
        return dataclasses.replace(
            self.cfg.gicp,
            max_iterations=max(self.cfg.gicp.max_iterations, 32),
            lm_max_iterations=max(self.cfg.gicp.lm_max_iterations, 10))

    _DENSE_BUCKETS = (64, 128, 256)
    _DENSE_MAX = 192          # live nodes above this take the CG path
    _CG_ITERS = 60

    def _solver_variant(self, n_live: int):
        """(method, k_static|None) for the live node count: dense k_static
        buckets up to _DENSE_MAX nodes, matrix-free CG beyond."""
        if n_live <= self._DENSE_MAX:
            ks = max(self._DENSE_BUCKETS[0],
                     1 << (max(n_live, 1) - 1).bit_length())
            return "dense", min(ks, self.graph.node_q.shape[0])
        return "cg", None

    def _optimize_graph(self, n_live: int) -> None:
        """One solver pass of 3 Gauss-Newton steps."""
        method, ks = self._solver_variant(n_live)
        self.graph = pg.optimize(self.graph, iters=3, method=method,
                                 k_static=ks, cg_iters=self._CG_ITERS)

    # -------------------------------------------------------------- warmup
    def warmup(self) -> None:
        """Load what the step and the closure path first need on the card,
        on throwaway inputs: the hand-written kernels' library, the step's
        first use (``OdometryPipeline.warmup``: ~4 s on the card, which a
        live stream would otherwise take as a gap after its first frame,
        and lose track across), cuBLAS (descriptor matching) and cuSOLVER
        (the dense solve and the block-Jacobi inverses), and the descriptor
        store's upload. Every result is discarded, so later results are
        bitwise those of a run without it (tests/test_torch_archive.py).
        Optional; the ``setup.warmup`` span."""
        with span("setup.warmup"):
            if self.device.type == "cuda":
                from noetic_slam_tpu_torch.ops.cuda import _build

                _build.load()
            self.odometry.warmup()
            if self.desc_store is not None:
                self.desc_store._sync_dev()
                zq = torch.zeros((4, N_RINGS, N_SECTORS), device=self.device)
                match_store_batch(zq, self.desc_store._dev, 0,
                                  torch.zeros(4, dtype=torch.int64,
                                              device=self.device))
            if self.enable_loop_closure:
                eye = torch.eye(6, device=self.device)
                torch.linalg.solve_ex(eye,
                                      torch.zeros(6, device=self.device))
                torch.linalg.inv_ex(eye[None])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ per scan
    def push_imu(self, stamp, ang, acc):
        self.odometry.push_imu(stamp, ang, acc)

    @property
    def calibrated(self):
        return self.odometry.calibrated

    def imu_covers(self, stamp):
        return self.odometry.imu_covers(stamp)

    @property
    def tsdf(self):
        return self.odometry.tsdf_state

    def process_scan(self, header_stamp, xyz, point_times=None):
        """One scan through the fused odometry + map step."""
        return self.odometry.process_scan(header_stamp, xyz, point_times)

    def process_scans(self, batch):
        """A batch of scans with ``process_scan``'s semantics; loop-closure
        checks happen between batches."""
        return self.odometry.process_scans(batch)

    # ------------------------------------------------------- loop closures
    def sync_dispatch(self) -> None:
        """Gather the sync data and queue its copies to the host, without
        waiting. No-op while a gather is in flight or before any state."""
        st = self.odometry.state
        if st is None or self._pending_sync is not None:
            return
        g = self.graph
        f = _gather_sync(st, g.n_nodes, g.n_edges, self._synced_total,
                         self._gather_k)
        self._pending_sync = (PendingFetch(f), self._synced_total,
                              len(self.odometry.headers))

    def _sync_complete(self) -> int:
        """Wait for the in-flight gather's copies and commit the drained
        keyframes. Returns the new-node count."""
        if self._pending_sync is None:
            return 0
        fetch, prev_total, n_hdr = self._pending_sync
        self._pending_sync = None
        if prev_total != self._synced_total:
            raise RuntimeError("pending sync raced a completed drain")
        with span("sync_fetch"):
            self._syncs.n += 1
            h = fetch.wait()
        return self._drain(h, n_hdr)

    def sync_graph(self) -> int:
        """Drain the keyframe outbox into the graph, the archive and the
        descriptors, in insertion order; on return the graph covers every
        keyframe created so far. Contract: sync at least once per
        ``capacity.outbox_slots`` new keyframes (overruns are counted in
        ``sync_lost_keyframes``). Returns the number of new nodes."""
        n = 0
        p = self._pending_sync
        if p is not None:
            n = self._sync_complete()
            if p[2] == len(self.odometry.headers):
                return n               # pending covered the current state
        self.sync_dispatch()
        return n + self._sync_complete()

    def sync_pipelined(self) -> int:
        """Complete the previous dispatch (stale by up to one call cadence)
        and queue the next; never waits on the current batch's work."""
        n = self._sync_complete()
        self.sync_dispatch()
        return n

    def _drain(self, h: dict, n_hdr: int | None = None) -> int:
        """Commit one fetched gather; falls back to ``_sync_blocking`` when
        the gathered window cannot serve the drain."""
        total = int(h["total"])
        seq = h["seq"]
        self._kf_host = {"total": total, "seq": seq, "q": h["q"],
                         "p": h["p"], "count": int(h["count"])}
        self._edges_host = int(h["n_edges"])
        if self.extrapolator is not None and n_hdr:
            self.extrapolator.seed(
                self.odometry.headers[n_hdr - 1] + float(h["prop_off"]),
                h["cur_q"], h["cur_p"], h["cur_v"], h["bg"], h["ba"])
        prev_total = self._synced_total
        if total <= prev_total:
            return 0
        count = total - prev_total
        ob_seq = h["ob_seq"]
        Q = ob_seq.shape[0]
        if count > self._gather_k or any(
                int(ob_seq[(sq - 1) % Q]) != sq
                for sq in range(prev_total + 1, total + 1)):
            return self._sync_blocking()
        sel = np.asarray([(sq - 1) % Q
                          for sq in range(prev_total + 1, total + 1)])
        xyz_new = h["new_xyz"][:count]
        valid_new = np.all(np.abs(xyz_new) < 1e5, axis=-1)
        return self._commit(h["ob_q"][sel], h["ob_p"][sel],
                            h["ob_slot"][sel], xyz_new, valid_new,
                            int(h["n_nodes"]), total)

    def _sync_blocking(self) -> int:
        """Fresh drain against the current state, for callers syncing less
        than once per _gather_k new keyframes: metadata, then the
        unsynced sequences from the outbox ring or, older than the ring,
        from the resident store. Keyframes in neither are lost (counted)."""
        st = self.odometry.state
        if st is None:
            return 0
        with span("sync_fetch"):
            h = self._fetch({
                "total": st.kf_total, "seq": st.kf_seq, "q": st.kf_quat,
                "p": st.kf_pos, "count": st.kf_count,
                "n_nodes": self.graph.n_nodes, "n_edges": self.graph.n_edges,
                "ob_seq": st.ob_seq, "ob_q": st.ob_q, "ob_p": st.ob_p,
                "ob_slot": st.ob_slot})
        total, seq = int(h["total"]), h["seq"]
        self._kf_host = {"total": total, "seq": seq, "q": h["q"],
                         "p": h["p"], "count": int(h["count"])}
        self._edges_host = int(h["n_edges"])
        if total <= self._synced_total:
            return 0
        ob_seq = h["ob_seq"]
        Q = ob_seq.shape[0]
        first_new = self._synced_total + 1
        seq_to_slot = {int(seq[s]): s for s in range(len(seq))
                       if seq[s] >= first_new}
        recs = []                     # (seq, from_outbox, index)
        lost = 0
        for sq in range(first_new, total + 1):
            oi = (sq - 1) % Q
            if sq > total - Q and ob_seq[oi] == sq:
                recs.append((sq, True, oi))
            elif sq in seq_to_slot:
                recs.append((sq, False, seq_to_slot[sq]))
            else:
                lost += 1
        self.sync_lost_keyframes += lost
        if not recs:
            self._synced_total = total
            return 0
        new_q = np.stack([h["ob_q"][i] if ob else h["q"][i]
                          for _, ob, i in recs])
        new_p = np.stack([h["ob_p"][i] if ob else h["p"][i]
                          for _, ob, i in recs])
        new_slots = np.asarray([h["ob_slot"][i] if ob else i
                                for _, ob, i in recs])
        xyz_new = valid_new = None
        if self.archive is not None or self.desc_store is not None:
            with span("sync_clouds"):
                from_ob = np.asarray([ob for _, ob, _ in recs])
                ob_sel = to_device(np.asarray(
                    [i if ob else 0 for _, ob, i in recs]), self.device)
                kf_sel = to_device(np.asarray(
                    [0 if ob else i for _, ob, i in recs]), self.device)
                c = self._fetch({"ob": st.ob_xyz[ob_sel],
                                 "kf": st.kf_xyz[kf_sel]})
                xyz_new = np.where(from_ob[:, None, None], c["ob"], c["kf"])
                valid_new = np.all(np.abs(xyz_new) < 1e5, axis=-1)
        return self._commit(new_q, new_p, new_slots, xyz_new, valid_new,
                            int(h["n_nodes"]), total)

    def _commit(self, new_q, new_p, new_slots, xyz_new, valid_new,
                node: int, total: int) -> int:
        """Append the drained keyframes: capacity growth by doubling, the
        node/edge-chain append, slot <-> node bookkeeping, the archive fuse
        and the descriptors."""
        count = len(new_q)
        cap_n = self.graph.node_q.shape[0]
        cap_e = self.graph.edge_i.shape[0]
        need_n, need_e = node + count, self._edges_host + count + 4
        while cap_n < need_n:
            cap_n *= 2
        # edge capacity rides node capacity (a chain edge per node plus
        # closure edges)
        cap_e = max(cap_e, 2 * cap_n)
        while cap_e < need_e:
            cap_e *= 2
        self.graph = pg.grow(self.graph, max_nodes=cap_n, max_edges=cap_e)
        self.max_graph_nodes = cap_n

        have_prev = self._last_kf_pose is not None
        self.graph = pg.add_nodes_chain(
            self.graph, new_q, new_p, count,
            prev_q=self._last_kf_pose[0] if have_prev else None,
            prev_p=self._last_kf_pose[1] if have_prev else None)
        self._edges_host += count - (0 if have_prev else 1)

        node_ids = list(range(node, node + count))
        for k, s in enumerate(new_slots):
            s = int(s)
            old_node = self._slot_node.get(s)
            if old_node is not None:
                self._node_slot.pop(old_node, None)    # slot evicted
            self._slot_node[s] = node_ids[k]
            self._node_slot[node_ids[k]] = s
        self._last_kf_pose = (new_q[-1].copy(), new_p[-1].copy())

        if self.archive is not None:
            with span("archive_add"):
                self.archive.add_batch(node_ids, new_q, new_p, xyz_new,
                                       valid_new)
        if self.desc_store is not None:
            with span("desc_add"):
                descs = []
                for k in range(count):
                    local = (xyz_new[k] - new_p[k]) @ quat_to_mat_np(new_q[k])
                    descs.append(ring_descriptor(local, valid_new[k]))
                self.desc_store.add_batch(node_ids, descs)
        self._synced_total = total
        return count

    def maybe_close_loop(self) -> bool:
        """Detect, verify and apply one loop closure for the latest
        keyframe. Candidates: pose proximity over the resident store, then
        temporally consistent descriptor matches over every keyframe ever
        created (the matched yaw shift seeds the GICP guess); both go
        through the same verification and drift-budget gates. Returns True
        if a closure was applied."""
        if not self.enable_loop_closure:
            return False
        if self.pipelined:
            self.sync_pipelined()
        else:
            self.sync_graph()
        st = self.odometry.state
        if self._synced_total < self.loop_min_gap + 2:
            return False
        kh = self._kf_host
        if kh is None:
            return False    # no completed sync yet (first pipelined call)
        seq, kf_p_h = kh["seq"], kh["p"]
        cur = int(np.argmax(seq))
        if cur not in self._slot_node:
            return False            # not synced into the graph (yet)
        cur_node = self._slot_node[cur]

        # 1) descriptor queries for every not-yet-queried keyframe, before
        # the proximity attempt (an early return must not starve the match
        # history)
        matched = []
        if self.desc_store is not None:
            if self._pending_desc is not None:
                nodes_q, handle = self._pending_desc
                self._pending_desc = None
                with span("desc_query"):
                    self._syncs.n += 1
                    res = self.desc_store.query_batch_finish(handle)
                self._record_desc_results(nodes_q, res, matched)
            start = self._last_desc_query_node + 1
            end = min(cur_node, self.desc_store.count - 1)
            chunks = [np.arange(c0, min(c0 + 63, end) + 1)
                      for c0 in range(start, end + 1, 64)]
            sync_chunks = chunks[:-1] if self.pipelined else chunks
            for nodes_q in sync_chunks:
                with span("desc_query"):
                    self._syncs.n += 1
                    res = self.desc_store.query_batch(
                        nodes_q, nodes_q - self.loop_min_gap)
                self._last_desc_query_node = int(nodes_q[-1])
                self._record_desc_results(nodes_q, res, matched)
            if self.pipelined and chunks:
                nodes_q = chunks[-1]
                with span("desc_dispatch"):
                    handle = self.desc_store.query_batch_start(
                        nodes_q, nodes_q - self.loop_min_gap)
                self._pending_desc = (nodes_q, handle)
                self._last_desc_query_node = int(nodes_q[-1])

        # 2) proximity candidate; one retry after an exact resync when the
        # attempt lost its seq-guard race
        for _retry in range(2):
            cand, prox_ok = pg.detect_loop_candidate_np(
                kf_p_h, seq, kh["count"], cur, self.loop_radius,
                self.loop_min_gap)
            if not (prox_ok and cand in self._slot_node):
                break
            if self._attempt_closure(
                    cur_node, self._slot_node[cand],
                    st.kf_xyz[cur], st.kf_valid[cur], st.kf_cov[cur],
                    kh["q"][cur], kf_p_h[cur],
                    st.kf_xyz[cand], st.kf_cov[cand],
                    kh["q"][cand], kf_p_h[cand],
                    guard_slots=((cur, int(seq[cur])),
                                 (cand, int(seq[cand])))):
                return True
            if not self._attempt_raced:
                break
            self.sync_graph()            # exact: refresh metadata + guards
            kh = self._kf_host
            seq, kf_p_h = kh["seq"], kh["p"]
            cur = int(np.argmax(seq))
            if cur not in self._slot_node:
                break
            cur_node = self._slot_node[cur]

        # 3) descriptor candidates (two consecutive keyframes matching the
        # same place); matches are one-shot, so re-establish exact
        # metadata first on the pipelined path
        if matched and self.pipelined:
            self.sync_graph()
        for n, cand, shift in matched:
            cur_data = self._candidate_data(n)
            if cur_data[0] is None:
                continue
            cand_data = self._candidate_data(cand)
            if cand_data[0] is None:
                continue
            cur_xyz2, cur_cov2, cur_q2, cur_p2, cur_valid2, cur_guard = \
                cur_data
            cand_xyz, cand_cov, cand_q, cand_p, _, cand_guard = cand_data
            guards = tuple(g for g in (cur_guard, cand_guard)
                           if g is not None)
            if self._attempt_descriptor_closure(
                    n, cand, shift,
                    cur_xyz2, cur_valid2, cur_cov2, cur_q2, cur_p2,
                    cand_xyz, cand_cov, cand_q, cand_p, guards,
                    cand_archived=cand_guard is None,
                    cur_archived=cur_guard is None):
                return True
        return False

    def _record_desc_results(self, nodes_q, res, matched) -> None:
        """Fold one completed query batch into the match history and the
        temporally consistent candidate list."""
        cands, scores, shifts = res
        for k, n in enumerate(nodes_q):
            n, cand = int(n), int(cands[k])
            score, shift = float(scores[k]), int(shifts[k])
            self.desc_log.append({"node": n, "cand": cand,
                                  "score": round(score, 4)})
            if cand < 0 or score < self.desc_min_score:
                continue
            prev = self._desc_match_hist.get(n - 1)
            self._desc_match_hist[n] = (cand, shift)
            if prev is None or abs(cand - prev[0]) > 5:
                continue    # not yet temporally consistent
            matched.append((n, cand, shift))

    def _attempt_descriptor_closure(self, node, cand, shift,
                                    cur_xyz, cur_valid, cur_cov,
                                    cur_q, cur_p,
                                    cand_xyz, cand_cov, cand_q,
                                    cand_p, guard_slots=(),
                                    cand_archived: bool = False,
                                    cur_archived: bool = False) -> bool:
        """Seed GICP with the descriptor's yaw shift (R_true = R_cand
        Rz(psi), psi = 2 pi shift / S; host maths) and run the common
        verification and gates."""
        psi = 2.0 * np.pi * shift / N_SECTORS
        if psi > np.pi:
            psi -= 2.0 * np.pi
        Rz = np.eye(4, dtype=np.float32)
        Rz[0, 0] = Rz[1, 1] = np.cos(psi)
        Rz[0, 1], Rz[1, 0] = -np.sin(psi), np.sin(psi)
        guess = (make_se3_np(cand_q, cand_p) @ Rz
                 @ np.linalg.inv(make_se3_np(cur_q, cur_p))).astype(np.float32)
        applied = self._attempt_closure(
            node, cand, cur_xyz, cur_valid, cur_cov, cur_q, cur_p,
            cand_xyz, cand_cov, cand_q, cand_p,
            guess=guess, source="descriptor", guard_slots=guard_slots,
            cand_archived=cand_archived, cur_archived=cur_archived)
        if applied:
            self.loop_closures_descriptor += 1
        return applied

    def _candidate_data(self, node: int):
        """(cloud, covariances, q, p, validity, seq guard) of a graph node:
        from the resident store when its slot is live (guard = (slot,
        expected seq)), else dequantized from the archive at its exact pose
        with covariances recomputed on the device (no guard), else Nones."""
        st = self.odometry.state
        slot = self._node_slot.get(node)
        if slot is not None:
            kh = self._kf_host
            return (st.kf_xyz[slot], st.kf_cov[slot],
                    kh["q"][slot], kh["p"][slot], st.kf_valid[slot],
                    (slot, int(kh["seq"][slot])))
        if self.archive is None or node not in self.archive.entries:
            return None, None, None, None, None, None
        e = self.archive.entries[node]
        q_ex, p_ex = self.archive.pose_of(node)
        local = to_device(e.xyz_q, self.device).to(torch.float32) * e.scale
        R = quat_to_mat(to_device(q_ex, self.device))
        world = local @ R.T + to_device(p_ex, self.device)
        valid = to_device(e.valid, self.device)
        world = torch.where(valid[:, None], world, 1e6).contiguous()
        cov, _ = gicp_ops.plane_covariances(world, valid,
                                            self.cfg.gicp.k_correspondences)
        return world, cov, q_ex, p_ex, valid, None

    def _attempt_closure(self, cur_node: int, cand_node: int,
                         cur_xyz, cur_valid, cur_cov, cur_q, cur_p,
                         cand_xyz, cand_cov, cand_q, cand_p,
                         guess=None, source: str = "proximity",
                         guard_slots=(), cand_archived: bool = False,
                         cur_archived: bool = False) -> bool:
        """Verify one candidate pair and, if it passes every gate, apply
        the closure (loop edge + optimise + map deformation).
        ``guard_slots``: ((slot, expected_seq), ...) seq guards folded into
        the verdict on the device: a guarded slot evicted since the
        metadata was fetched makes the attempt read as raced."""
        st = self.odometry.state
        with span("closure_verify"):
            T_corr, accepted = pg.verify_loop(
                cur_xyz, cur_valid, cur_cov, cand_xyz, cand_cov,
                self._verify_cfg(),
                max_corr_dist=2.0 * self.cfg.gicp.max_corr_dist,
                guess=guess, syncs=self._syncs)
            seq_ok = torch.ones((), dtype=torch.bool, device=self.device)
            if guard_slots:
                # pad to 2 guards (repeat the first), as in JAX
                g = list(guard_slots) + [guard_slots[0]]
                slots = to_device(np.asarray([s for s, _ in g[:2]]),
                                  self.device)
                expects = to_device(np.asarray([e for _, e in g[:2]],
                                               np.int32), self.device)
                accepted, seq_ok = _guarded_verdict(accepted, st.kf_seq,
                                                    slots, expects)
            h = self._fetch({"accepted": accepted, "seq_ok": seq_ok,
                             "T": T_corr})
        self._attempt_raced = not bool(h["seq_ok"])
        if self._attempt_raced:
            self.loop_raced += 1
            return False
        if not bool(h["accepted"]):
            return False
        # accepted: re-establish the exact sync invariant before mutating
        # the graph and the state
        self.sync_graph()

        # corrected world pose of the current keyframe; the loop edge
        # measures candidate -> corrected-current
        kq_u, kp_u = np.asarray(cur_q), np.asarray(cur_p)
        T_fix = np.asarray(h["T"]) @ make_se3_np(kq_u, kp_u)
        p_fix = T_fix[:3, 3]

        # drift budget: correction against the path length between the two
        # nodes along the graph's insertion-ordered chain
        with span("closure_budget_fetch"):
            node_p = self._fetch({"p": self.graph.node_p})["p"]
        lo, hi = min(cand_node, cur_node), max(cand_node, cur_node)
        path_len = float(np.sum(np.linalg.norm(
            np.diff(node_p[lo: hi + 1], axis=0), axis=-1)))
        budget = max(self.drift_budget_frac * path_len,
                     self.drift_budget_min)
        correction = float(np.linalg.norm(np.asarray(p_fix) - kp_u))
        if correction > budget:
            self.loop_rejected_budget += 1
            return False
        if correction < self.min_closure_correction:
            self.loop_skipped_small += 1     # verified but uninformative
            return False

        T_rel = np.linalg.inv(make_se3_np(cand_q, cand_p)) @ T_fix
        dq = to_device(mat_to_quat_np(T_rel[:3, :3]), self.device)
        dp = to_device(T_rel[:3, 3].astype(np.float32), self.device)
        if self._edges_host + 1 > self.graph.edge_i.shape[0]:
            self.graph = pg.grow(self.graph,
                                 max_edges=2 * self.graph.edge_i.shape[0])
        with span("closure_add_edge"):
            self.graph = pg.add_edge(self.graph, cand_node, cur_node, dq, dp,
                                     w_rot=2.0, w_trans=2.0)
        self._edges_host += 1

        t0 = time.perf_counter()
        with span("closure_optimize"):
            # solver by the live node count; large corrections run more
            # passes of the same 3-step solve
            n_live = max(self._synced_total, 1)
            for _ in range(3 if correction > 0.5 else 1):
                self._optimize_graph(n_live)
        t1 = time.perf_counter()
        moved = self._apply_graph_to_state()
        t2 = time.perf_counter()
        if self.enable_tsdf and self.device.type == "cuda":
            self._syncs.n += 1
            torch.cuda.synchronize(self.device)
        t3 = time.perf_counter()
        self.closure_log.append({
            "source": source,
            "cand_archived": cand_archived,
            "cur_archived": cur_archived,
            "cand_node": int(cand_node), "cur_node": int(cur_node),
            "correction_m": round(correction, 4),
            "moved_keyframes": moved,
            "archived": 0 if self.archive is None else len(self.archive),
            "seconds": t3 - t0,
            "t_optimize": round(t1 - t0, 3),
            "t_apply": round(t2 - t1, 3),
            "t_map_sync": round(t3 - t2, 3)})
        self.loop_closures += 1
        return True

    def _apply_graph_to_state(self) -> int:
        """Write the optimised keyframe poses back into the odometry state
        (``_deform_state``) and correct the dense map: the archive's
        O(moved) re-fusion and its snapshot, or without an archive a
        rebuild from the resident keyframes. Returns the number of
        archived keyframes re-fused."""
        st = self.odometry.state
        g = self.graph
        with span("closure_fetch_poses"):
            h = self._fetch({"node_q": g.node_q, "node_p": g.node_p,
                             "kf_q": st.kf_quat, "kf_p": st.kf_pos})
        node_q, node_p = h["node_q"], h["node_p"]
        new_q, new_p = np.array(h["kf_q"]), np.array(h["kf_p"])
        for slot, node in self._slot_node.items():
            new_q[slot] = node_q[node]
            new_p[slot] = node_p[node]
        # the odometry-edge chain measures from the newest keyframe's pose
        if self._last_kf_pose is not None and self._slot_node:
            last_slot = max(self._slot_node,
                            key=lambda s: self._slot_node[s])
            self._last_kf_pose = (new_q[last_slot].copy(),
                                  new_p[last_slot].copy())

        with span("closure_deform"):
            self.odometry.state = _deform_state(
                st, to_device(new_q, self.device),
                to_device(new_p, self.device))

        moved = 0
        if self.enable_tsdf and self.odometry.tsdf_state is not None:
            st2 = self.odometry.state
            if self.archive is not None:
                with span("archive_apply"):
                    moved = self.archive.apply_poses(
                        node_q, node_p, eps_t=self.archive_eps_t,
                        eps_r=self.archive_eps_r)
                with span("archive_snapshot"):
                    self.odometry.tsdf_state = self.archive.snapshot_live()
            elif self.cfg.map_backend == "occupancy":
                self.odometry.tsdf_state = occ_mod.rebuild_from_keyframes(
                    self.cfg.occupancy, st2.kf_xyz, st2.kf_valid,
                    st2.kf_pos, st2.kf_count)
            else:
                self.odometry.tsdf_state = tsdf_mod.rebuild_from_keyframes(
                    self.cfg.tsdf, st2.kf_xyz, st2.kf_valid, st2.kf_pos,
                    st2.kf_count)
        # the host stash and any pending gather hold pre-closure poses
        self._kf_host = None
        self._pending_sync = None
        return moved

    def set_keyframe_poses(self, node_q, node_p) -> int:
        """Move every synced keyframe to the given poses (host (n, 4) wxyz
        and (n, 3), one row per graph node) as if the odometry had reported
        them: the graph becomes a chain of odometry edges measured from
        these poses, with no closure edge, and the state, the archive and
        the map follow through the closure's own deformation path. Gives a
        loop closure a drift of known size to correct. Returns the number of
        archived keyframes re-fused."""
        n = self._synced_total
        node_q = np.asarray(node_q, np.float32)[:n]
        node_p = np.asarray(node_p, np.float32)[:n]
        g = pg.init_graph(self.graph.node_q.shape[0],
                          self.graph.edge_i.shape[0], device=self.device)
        self.graph = pg.add_nodes_chain(g, node_q, node_p, n)
        self._edges_host = n - 1
        self._last_kf_pose = (node_q[-1].copy(), node_p[-1].copy())
        return self._apply_graph_to_state()

    # --------------------------------------------------- checkpoint/resume
    def save(self, path: str) -> None:
        """Checkpoint the full system: the odometry state, the map, the
        pose graph, the slot -> node bookkeeping, the archive and the
        descriptors (``runtime.checkpoint``'s layout, the JAX package's)."""
        lkp = self._last_kf_pose
        extra_arrays = {}
        if self.archive is not None:
            extra_arrays.update({f"archive_{k}": v
                                 for k, v in self.archive.pack().items()})
        if self.desc_store is not None:
            extra_arrays.update({f"desc_{k}": v
                                 for k, v in self.desc_store.pack().items()})
        ck.save_pipeline(
            path, self.odometry, self.tsdf, self.graph,
            extra_host={"slam": {
                "slot_node": {str(k): int(v)
                              for k, v in self._slot_node.items()},
                "synced_total": self._synced_total,
                "loop_closures": self.loop_closures,
                "loop_closures_descriptor": self.loop_closures_descriptor,
                "loop_rejected_budget": self.loop_rejected_budget,
                "loop_raced": self.loop_raced,
                "loop_skipped_small": self.loop_skipped_small,
                "sync_lost_keyframes": self.sync_lost_keyframes,
                "last_kf_pose": (None if lkp is None else
                                 [np.asarray(lkp[0]).tolist(),
                                  np.asarray(lkp[1]).tolist()]),
            }},
            extra_arrays=extra_arrays or None)

    def load(self, path: str) -> None:
        """Resume from a checkpoint written by ``save`` of either package."""
        tsdf_state, graph = ck.load_pipeline(path, self.odometry)
        if tsdf_state is not None:
            self.odometry.tsdf_state = tsdf_state
        if graph is not None:
            self.graph = graph
            self.max_graph_nodes = self.graph.node_q.shape[0]
        _, _, _, host = ck.load_checkpoint(path, self.device)
        s = host.get("slam", {})
        self._slot_node = {int(k): int(v)
                           for k, v in s.get("slot_node", {}).items()}
        self._synced_total = int(s.get("synced_total", 0))
        self.loop_closures = int(s.get("loop_closures", 0))
        self.loop_closures_descriptor = int(
            s.get("loop_closures_descriptor", 0))
        self.loop_rejected_budget = int(s.get("loop_rejected_budget", 0))
        self.loop_raced = int(s.get("loop_raced", 0))
        self.loop_skipped_small = int(s.get("loop_skipped_small", 0))
        self.sync_lost_keyframes = int(s.get("sync_lost_keyframes", 0))
        lkp = s.get("last_kf_pose")
        self._last_kf_pose = (None if lkp is None else
                              (np.asarray(lkp[0]), np.asarray(lkp[1])))
        self._kf_host = None
        self._pending_sync = None
        if self.archive is not None or self.desc_store is not None:
            extra = ck.load_extra_arrays(path)
            if self.archive is not None:
                self.archive.unpack({k[len("archive_"):]: v
                                     for k, v in extra.items()
                                     if k.startswith("archive_")})
            if self.desc_store is not None:
                self.desc_store.unpack({k[len("desc_"):]: v
                                        for k, v in extra.items()
                                        if k.startswith("desc_")})
        self._node_slot = {v: k for k, v in self._slot_node.items()}
        # a resumed session does not re-query the history
        self._last_desc_query_node = (
            self.desc_store.count - 1 if self.desc_store is not None
            else -1)
        self._desc_match_hist = {}
        self._pending_desc = None

    # ----------------------------------------------------- IMU-rate pose
    def enable_pose_extrapolation(self) -> None:
        """Host-side IMU-rate pose output (``runtime.poseext``), seeded by
        every sync drain."""
        self.extrapolator = PoseExtrapolator(self.cfg, self.odometry)

    def pose_at(self, t: float):
        """(q wxyz, p) extrapolated to absolute time ``t`` (None before the
        first drained sync or without ``enable_pose_extrapolation``)."""
        if self.extrapolator is None:
            return None
        return self.extrapolator.pose_at(t)

    # ------------------------------------------------------------- results
    def flush(self):
        return self.odometry.flush()

    def surface_points(self, min_weight: float = 1.0) -> np.ndarray:
        """The dense map's surface (TSDF zero crossing) or occupied voxel
        centres, as a host array."""
        if self.tsdf is None:
            return np.zeros((0, 3), np.float32)
        if self.cfg.map_backend == "occupancy":
            centers, _, mask = occ_mod.extract_occupied(self.cfg.occupancy,
                                                        self.tsdf)
        else:
            centers, _, mask = tsdf_mod.extract_surface(
                self.cfg.tsdf, self.tsdf, min_weight=min_weight)
        return centers[mask].cpu().numpy()
