"""Rotation-invariant place-recognition descriptors, scan-context class (port
of ``noetic_slam_tpu.models.placedesc``).

Same design as the JAX module: an (R rings x S sectors) max-height polar
grid per keyframe, computed once on the host (``ring_descriptor``, the
port's own copy, held to the original by ``tests/test_torch_copies.py``);
matching L2-normalises each sector column, so the scan-context distance
under every yaw shift is one plain product of the rolled query stack and
the store, done in f32 by ``torch.matmul`` (JAX runs it outside any Pallas
kernel too). The store lives on the device with doubling capacity; new
rows upload at query time.

``query_batch_start`` queues the match and a non-blocking copy of its
packed result (``utils.host.PendingFetch``); ``query_batch_finish`` waits
for that copy alone, an attempt later on the pipelined closure path.
"""

from __future__ import annotations

import numpy as np
import torch

from noetic_slam_tpu_torch import resolve_device
from noetic_slam_tpu_torch.utils.host import PendingFetch, to_device

Tensor = torch.Tensor

N_RINGS = 20
N_SECTORS = 60


def ring_descriptor(xyz: np.ndarray, valid: np.ndarray,
                    max_range: float = 40.0,
                    n_rings: int = N_RINGS,
                    n_sectors: int = N_SECTORS) -> np.ndarray:
    """(R, S) max-height polar grid of one LOCAL-frame keyframe cloud
    (host numpy — runs once per keyframe at archive time)."""
    pts = np.asarray(xyz, np.float32)[np.asarray(valid, bool)]
    if len(pts) == 0:
        return np.zeros((n_rings, n_sectors), np.float32)
    r = np.linalg.norm(pts[:, :2], axis=-1)
    keep = (r > 0.3) & (r < max_range)
    pts, r = pts[keep], r[keep]
    if len(pts) == 0:
        return np.zeros((n_rings, n_sectors), np.float32)
    ring = np.minimum((r / max_range * n_rings).astype(np.int64),
                      n_rings - 1)
    sector = ((np.arctan2(pts[:, 1], pts[:, 0]) + np.pi)
              / (2 * np.pi) * n_sectors).astype(np.int64) % n_sectors
    desc = np.zeros((n_rings, n_sectors), np.float32)
    np.maximum.at(desc, (ring, sector), pts[:, 2])
    return desc


def _normalize_columns(d: Tensor) -> Tensor:
    """L2-normalise each sector column; all-empty columns -> 0."""
    n = torch.linalg.vector_norm(d, dim=-2, keepdim=True)
    return torch.where(n > 1e-6, d / torch.clamp(n, min=1e-6), 0.0)


def match_store_batch(queries: Tensor, store: Tensor, count,
                      exclude_froms: Tensor) -> Tensor:
    """Best-matching stored descriptor for each of B queries under all yaw
    shifts. ``queries (B, R, S)``, ``store (K, R, S)`` (rows below
    ``count`` valid); store rows at or beyond a query's ``exclude_from``
    are ignored. Returns one packed (B, 3) f32 tensor [node, score, shift]
    (small ints, exact in f32); the score is the mean per-sector cosine at
    the best circular shift, over the query's occupied columns."""
    B, R, S = queries.shape
    qn = _normalize_columns(queries)
    rolled = torch.stack([torch.roll(qn, j, dims=-1) for j in range(S)],
                         dim=1)                                # (B, S, R, S)
    sn = _normalize_columns(store).reshape(store.shape[0], R * S)
    scores = (rolled.reshape(B * S, R * S) @ sn.T).reshape(B, S, -1)
    q_cols = torch.any(queries > 1e-6, dim=-2).sum(dim=-1)      # (B,)
    scores = scores / torch.clamp(q_cols.to(torch.float32), min=1.0
                                  )[:, None, None]
    best_k, best_shift = torch.max(scores, dim=1)               # (B, K)
    ids = torch.arange(store.shape[0], device=store.device)
    eligible = (ids[None] < count) & (ids[None] < exclude_froms[:, None])
    best_k = torch.where(eligible, best_k, -1.0)
    score, node = torch.max(best_k, dim=1)
    shift = torch.gather(best_shift, 1, node[:, None])[:, 0]
    return torch.stack([node.to(torch.float32), score,
                        shift.to(torch.float32)], dim=-1)


def match_store(query: Tensor, store: Tensor, count, exclude_from):
    """``match_store_batch`` for one (R, S) query: (node, score, shift)."""
    exc = torch.as_tensor(exclude_from, device=store.device).reshape(1)
    node, score, shift = match_store_batch(query[None], store, count,
                                           exc)[0]
    return node.to(torch.int64), score, shift.to(torch.int64)


class DescriptorStore:
    """Host + device store of per-keyframe descriptors with doubling
    capacity; matching runs on the device against the full history."""

    def __init__(self, cap: int = 4096, device=None):
        self.device = resolve_device(device)
        # 4096 x (20 x 60) f32 = 20 MB: km-scale capacity up front
        self._host = np.zeros((cap, N_RINGS, N_SECTORS), np.float32)
        self._dev = to_device(self._host, self.device)
        self._pending: list = []      # host rows written since last upload
        self.count = 0

    def add(self, node: int, desc: np.ndarray) -> None:
        """Record one descriptor (host write; the device copy uploads at
        the next query)."""
        cap = self._host.shape[0]
        if node >= cap:
            while cap <= node:
                cap *= 2
            grown = np.zeros((cap, N_RINGS, N_SECTORS), np.float32)
            grown[: self._host.shape[0]] = self._host
            self._host = grown
            self._dev = None          # capacity changed: full re-upload
        self._host[node] = desc
        self._pending.append(node)
        self.count = max(self.count, node + 1)

    def add_batch(self, nodes, descs) -> None:
        for node, d in zip(nodes, descs):
            self.add(int(node), d)

    def _sync_dev(self) -> None:
        if self._dev is None:
            self._dev = to_device(self._host, self.device)
            self._pending = []
        elif self._pending:
            idx = np.asarray(sorted(set(self._pending)), np.int64)
            self._dev[to_device(idx, self.device)] = to_device(
                self._host[idx], self.device)
            self._pending = []

    def query(self, desc: np.ndarray, min_gap: int = 0,
              exclude_from: int | None = None):
        """(node, score, shift) of the best historical match. Eligible
        nodes are ids below ``exclude_from`` (default count - min_gap)."""
        if exclude_from is None:
            exclude_from = self.count - min_gap
        if exclude_from <= 0 or self.count == 0:
            return -1, 0.0, 0
        cands, scores, shifts = self.query_batch([0], [exclude_from],
                                                 queries=desc[None])
        return int(cands[0]), float(scores[0]), int(shifts[0])

    def query_batch_start(self, node_ids, exclude_froms, queries=None):
        """Queue the batched match of the stored descriptors of
        ``node_ids`` (or of ``queries (B, R, S)`` when given) and the copy
        of its result to the host; returns the handle for
        ``query_batch_finish``. The batch is padded to a power-of-two
        bucket of at least 4 (padding rows are never eligible), as in
        JAX."""
        B = len(node_ids)
        if B == 0 or self.count == 0:
            return (None, B, None)
        self._sync_dev()
        m = max(4, 1 << (B - 1).bit_length())
        q = np.zeros((m, N_RINGS, N_SECTORS), np.float32)
        q[:B] = (self._host[np.asarray(node_ids, np.int64)] if queries is None
                 else np.asarray(queries, np.float32))
        exc = np.zeros((m,), np.int64)
        exc[:B] = np.asarray(exclude_froms, np.int64)
        packed = match_store_batch(
            to_device(q, self.device), self._dev, self.count,
            to_device(np.maximum(exc, 0), self.device))
        return (PendingFetch({"packed": packed}), B, exc)

    @staticmethod
    def query_batch_finish(pending):
        """Complete a ``query_batch_start`` handle: host arrays (cands,
        scores, shifts), one row per query; queries whose exclude_from <= 0
        return cand -1."""
        fetch, B, exc = pending
        if fetch is None:
            return (np.full(B, -1, np.int64), np.zeros(B, np.float32),
                    np.zeros(B, np.int64))
        packed = fetch.wait()["packed"]
        cands = np.where(exc[:B] > 0, packed[:B, 0].astype(np.int64), -1)
        return (cands, packed[:B, 1].astype(np.float32),
                packed[:B, 2].astype(np.int64))

    def query_batch(self, node_ids, exclude_froms, queries=None):
        """``query_batch_start`` and ``query_batch_finish`` at once."""
        return self.query_batch_finish(
            self.query_batch_start(node_ids, exclude_froms, queries))

    # ------------------------------------------------------- persistence
    def pack(self) -> dict:
        return {"desc": self._host[: self.count].copy()}

    def unpack(self, data: dict) -> None:
        d = np.asarray(data.get("desc", np.zeros((0, N_RINGS, N_SECTORS),
                                                 np.float32)), np.float32)
        cap = 256
        while cap < max(len(d), 1):
            cap *= 2
        self._host = np.zeros((cap, N_RINGS, N_SECTORS), np.float32)
        self._host[: len(d)] = d
        self._dev = to_device(self._host, self.device)
        self._pending = []
        self.count = len(d)
