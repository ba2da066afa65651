"""The world along the path, as rectangles: ground tiles, building faces
cut into panels, and boxes (cars, kiosks, crates), from the traffic file's
``scene`` object.

A rectangle is its centre ``c``, two half-edge vectors ``u``, ``v`` and
its unit normal; its points are ``c + a u + b v`` for ``a, b`` in
[-1, 1]. Every surface is exact, so the sampled points lie on it.

The staircase's scene is made one straight at a time, from a generator
seeded by ``(seed, straight index)``, when the sensor comes within range
of it: the sequence is endless and each piece is the same whatever order
it is asked for in. Buildings line each straight and run on past both
ends, and any building or box that would come within ``clear_path`` of
the path (the turns included) is left out.
"""

from __future__ import annotations

import numpy as np

from benchmark.gen.path import Path


class Rects:
    """Rectangles in arrays: ``c``, ``u``, ``v``, ``n`` (m, 3), ``area``."""

    def __init__(self, c, u, v):
        self.c = np.asarray(c, np.float64).reshape(-1, 3)
        self.u = np.asarray(u, np.float64).reshape(-1, 3)
        self.v = np.asarray(v, np.float64).reshape(-1, 3)
        n = np.cross(self.u, self.v)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        self.n = n / np.clip(ln, 1e-12, None)
        self.area = 4.0 * ln[:, 0]

    @staticmethod
    def cat(parts):
        parts = [p for p in parts if len(p.c)]
        if not parts:
            return Rects(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)))
        return Rects(np.concatenate([p.c for p in parts]),
                     np.concatenate([p.u for p in parts]),
                     np.concatenate([p.v for p in parts]))


def _wall(p0, p1, z0, z1, panel):
    """A vertical wall from ``p0`` to ``p1`` (xy) between heights z0, z1,
    cut into panels no wider than ``panel``."""
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    length = float(np.linalg.norm(p1 - p0))
    k = max(int(np.ceil(length / panel)), 1)
    f = (np.arange(k) + 0.5) / k
    mid = p0[None] + f[:, None] * (p1 - p0)[None]
    d = (p1 - p0) / max(length, 1e-9)
    c = np.c_[mid, np.full(k, 0.5 * (z0 + z1))]
    u = np.tile(np.r_[d * 0.5 * length / k, 0.0], (k, 1))
    v = np.tile([0.0, 0.0, 0.5 * (z1 - z0)], (k, 1))
    return Rects(c, u, v)


def _ground(origin, d, lat, s_lo, s_hi, w, tile):
    """Ground tiles over [s_lo, s_hi] x [-w, w] in the frame of a straight
    (start ``origin``, direction ``d``, left normal ``lat``)."""
    ns = max(int(np.ceil((s_hi - s_lo) / tile)), 1)
    nw = max(int(np.ceil(2 * w / tile)), 1)
    ds, dw = (s_hi - s_lo) / ns, 2 * w / nw
    ss = s_lo + (np.arange(ns) + 0.5) * ds
    ww = -w + (np.arange(nw) + 0.5) * dw
    S, W = np.meshgrid(ss, ww, indexing="ij")
    c = (origin[None, :2] + S.reshape(-1, 1) * d[None, :2]
         + W.reshape(-1, 1) * lat[None, :2])
    m = len(c)
    return Rects(np.c_[c, np.zeros(m)],
                 np.tile(np.r_[d[:2] * ds / 2, 0.0], (m, 1)),
                 np.tile(np.r_[lat[:2] * dw / 2, 0.0], (m, 1)))


def _box(center_xy, yaw, size, panel):
    """The four sides and the top of a box standing on the ground."""
    sx, sy, sz = size
    c, s = np.cos(yaw), np.sin(yaw)
    ax, ay = np.array([c, s]), np.array([-s, c])
    o = np.asarray(center_xy, float)
    corners = [o + ax * sx / 2 + ay * sy / 2, o - ax * sx / 2 + ay * sy / 2,
               o - ax * sx / 2 - ay * sy / 2, o + ax * sx / 2 - ay * sy / 2]
    parts = [_wall(corners[i], corners[(i + 1) % 4], 0.0, sz, panel)
             for i in range(4)]
    parts.append(Rects(np.r_[o, sz], np.r_[ax * sx / 2, 0.0],
                       np.r_[ay * sy / 2, 0.0]))
    return Rects.cat(parts)


def _outline(corners, step=1.0):
    """Points every ``step`` metres along a closed outline (xy)."""
    pts = []
    for a, b in zip(corners, corners[1:] + corners[:1]):
        a, b = np.asarray(a, float), np.asarray(b, float)
        k = max(int(np.ceil(np.linalg.norm(b - a) / step)), 1)
        pts.append(a[None] + np.linspace(0, 1, k, endpoint=False)[:, None]
                   * (b - a)[None])
    return np.concatenate(pts)


def _clears(outline, path_xy, clearance) -> bool:
    d2 = np.sum((outline[:, None, :] - path_xy[None, :, :]) ** 2, axis=-1)
    return bool(d2.min() >= clearance * clearance)


def _buildings(rng, origin, d, lat, side, s_lo, s_hi, sc, path_xy):
    """A row of buildings on one side (+1 left, -1 right) of a straight:
    front face, the two side faces, cut into panels; those that would not
    clear the path are left out."""
    parts = []
    s = s_lo + rng.uniform(0, sc["gap"][1])
    depth, panel = float(sc["depth"]), float(sc["panel"])
    while True:
        front = rng.uniform(*sc["frontage"])
        if s + front > s_hi:
            break
        back = rng.uniform(*sc["setback"])
        h = rng.uniform(*sc["height"])
        a = origin[:2] + d[:2] * s + lat[:2] * side * back
        b = a + d[:2] * front
        ad, bd = a + lat[:2] * side * depth, b + lat[:2] * side * depth
        if _clears(_outline([a, b, bd, ad]), path_xy, sc["clear_path"]):
            parts += [_wall(a, b, 0.0, h, panel),
                      _wall(a, ad, 0.0, h, panel),
                      _wall(b, bd, 0.0, h, panel)]
        s += front + rng.uniform(*sc["gap"])
    return parts


def _boxes(rng, origin, d, lat, length, sc, path_xy):
    n = rng.poisson(sc["boxes_per_100m"] * length / 100.0)
    parts = []
    for _ in range(n):
        s = rng.uniform(0, length)
        side = 1.0 if rng.random() < 0.5 else -1.0
        off = rng.uniform(*sc["box_offset"])
        size = [rng.uniform(*sc["box_size"][k]) for k in range(3)]
        yaw = np.arctan2(d[1], d[0]) + rng.normal(0.0, 0.1)
        xy = origin[:2] + d[:2] * s + lat[:2] * side * off
        box = _box(xy, yaw, size, float(sc["panel"]))
        if _clears(box.c[:, :2], path_xy, 0.5 * sc["clear_path"]):
            parts.append(box)
    return parts


def _straight_frame(path: Path, k: int):
    h = path.seg_h0[k]
    origin = np.array([path.seg_x0[k], path.seg_y0[k], 0.0])
    d = np.array([np.cos(h), np.sin(h), 0.0])
    lat = np.array([-np.sin(h), np.cos(h), 0.0])
    return origin, d, lat


class Scene:
    """The rectangles near a point of the path, made on demand."""

    def __init__(self, path: Path, params: dict, seed: int):
        self.path, self.sc, self.seed = path, params, seed
        self._pieces: dict = {}

    def _path_xy(self, s0: float, s1: float) -> np.ndarray:
        s = np.arange(s0, s1, 0.5)
        s = s[s >= 0.0]
        x, y, _, _ = self.path.planar(s)
        return np.stack([x, y], axis=-1)

    def _straight_piece(self, k: int) -> Rects:
        """Ground, buildings and boxes of straight segment ``k`` and of the
        crossing at its far end."""
        path, sc = self.path, self.sc
        rng = np.random.default_rng([self.seed, 2, k])
        origin, d, lat = _straight_frame(path, k)
        length = path.seg_len[k]
        r = path.turn_len
        w = float(sc["ground_halfwidth"])
        reach = r + sc["setback"][1] + sc["depth"] + 10.0
        s0 = path.seg_s0[k]
        path_xy = self._path_xy(s0 - 2 * reach, s0 + length + 2 * reach)
        parts = [_ground(origin, d, lat, -r, length + r + w, w,
                         float(sc["tile"]))]
        for side in (1.0, -1.0):
            parts += _buildings(rng, origin, d, lat, side, -reach,
                                length + reach, sc, path_xy)
        parts += _boxes(rng, origin, d, lat, length, sc, path_xy)
        return Rects.cat(parts)

    def near(self, s: float, reach: float) -> Rects:
        """Every rectangle of the pieces within arc length ``reach`` of
        ``s``."""
        path = self.path
        path.ensure(s + reach + 1.0)
        lo = np.searchsorted(path.seg_s0 + path.seg_len, s - reach)
        hi = np.searchsorted(path.seg_s0, s + reach, side="right")
        keys = [k for k in range(max(lo - 1, 0), hi)
                if path.seg_turn[k] == 0.0]
        for k in list(self._pieces):
            if k < min(keys, default=0) - 2:
                del self._pieces[k]
        for k in keys:
            if k not in self._pieces:
                self._pieces[k] = self._straight_piece(k)
        return Rects.cat([self._pieces[k] for k in keys])
