"""A plain TSDF fusion: the map a configuration states, worked out again in
float64 from world-frame points (plain PyTorch; nothing of the program).

The model is the one the configuration's ``tsdf`` group states: per ray,
a band of samples at voxel spacing over [-truncation, +truncation] about
the hit, weight 1 in front and tapering to 0.05 behind, and with
``space_carving`` as many free-space samples of weight 0.1 between the
sensor and the band; rays shorter than 0.3 m or longer than ``max_range``
carry nothing; a voxel's (weight, weight x distance) are sums clamped at
``max_weight`` after each scan (the sum rescaled with the weight). Two
capacity rules of the configuration are kept: a scan touches at most
``scan_block_cap`` blocks of 8^3 voxels, the lowest in the block key's
order (blocks past it are dropped), and the map holds at most
``max_blocks`` blocks (new blocks past it are dropped, in key order).
"""

from __future__ import annotations

import torch

KEY_PAD = 2 ** 31 - 1
_OFF = 1 << 20


def block_key(b: torch.Tensor) -> torch.Tensor:
    """Block coordinates (..., 3) int64 -> the map's 32-bit block key (as
    int64; wrapped to its signed value), whose order sets which blocks a
    scan past its cap drops; out of range -> KEY_PAD."""
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    ok = ((bx >= -1024) & (bx < 1024) & (by >= -1024) & (by < 1024)
          & (bz >= -512) & (bz < 512))
    key = ((bz + 512) << 22) | ((by + 1024) << 11) | (bx + 1024)
    key = torch.where(key >= 2 ** 31, key - 2 ** 32, key)
    return torch.where(ok, key, KEY_PAD)


def voxel_id(v: torch.Tensor) -> torch.Tensor:
    """Integer voxel coordinates (..., 3) -> one int64."""
    return (((v[..., 0] + _OFF) << 42) | ((v[..., 1] + _OFF) << 21)
            | (v[..., 2] + _OFF))


class ReferenceTsdf:
    """``cfg``: the configuration's ``tsdf`` group (a dict).
    ``round_fn``, when given, rounds every sample position (the control's
    lower precision)."""

    def __init__(self, cfg: dict, device, round_fn=None):
        self.vs = float(cfg["voxel_size"])
        self.trunc = float(cfg["truncation"])
        self.max_w = float(cfg["max_weight"])
        self.max_range = float(cfg["max_range"])
        self.carve = int(cfg["carving_samples"]) if cfg["space_carving"] \
            else 0
        self.cap = int(cfg["scan_block_cap"])
        self.max_blocks = int(cfg["max_blocks"])
        self.dev = device
        self.round_fn = round_fn
        f64 = dict(dtype=torch.float64, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        self.ids = torch.zeros(0, **i64)
        self.w = torch.zeros(0, **f64)
        self.ws = torch.zeros(0, **f64)
        self.blocks = torch.zeros(0, **i64)
        n_band = max(int(round(2.0 * self.trunc / self.vs)) + 1, 3)
        self.offs = torch.linspace(-self.trunc, self.trunc, n_band, **f64)

    def _samples(self, pts, valid, origin):
        d = pts - origin
        r = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        ok = valid & (r[:, 0] > 0.3) & (r[:, 0] < self.max_range)
        u = d / torch.clamp(r, min=1e-6)
        pos = pts[:, None, :] + u[:, None, :] * self.offs[None, :, None]
        sdf = (-self.offs)[None, :].expand(pts.shape[0], -1)
        w = torch.where(sdf < 0.0, 1.0 + sdf / self.trunc,
                        torch.ones_like(sdf))
        w = torch.clamp(w, min=0.05) * ok[:, None]
        if self.carve:
            S = self.carve
            frac = (torch.arange(S, dtype=torch.float64, device=self.dev)
                    + 0.5) / S
            cr = frac[None, :] * torch.clamp(r - self.trunc, min=0.0)
            cpos = origin + u[:, None, :] * cr[:, :, None]
            pos = torch.cat([pos, cpos], dim=1)
            sdf = torch.cat([sdf, torch.full_like(cr, self.trunc)], dim=1)
            w = torch.cat([w, 0.1 * ok[:, None].expand(-1, S).double()],
                          dim=1)
        return pos.reshape(-1, 3), sdf.reshape(-1), w.reshape(-1)

    def fuse(self, pts: torch.Tensor, valid: torch.Tensor,
             origin: torch.Tensor) -> None:
        """Fuse one scan: world points (n, 3) float64, their validity and
        the sensor origin (3,)."""
        pos, sdf, w = self._samples(pts, valid, origin)
        if self.round_fn is not None:
            pos = self.round_fn(pos)
        live = w != 0.0
        vox = torch.floor(pos / self.vs).to(torch.int64)
        key = torch.where(live, block_key(vox >> 3), KEY_PAD)
        cand = torch.unique(key[key != KEY_PAD])[: self.cap]
        known = torch.isin(cand, self.blocks)
        new = cand[~known][: max(self.max_blocks - len(self.blocks), 0)]
        self.blocks = torch.sort(torch.cat([self.blocks, new])).values
        keep = live & torch.isin(key, torch.cat([cand[known], new]))
        vid = voxel_id(vox[keep])
        wd = (w * torch.clamp(sdf, -self.trunc, self.trunc))[keep]
        u_vid, inv = torch.unique(vid, return_inverse=True)
        sw = torch.zeros(len(u_vid), dtype=torch.float64,
                         device=self.dev).index_add_(0, inv, w[keep])
        swd = torch.zeros_like(sw).index_add_(0, inv, wd)
        self._merge(u_vid, sw, swd)

    def _merge(self, vid, sw, swd) -> None:
        n = len(self.ids)
        at = torch.searchsorted(self.ids, vid)
        atc = torch.clamp(at, max=max(n - 1, 0))
        found = (at < n) & (self.ids[atc] == vid) if n else \
            torch.zeros_like(vid, dtype=torch.bool)
        old_w = torch.where(found, self.w[atc] if n else sw * 0, 0.0)
        old_ws = torch.where(found, self.ws[atc] if n else sw * 0, 0.0)
        nw, nws = old_w + sw, old_ws + swd
        cw = torch.clamp(nw, max=self.max_w)
        nws = nws * (cw / torch.clamp(nw, min=1e-12))
        self.w[atc[found]] = cw[found]
        self.ws[atc[found]] = nws[found]
        ids = torch.cat([self.ids, vid[~found]])
        order = torch.argsort(ids)
        self.ids = ids[order]
        self.w = torch.cat([self.w, cw[~found]])[order]
        self.ws = torch.cat([self.ws, nws[~found]])[order]


def payload_voxels(dir_keys, weight, wsum, dir_slots):
    """The program's map payload as (voxel ids, weight, weight x distance)
    of every voxel with weight, from its block keys and slots (int64 and
    float64 tensors)."""
    keys = dir_keys.to(torch.int64)
    used = keys != KEY_PAD
    keys, slots = keys[used], dir_slots.to(torch.int64)[used]
    b = torch.stack([(keys & 0x7FF) - 1024, ((keys >> 11) & 0x7FF) - 1024,
                     ((keys >> 22) & 0x3FF) - 512], dim=-1)
    iv = torch.arange(512, device=keys.device)
    intra = torch.stack([iv & 7, (iv >> 3) & 7, (iv >> 6) & 7], dim=-1)
    vox = b[:, None, :] * 8 + intra[None]
    w = weight[slots].to(torch.float64)
    ws = wsum[slots].to(torch.float64)
    has = w != 0.0
    return voxel_id(vox[has]), w[has], ws[has]


def map_gap(a, b) -> float:
    """Relative L1 gap of two maps ((ids, w, ws), the second the
    reference): (sum |dw| + sum |dws|) / (sum |w_b| + sum |ws_b|) over the
    union of their voxels."""
    ids = torch.cat([a[0], b[0]])
    u, inv = torch.unique(ids, return_inverse=True)
    na = len(a[0])
    diff = 0.0
    for k in (1, 2):
        va = torch.zeros(len(u), dtype=torch.float64, device=u.device)
        vb = torch.zeros_like(va)
        va[inv[:na]] = a[k]
        vb[inv[na:]] = b[k]
        diff += float(torch.sum(torch.abs(va - vb)))
    den = float(torch.sum(torch.abs(b[1])) + torch.sum(torch.abs(b[2])))
    return diff / max(den, 1e-12)


def by_block(m):
    """A map (voxel ids, w, ws) summed over its 8^3-voxel blocks: the same
    triple keyed by block."""
    ids, w, ws = m
    mask = (1 << 21) - 1
    v = torch.stack([(ids >> 42) - _OFF, ((ids >> 21) & mask) - _OFF,
                     (ids & mask) - _OFF], dim=-1)
    u, inv = torch.unique(voxel_id(v >> 3), return_inverse=True)
    z = torch.zeros(len(u), dtype=torch.float64, device=ids.device)
    return u, z.index_add(0, inv, w), z.clone().index_add(0, inv, ws)
