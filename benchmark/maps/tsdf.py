"""The map comparison of a configuration whose ``dlio.map_backend`` is
``tsdf``: the program's TSDF against a plain float64 TSDF fusion
(``reference.tsdf``) of every scan the program fused, in its order, at
the poses it reported; the undeskewed sweeps as they came, the deskewed
ones moved within the sweep by the path's own motion.

Numbers, each named by a traffic file's ``checks``:

- ``map_gap`` (``map``): the relative L1 gap of the map's (weight,
  weight x distance) against the plain fusion;
- ``map_block_gap`` (``map_blocks``): the same over 8^3-voxel blocks (for
  deskewed sweeps, where the program's own in-sweep motion and the path's
  differ by millimetres, enough to move a few percent of the samples
  across a voxel's face).
"""

from __future__ import annotations

import torch

from benchmark.harness.check import scan_index, to_tf32, world_points
from benchmark.reference.tsdf import (
    ReferenceTsdf,
    by_block,
    map_gap,
    payload_voxels,
)


def _wanted(checks) -> bool:
    return "map" in checks or "map_blocks" in checks


def jump_m(dlio: dict) -> float:
    """The pose error past which a scan writes its surfaces outside the
    band of those already in the map: the truncation."""
    return float(dlio["tsdf"]["truncation"])


def capture(slam, checks):
    """The program's map as CPU tensors (block keys, weights, weight x
    distance, slots), or None when ``checks`` names no map."""
    st = slam.tsdf
    if st is None or not _wanted(checks):
        return None
    return (st.dir_keys.cpu(), st.weight.cpu(), st.wsum.cpu(),
            st.dir_slots.cpu())


def reference_map(rec, round_fn=None):
    """The plain fusion of every scan the program fused, in its order, at
    the poses it reported: (voxel ids, weight, weight x distance)."""
    dev = rec.ref_device
    ref = ReferenceTsdf(rec.dlio["tsdf"], dev, round_fn)
    idx = scan_index(rec.traj[:, 0], rec.sensor)
    for i, row in zip(idx, rec.traj):
        pts, valid, origin = world_points(rec, int(i), row, dev)
        ref.fuse(pts, valid, origin)
    return ref.ids, ref.w, ref.ws


def _gaps(m, ref, checks) -> dict:
    out = {}
    if "map" in checks:
        out["map_gap"] = map_gap(m, ref)
    if "map_blocks" in checks:
        out["map_block_gap"] = map_gap(by_block(m), by_block(ref))
    return out


def numbers(rec, checks) -> dict:
    """The program's map against the plain fusion."""
    if not _wanted(checks):
        return {}
    prog = payload_voxels(*(torch.as_tensor(a, device=rec.ref_device)
                            for a in rec.payload))
    return _gaps(prog, reference_map(rec), checks)


def control(rec, checks) -> dict:
    """The plain fusion with its sample positions rounded to TF32, in the
    program's place, against the float64 one."""
    if not _wanted(checks):
        return {}
    ref, ctl = reference_map(rec), reference_map(rec, to_tf32)
    return _gaps(ctl, ref, checks)
