"""Parity of the port's map products with the JAX package: the
surface-nets mesh of a TSDF carried across (``io.meshing``), the sparse
keyframe map and the dense map recorder (``models.mapping``)."""

import collections
import os

import jax.numpy as jnp
import numpy as np
import torch

from noetic_slam_tpu.io import meshing as jmesh
from noetic_slam_tpu.models import mapping as jmap
from noetic_slam_tpu.models import tsdf as jt
from noetic_slam_tpu_torch import convert
from noetic_slam_tpu_torch.config import TsdfConfig
from noetic_slam_tpu_torch.io import meshing as tmesh
from noetic_slam_tpu_torch.models import mapping as tmap
from tests.torch_parity import jax_cfg, to_torch

torch.set_num_threads(1)


def test_extract_mesh_matches_jax():
    """Same numpy code on the same payload: faces equal, vertices to f32
    rounding."""
    cfg = TsdfConfig(voxel_size=0.1, truncation=0.3, max_blocks=1024,
                     space_carving=False, scan_block_cap=1024)
    jcfg = jax_cfg(cfg)
    rng = np.random.default_rng(0)
    st = jt.init_tsdf(jcfg)
    for _ in range(3):                  # a sphere scanned from its centre
        v = rng.normal(size=(8000, 3))
        pts = 1.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)
        st = jt.integrate(jcfg, st, jnp.asarray(pts.astype(np.float32)),
                          jnp.ones((8000,), bool), jnp.zeros(3))
    jv, jf = jmesh.extract_mesh(jcfg, st)
    tv, tf = tmesh.extract_mesh(cfg, convert.tsdf_state_from_numpy(st, "cpu"))
    assert len(jf) > 100
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)


KfState = collections.namedtuple("KfState", "kf_count kf_xyz kf_valid")


def test_keyframe_map_matches_jax():
    """Two incremental updates (2 keyframes, then 5): the same clouds."""
    rng = np.random.default_rng(1)
    K, Nk = 6, 400
    xyz = rng.uniform(-5, 5, (K, Nk, 3)).astype(np.float32)
    valid = rng.random((K, Nk)) > 0.2
    jkm, tkm = jmap.KeyframeMap(leaf_size=0.5), tmap.KeyframeMap(leaf_size=0.5)
    for n in (2, 5):
        jnew = jkm.update(KfState(jnp.int32(n), jnp.asarray(xyz),
                                  jnp.asarray(valid)))
        tnew = tkm.update(KfState(torch.tensor(n, dtype=torch.int32),
                                  to_torch(xyz), to_torch(valid)))
        assert tnew == jnew
        np.testing.assert_array_equal(tkm.cloud(), jkm.cloud())
    assert len(tkm.cloud()) > 100


def _shards(path):
    """{shard index: bytes}; names are <unix time>_<index>.ply."""
    return {int(f.split("_")[1].split(".")[0]):
            open(os.path.join(path, f), "rb").read()
            for f in os.listdir(path)}


def test_dense_map_recorder_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    jrec = jmap.DenseMapRecorder(str(tmp_path / "jax"), shard_every=2,
                                 max_points_per_scan=150)
    trec = tmap.DenseMapRecorder(str(tmp_path / "torch"), shard_every=2,
                                 max_points_per_scan=150)
    for _ in range(5):
        xyz = rng.normal(size=(512, 3)).astype(np.float32)
        valid = rng.random(512) > 0.3
        jrec.add(jnp.asarray(xyz), jnp.asarray(valid))
        trec.add(to_torch(xyz), to_torch(valid))
    jrec.close()
    trec.close()
    js, ts = _shards(tmp_path / "jax"), _shards(tmp_path / "torch")
    assert sorted(ts) == sorted(js) == [0, 1, 2]
    for i in js:
        assert ts[i] == js[i], i
