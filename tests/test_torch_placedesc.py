"""Place descriptors (``models/placedesc.py``): the batched match against
the JAX function on the same descriptors, the store's queries, and its
pack / unpack across the two packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noetic_slam_tpu.models import placedesc as jpd
from noetic_slam_tpu.utils import synthetic
from noetic_slam_tpu_torch.models import placedesc as pd
from tests.test_placedesc import _local_scan
from tests.torch_parity import to_np, to_torch

torch.set_num_threads(1)

# Scores are mean cosines in [0, 1] from a (B*S, R*S) x (R*S, K) product
# summed in another order than XLA's: 1e-5. Node and shift must be equal.
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def descs():
    """Descriptors of a synthetic loop: 24 stored places and 6 revisits
    (fresh sampling, yaw offsets), plus two empty descriptors."""
    sim = synthetic.make_sim(duration=20.0, n_points=4096, seed=3,
                             pose_fn=synthetic.loop_pose_of)
    valid = np.ones(4096, bool)
    store = [pd.ring_descriptor(_local_scan(sim, t), valid)
             for t in np.arange(0.5, 12.5, 0.5)]
    store += [np.zeros((pd.N_RINGS, pd.N_SECTORS), np.float32)] * 2
    queries = [pd.ring_descriptor(
        _local_scan(sim, t, extra_yaw=np.radians(y), seed=int(100 * t)),
        valid) for t, y in ((2.0, 0), (3.1, 45), (5.0, 90), (7.3, 170),
                            (9.9, -60), (11.0, 10))]
    return np.stack(store), np.stack(queries)


def test_ring_descriptor_is_the_jax_one(descs):
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-45, 45, (3000, 3)).astype(np.float32)
    valid = rng.random(3000) > 0.1
    np.testing.assert_array_equal(pd.ring_descriptor(xyz, valid),
                                  jpd.ring_descriptor(xyz, valid))


@pytest.mark.parametrize("count", [26, 20])
def test_match_store_batch_matches_jax(descs, count):
    store, queries = descs
    exc = np.asarray([26, 20, 10, 26, 0, 3], np.int32)
    j = np.asarray(jpd.match_store_batch(
        jnp.asarray(queries), jnp.asarray(store), jnp.int32(count),
        jnp.asarray(exc)))
    t = to_np(pd.match_store_batch(to_torch(queries), to_torch(store), count,
                                   to_torch(exc)))
    np.testing.assert_array_equal(t[:, 0], j[:, 0])          # node
    np.testing.assert_array_equal(t[:, 2], j[:, 2])          # shift
    np.testing.assert_allclose(t[:, 1], j[:, 1], rtol=0, atol=SCORE_TOL)
    assert (j[:4, 1] > 0.55).all()      # the revisits are real matches


def test_match_store_matches_jax(descs):
    """The single-query form: the same node and shift, the score within
    SCORE_TOL."""
    store, queries = descs
    for q, exc in ((queries[1], 26), (queries[3], 12)):
        jn, js, jsh = jpd.match_store(jnp.asarray(q), jnp.asarray(store),
                                      jnp.int32(26), jnp.int32(exc))
        tn, ts, tsh = pd.match_store(to_torch(q), to_torch(store), 26, exc)
        assert int(tn) == int(jn) and int(tsh) == int(jsh)
        assert abs(float(ts) - float(js)) < SCORE_TOL


def test_store_query_batch_matches_jax(descs):
    store, _ = descs
    js, ts = jpd.DescriptorStore(cap=8), pd.DescriptorStore(cap=8,
                                                            device="cpu")
    js.add_batch(range(len(store)), store)
    ts.add_batch(range(len(store)), store)
    nodes = np.arange(10, 26)
    jr = js.query_batch(nodes, nodes - 5)
    tr = ts.query_batch(nodes, nodes - 5)
    for a, b in zip(tr[::2], jr[::2]):                       # cands, shifts
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tr[1], jr[1], rtol=0, atol=SCORE_TOL)
    # split start/finish gives the same, and a query with nothing eligible
    # returns -1
    handle = ts.query_batch_start([3, 12], [0, 7])
    c, s, _ = ts.query_batch_finish(handle)
    assert c[0] == -1 and c[1] == tr[0][2]
    assert ts.query(store[12], exclude_from=7)[0] == int(tr[0][2])
    assert ts.query(store[12], exclude_from=0) == (-1, 0.0, 0)


def test_store_pack_unpack_across_packages(descs):
    store, _ = descs
    ts = pd.DescriptorStore(cap=4, device="cpu")
    for i, d in enumerate(store[:11]):
        ts.add(i, d)
    assert ts.count == 11 and ts._host.shape[0] >= 11
    js = jpd.DescriptorStore()
    js.unpack(ts.pack())
    np.testing.assert_array_equal(js.pack()["desc"], store[:11])
    back = pd.DescriptorStore(device="cpu")
    back.unpack(js.pack())
    assert back.count == 11
    np.testing.assert_array_equal(back.pack()["desc"], store[:11])
    node, score, _ = back.query(store[3], min_gap=0)
    assert node == 3 and score > 0.99
