"""hnsw_tpu_torch.IVFIndex against hnsw_tpu's on the CPU.

The device functions get the same seeded inputs in both packages:
``_scan_blocks`` and ``_merge_probed`` within 1e-5 with equal ids;
``_assign_parts`` and ``_kmeans_step`` equal on integer-valued vectors
(the port's DEFAULT precision rounds operands to bf16, JAX's CPU DEFAULT
is f32; small integers are exact in both). Searches are compared on an
index carried across with ``convert.ivf_from_jax`` (same centroids,
members and store): equal keys, distances within 1e-5. The specs of
tests/test_ivf.py run against the port as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.index import ivf as jivf  # noqa: E402
from hnsw_tpu_torch import IVFIndex  # noqa: E402
from hnsw_tpu_torch.convert import ivf_from_jax  # noqa: E402
from hnsw_tpu_torch.index import ivf as tivf  # noqa: E402
from hnsw_tpu_torch.ops.topk import np_exact_topk  # noqa: E402
from hnsw_tpu_torch.utils.surface import (BasicSurface, ContraMap,  # noqa: E402
                                          VectorDistance, node_surface)
from tests.conftest import make_vectors  # noqa: E402

INF = 1e38


def _recall(keys, gt, k):
    hits = sum(len({int(x) for x in keys[i] if x is not None} &
                   set(map(int, gt[i]))) for i in range(len(gt)))
    return hits / (len(gt) * k)


def _int_vectors(n, d, seed):
    return np.random.default_rng(seed).integers(-4, 5, (n, d)).astype(
        np.float32)


def _scan_inputs(seed=21, NB=6, C=16, D=12, Q=10, Qp=8):
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((NB, C, D)).astype(np.float32)
    valid = rng.random((NB, C)) < 0.8
    valid[2] = False                          # an empty block
    blocks[~valid] = 0
    sq = np.sum(blocks * blocks, axis=-1).astype(np.float32)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    q_rows = rng.integers(0, Q, (NB, Qp)).astype(np.int32)
    q_rows[:, 5:] = -1
    q_rows[4] = -1                            # a block nobody probes
    return q, q_rows, blocks, sq, valid


def _scan_both(metric, k, inputs):
    q, q_rows, blocks, sq, valid = inputs
    dj, cj = jivf._scan_blocks(jnp.asarray(q), jnp.asarray(q_rows),
                               jnp.asarray(blocks), jnp.asarray(sq),
                               jnp.asarray(valid), metric, k)
    dt, ct = tivf._scan_blocks(torch.from_numpy(q), torch.from_numpy(q_rows),
                               torch.from_numpy(blocks), torch.from_numpy(sq),
                               torch.from_numpy(valid), metric, k)
    return (np.asarray(dj), np.asarray(cj)), (dt.numpy(), ct.numpy())


@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
def test_scan_blocks_matches_jax(metric):
    (dj, cj), (dt, ct) = _scan_both(metric, 5, _scan_inputs())
    np.testing.assert_array_equal(dt >= INF, dj >= INF)
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)
    live = dj < INF
    np.testing.assert_array_equal(ct[live], cj[live])


def test_scan_blocks_k_wider_than_a_block():
    (dj, cj), (dt, ct) = _scan_both("cosine", 40, _scan_inputs())
    assert dt.shape == dj.shape == (6, 8, 16)
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)


def test_scan_blocks_in_runs_equals_one_run(monkeypatch):
    inputs = _scan_inputs()
    _, (d1, c1) = _scan_both("l2", 5, inputs)
    monkeypatch.setattr(tivf, "_SCAN_BYTES", 8 * 16 * 4 * 2)   # 2 blocks
    _, (d2, c2) = _scan_both("l2", 5, inputs)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(c1, c2)


def test_merge_probed_matches_jax():
    rng = np.random.default_rng(22)
    NB, Qp, kk, bs, Q, T, k = 5, 6, 4, 16, 7, 4, 6
    dk = np.sort(rng.random((NB, Qp, kk)).astype(np.float32), axis=-1)
    dk[1, 2, 2:] = INF                         # a short block result
    ck = rng.integers(0, bs, (NB, Qp, kk)).astype(np.int64)
    block_slot = rng.permutation(NB * bs).reshape(NB, bs).astype(np.int32)
    pp = rng.integers(0, NB, (Q, T)).astype(np.int64)
    rr = rng.integers(0, Qp, (Q, T)).astype(np.int64)
    valid = rng.random((Q, T)) < 0.7
    valid[3] = False                           # a query with no probe
    dj, sj = jivf._merge_probed(*map(jnp.asarray, (dk, ck, block_slot, pp,
                                                   rr, valid)), k=k)
    dt, st = tivf._merge_probed(*map(torch.from_numpy, (dk, ck, block_slot,
                                                        pp, rr, valid)), k=k)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st.numpy()[3] == -1).all()


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_assign_parts_equal_on_integer_vectors(metric):
    v = _int_vectors(2048, 16, 23)
    c = _int_vectors(12, 16, 24)
    c[5] = c[2]                                # a tie: the first one wins
    aj = np.asarray(jivf._assign_parts(jnp.asarray(v), jnp.asarray(c),
                                       metric))
    at = tivf._assign_parts(torch.from_numpy(v), torch.from_numpy(c),
                            metric).numpy()
    np.testing.assert_array_equal(at, aj)
    assert at.dtype == np.int32 and not (at == 5).any()
    np.testing.assert_array_equal(
        tivf._device_assign(v, c, metric, "cpu"), aj)


def test_assign_parts_in_chunks_equals_one_chunk(monkeypatch):
    v = _int_vectors(1000, 8, 25)
    c = _int_vectors(7, 8, 26)
    one = tivf._device_assign(v, c, "l2", "cpu")
    monkeypatch.setattr(tivf, "_ASSIGN_CHUNK", 96)     # 11 chunks, a tail
    np.testing.assert_array_equal(tivf._device_assign(v, c, "l2", "cpu"),
                                  one)
    np.testing.assert_array_equal(
        tivf._assign_parts(torch.from_numpy(v), torch.from_numpy(c),
                           "l2").numpy(), one)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_kmeans_step_equal_on_integer_vectors(metric, monkeypatch):
    v = _int_vectors(1024, 16, 27)
    c = np.concatenate([v[:9], 100 + _int_vectors(1, 16, 28)])  # one empty
    cj = np.asarray(jivf._kmeans_step(jnp.asarray(v),
                                      jnp.ones(len(v), bool),
                                      jnp.asarray(c), metric))
    ct = tivf._kmeans_step(torch.from_numpy(v), torch.from_numpy(c),
                           metric).numpy()
    # the sums are of small integers (exact in f32 in any order); the one
    # division is the same IEEE operation in both
    np.testing.assert_array_equal(ct, cj)
    if metric == "l2":                     # far from every row: empty
        np.testing.assert_array_equal(ct[9], c[9])    # keeps its centroid
    monkeypatch.setattr(tivf, "_ASSIGN_CHUNK", 100)
    np.testing.assert_array_equal(
        tivf._kmeans_step(torch.from_numpy(v), torch.from_numpy(c),
                          metric).numpy(), ct)


def test_build_on_integer_vectors_gives_jax_centroids_and_members():
    v = _int_vectors(600, 12, 29)
    j = jivf.IVFIndex(num_partitions=8, nprobe=4, metric="l2",
                      kmeans_iters=2)
    t = IVFIndex(num_partitions=8, nprobe=4, metric="l2", kmeans_iters=2,
                 device="cpu")
    j.build(list(range(600)), v)
    t.build(list(range(600)), v)
    np.testing.assert_allclose(t.centroids, j.centroids, atol=1e-6, rtol=0)
    assert t._part_of == j._part_of


@pytest.mark.parametrize("partial", [False, True])
def test_gathered_block_put_in_chunks(partial, monkeypatch):
    rng = np.random.default_rng(30)
    NB, bs, dim = 7, 4, 3
    vectors = rng.standard_normal((40, dim)).astype(np.float32)
    slot = rng.integers(0, 40, (NB, bs)).astype(np.int64)
    valid = rng.random((NB, bs)) < 0.7
    slot[~valid] = -1
    want = vectors[np.clip(slot, 0, None)]
    want[~valid] = 0
    if partial:                 # 3 blocks a copy: 3 + 3 + a tail of 1
        monkeypatch.setattr(tivf, "_PUT_CHUNK_BYTES", 3 * bs * dim * 4)
    got = tivf._gathered_block_put(vectors, slot, valid, bs, dim, "cpu")
    assert got.shape == (NB, bs, dim) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _carried_pair(metric, nprobe, n=1500, d=24):
    v = (make_vectors(n, d, seed=90, kind="clustered") / 30).astype(
        np.float32)
    j = jivf.IVFIndex(num_partitions=16, nprobe=nprobe, metric=metric,
                      kmeans_iters=4)
    j.build(list(range(n)), v)
    j.batch_add(list(range(n, n + 40)),
                v[:40] + 0.003 * make_vectors(40, d, seed=89))
    j.delete(3)
    return j, ivf_from_jax(j, device="cpu"), v


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("nprobe", [4, "auto"])
def test_search_on_a_carried_index_matches_jax(metric, nprobe):
    j, t, v = _carried_pair(metric, nprobe)
    q = v[:40] + 0.01 * make_vectors(40, v.shape[1], seed=91)
    kj, dj = j.batch_search(q, 10)
    kt, dt = t.batch_search(q, 10)
    assert t._resolve_nprobe() == j._resolve_nprobe()
    assert kt == kj
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)
    assert all(x is not None for row in kt for x in row)
    assert [x for x, _ in t.search(q[0], 5)] == [x for x, _ in
                                                 j.search(q[0], 5)]
    assert t.stats() == j.stats()


def test_carried_index_takes_mutations_like_jax():
    j, t, v = _carried_pair("cosine", 16)
    for idx in (j, t):
        idx.batch_add(["new-a", "new-b"], v[100:102] + np.float32(0.002))
        assert idx.delete(7) and not idx.delete(7)
    assert t._part_of == j._part_of
    kj, dj = j.batch_search(v[95:110], 6)
    kt, dt = t.batch_search(v[95:110], 6)
    assert kt == kj
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_full_probe_equals_np_exact_topk(metric):
    n, d, k = 700, 16, 8
    v = make_vectors(n, d, seed=92)
    q = make_vectors(25, d, seed=93)
    idx = IVFIndex(num_partitions=8, nprobe=8, metric=metric,
                   kmeans_iters=3, device="cpu")
    idx.build(list(range(n)), v)
    gd, gi = np_exact_topk(q, v, k, metric)
    keys, dists = idx.batch_search(q, k)
    assert _recall(keys, gi, k) == 1.0
    np.testing.assert_allclose(dists, gd, atol=1e-4, rtol=0)


def test_a_partition_wider_than_a_block_is_split(monkeypatch):
    monkeypatch.setattr(IVFIndex, "BLOCK", 32)
    n, d, k = 600, 8, 5
    v = make_vectors(n, d, seed=94)
    idx = IVFIndex(num_partitions=4, nprobe=4, metric="l2", kmeans_iters=2,
                   device="cpu")
    idx.build(list(range(n)), v)
    blocks = idx._sync()[0]
    assert blocks.shape[1] == 32 and blocks.shape[0] > 4
    _, gi = np_exact_topk(v[:20], v, k, "l2")
    keys, _ = idx.batch_search(v[:20], k)
    assert _recall(keys, gi, k) == 1.0


def test_close_drops_the_device_tables_and_search_rebuilds_them():
    v = make_vectors(200, 8, seed=95)
    idx = IVFIndex(num_partitions=4, nprobe=4, device="cpu")
    idx.build(list(range(200)), v)
    assert idx.search(v[5], 1)[0][0] == 5
    assert idx._dev is not None and idx._dev[0].device.type == "cpu"
    idx.close()
    assert idx._dev is None and idx._dev_slots is None
    assert idx.search(v[6], 1)[0][0] == 6
    assert idx._dev is not None


def test_group_by_block_and_merge_positions_lay_out_the_probes():
    # partitions 0..2 own blocks [0], [1, 2], [3]; two queries
    part_blocks = [[0], [1, 2], [3]]
    probe = np.array([[1, 0], [1, 2]])
    q_rows, pos = IVFIndex._group_by_block(probe, part_blocks, 4)
    assert q_rows.shape == (4, 8) and q_rows.dtype == np.int32
    assert q_rows[:, :2].tolist() == [[0, -1], [0, 1], [0, 1], [1, -1]]
    assert (q_rows[:, 2:] == -1).all()
    assert pos == [[(1, 0), (2, 0), (0, 0)], [(1, 1), (2, 1), (3, 0)]]
    pp, rr, valid = IVFIndex._merge_positions(pos)
    assert pp.shape == rr.shape == valid.shape == (2, 4)
    assert pp[:, :3].tolist() == [[1, 2, 0], [1, 2, 3]]
    assert rr[:, :3].tolist() == [[0, 0, 0], [1, 1, 0]]
    assert valid.tolist() == [[True, True, True, False]] * 2


def test_empty_index_and_bad_k():
    idx = IVFIndex(num_partitions=4, device="cpu")
    keys, d = idx.batch_search(np.ones((2, 4), np.float32), 3)
    assert keys == [[None] * 3] * 2 and (d >= INF).all()
    with pytest.raises(ValueError, match="k must be"):
        idx.batch_search(np.ones((1, 4), np.float32), 0)
    with pytest.raises(ValueError, match="bad nprobe"):
        IVFIndex(nprobe="all", device="cpu")


def test_calibration_state_round_trip():
    v = make_vectors(500, 16, seed=96)
    idx = IVFIndex(num_partitions=8, device="cpu")
    idx.build(list(range(500)), v)
    assert idx.calibration_state() == {}
    npb = idx._resolve_nprobe()
    state = idx.calibration_state()
    assert state == {"auto_nprobe": [npb, 500]}
    other = IVFIndex(num_partitions=8, device="cpu")
    other.restore_calibration(state)
    assert other._auto_cache == (npb, 500)


# ------------------------------------------- port twins of tests/test_ivf.py

def test_ivf_recall_close_to_exact():
    n, d, k = 2000, 32, 10
    v = make_vectors(n, d, seed=90)
    q = make_vectors(50, d, seed=91)
    idx = IVFIndex(num_partitions=16, nprobe=8, kmeans_iters=5, device="cpu")
    idx.build(list(range(n)), v)
    _, gt = np_exact_topk(q, v, k, "cosine")
    keys, dists = idx.batch_search(q, k)
    r = _recall(keys, gt, k)
    assert r >= 0.85, r
    assert all(np.all(np.diff(row) >= -1e-6) for row in dists)


def test_ivf_full_probe_equals_exact():
    n, d, k = 500, 16, 5
    v = make_vectors(n, d, seed=92)
    q = make_vectors(20, d, seed=93)
    idx = IVFIndex(num_partitions=8, nprobe=8, kmeans_iters=3, device="cpu")
    idx.build(list(range(n)), v)
    _, gt = np_exact_topk(q, v, k, "cosine")
    keys, _ = idx.batch_search(q, k)
    assert _recall(keys, gt, k) == 1.0


def test_ivf_mutation():
    v = make_vectors(300, 16, seed=94)
    idx = IVFIndex(num_partitions=8, nprobe=4, kmeans_iters=3, device="cpu")
    idx.build(list(range(200)), v[:200])
    idx.batch_add(list(range(200, 300)), v[200:])
    assert len(idx) == 300
    assert idx.search(v[250], 1)[0][0] == 250
    assert idx.delete(250)
    assert idx.search(v[250], 1)[0][0] != 250
    assert not idx.delete(250)
    assert idx.stats()["total"] == 299


def test_ivf_nprobe_validation():
    with pytest.raises(ValueError, match="nprobe"):
        IVFIndex(num_partitions=4, nprobe=8, device="cpu")


def test_ivf_l2_metric():
    v = make_vectors(400, 16, seed=95)
    q = make_vectors(10, 16, seed=96)
    idx = IVFIndex(num_partitions=8, nprobe=6, metric="l2", kmeans_iters=3,
                   device="cpu")
    idx.build(list(range(400)), v)
    _, gt = np_exact_topk(q, v, 5, "l2")
    keys, _ = idx.batch_search(q, 5)
    assert _recall(keys, gt, 5) >= 0.85


def test_surface_contramap():
    s = BasicSurface("l2")
    assert abs(s.distance([0, 0], [3, 4]) - 5.0) < 1e-5
    cm = ContraMap(s, lambda rec: rec["emb"])
    a = {"emb": np.array([0.0, 0.0], np.float32)}
    b = {"emb": np.array([3.0, 4.0], np.float32)}
    assert abs(cm.distance(a, b) - 5.0) < 1e-5
    m = VectorDistance(cm).batch([a, b], [a, b])
    np.testing.assert_allclose(m, [[0, 5], [5, 0]], atol=1e-5)


def test_node_surface():
    ns = node_surface("cosine")
    a = ("k1", np.array([1.0, 0.0], np.float32))
    b = ("k2", np.array([0.0, 1.0], np.float32))
    assert abs(ns.distance(a, b) - 1.0) < 1e-5
    assert abs(ns.distance(a, a)) < 1e-5
