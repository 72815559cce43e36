"""Disk-resident serving of hnsw_tpu_torch on the CPU: MmapVectorStore,
StreamingExactIndex and Graph over memory-mapped vectors.

Every spec of tests/test_disk_serving.py runs against the port
(``device="cpu"``), with the same names. Beside them, the JAX object and
the port's on the same seeded inputs:

* StreamingExactIndex float32: equal ids, distances within 1e-5;
* the reduced rungs (bf16, fp16, int8): JAX selects each chunk's
  candidates with ``approx_min_k``, the port exactly, so the bound is on
  the results after the f32 host rerank: id overlap >= 0.99 with JAX's,
  distances of equal ids within 1e-5, and JAX's own oracle floor (recall
  >= 0.99, int8 >= 0.95);
* the host casts of the reduced rungs equal numpy's / ml_dtypes' bit for
  bit;
* MmapVectorStore directories written by one package open in the other.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.index.streaming import (  # noqa: E402
    StreamingExactIndex as JStreamingExactIndex)
from hnsw_tpu.io.mmap_store import MmapVectorStore as JMmapVectorStore  # noqa: E402,E501
from hnsw_tpu_torch import Graph, StoreConfig  # noqa: E402
from hnsw_tpu_torch.index import streaming as streaming_mod  # noqa: E402
from hnsw_tpu_torch.io.disk_graph import DiskGraph  # noqa: E402
from hnsw_tpu_torch.io.mmap_store import MmapVectorStore  # noqa: E402
from hnsw_tpu_torch.ops.topk import np_exact_topk  # noqa: E402
from tests.conftest import make_vectors  # noqa: E402


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


def StreamingExactIndex(*a, **kw):
    return streaming_mod.StreamingExactIndex(*a, device="cpu", **kw)


def test_mmap_store_roundtrip_and_growth(tmp_path):
    s = MmapVectorStore(str(tmp_path / "st"), dim=8, capacity=4)
    v = make_vectors(100, 8, seed=120)
    s.put_batch(np.arange(100), v)
    assert s.capacity >= 100
    np.testing.assert_allclose(s.get(42), v[42])
    np.testing.assert_allclose(s.get_batch([3, 77]), v[[3, 77]])
    s.kill(42)
    s.flush()
    s2 = MmapVectorStore(str(tmp_path / "st"))
    assert s2.dim == 8 and not s2.alive[42] and s2.alive[41]
    np.testing.assert_allclose(np.asarray(s2.vectors[:100]), v)


def test_streaming_exact_recall_one_with_tiny_chunks(tmp_path):
    n, d, k = 5000, 16, 10
    v = make_vectors(n, d, seed=121)
    q = make_vectors(30, d, seed=122)
    idx = StreamingExactIndex(str(tmp_path / "sx"), metric="cosine",
                              chunk_rows=512)
    idx.batch_add(list(range(n)), v)
    keys, dists = idx.batch_search(q, k)
    gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
    for i in range(len(q)):
        assert keys[i] == [int(x) for x in gt_i[i]]
    np.testing.assert_allclose(dists, gt_d, atol=1e-4)


def test_streaming_exact_delete_and_reopen(tmp_path):
    n, d = 300, 8
    v = make_vectors(n, d, seed=123)
    p = str(tmp_path / "sx")
    idx = StreamingExactIndex(p, chunk_rows=64)
    idx.batch_add(list(range(n)), v)
    assert idx.delete(5)
    res = idx.search(v[5], 1)
    assert res[0][0] != 5
    idx.close()
    idx2 = StreamingExactIndex(p, chunk_rows=64)
    assert idx2.store.alive[6] and not idx2.store.alive[5]


def test_graph_over_mmap_store_quality_parity(tmp_path):
    n, d, k = 400, 16, 5
    v = make_vectors(n, d, seed=124)
    q = make_vectors(20, d, seed=125)
    g_ram = Graph(seed=0, device="cpu")
    g_ram.batch_add(list(range(n)), v)
    g_dsk = Graph(seed=0, store=MmapVectorStore(str(tmp_path / "gv")),
                  device="cpu")
    g_dsk.batch_add(list(range(n)), v)
    k1, d1 = g_ram.batch_search(q, k, ef=64)
    k2, d2 = g_dsk.batch_search(q, k, ef=64)
    assert [list(r) for r in k1] == [list(r) for r in k2]
    np.testing.assert_allclose(d1, d2, atol=1e-5)


def test_disk_graph_vectors_on_disk(tmp_path):
    d = str(tmp_path / "dg")
    v = make_vectors(150, 8, seed=126)

    def cfg():
        return StoreConfig(directory=d, format="npz", vectors_on_disk=True,
                           wal_flush_interval_seconds=0)
    g = DiskGraph(d, store_config=cfg(), device="cpu")
    g.batch_add(list(range(150)), v)
    assert g.search(v[9], 1)[0][0] == 9
    g.close()
    g2 = DiskGraph(d, store_config=cfg(), device="cpu")
    assert len(g2) == 150
    assert g2.search(v[9], 1)[0][0] == 9


def test_disk_graph_hbm_mode_float16_passthrough(tmp_path):
    d = str(tmp_path / "dg16")

    def cfg():
        return StoreConfig(directory=d, format="npz",
                           vectors_on_disk=True, hbm_mode="float16",
                           wal_flush_interval_seconds=0)

    rng = np.random.default_rng(42)
    centers = rng.standard_normal((5, 16)).astype(np.float32) * 5
    v = (centers[rng.integers(0, 5, 200)]
         + 0.1 * rng.standard_normal((200, 16)).astype(np.float32))
    g = DiskGraph(d, store_config=cfg(), device="cpu")
    g.batch_add(list(range(200)), v)
    assert g.graph.hbm_mode == "float16"
    assert g.graph.device_graph().vectors.dtype == torch.float16
    assert g.search(v[9], 1)[0][0] == 9
    g.close()
    g2 = DiskGraph(d, store_config=cfg(), device="cpu")
    assert g2.graph.hbm_mode == "float16"
    assert g2.search(v[9], 1)[0][0] == 9
    sc = StoreConfig(directory=d, format="npz", hbm_quantized=True,
                     wal_flush_interval_seconds=0)
    assert sc.hbm_mode == "full"
    with pytest.raises(ValueError):
        StoreConfig(directory=d, hbm_mode="int8").validate()


def test_hbm_quantized_mode_over_mmap_store(tmp_path):
    from hnsw_tpu_torch.ops.distance import np_pairwise_dist
    n, d, k = 600, 32, 10
    v = make_vectors(n, d, seed=127)
    q = make_vectors(40, d, seed=128)
    g = Graph(seed=0, store=MmapVectorStore(str(tmp_path / "qv")),
              device="cpu")
    g.batch_add(list(range(n)), v)
    keys_full, _ = g.batch_search(q, k, ef=80)
    g.hbm_mode = "quantized"
    dev = g.device_graph()
    assert dev.vectors.shape[0] == 1
    assert dev.qvec is not None
    keys_q, dists_q = g.batch_search(q, k, ef=80)
    _, gt = np_exact_topk(q, v, k, "cosine")

    def rec(keys):
        hits = sum(len(set(keys[i]) & set(map(int, gt[i])))
                   for i in range(len(keys)))
        return hits / (len(keys) * k)

    assert rec(keys_q) >= rec(keys_full) - 0.02, (rec(keys_q),
                                                  rec(keys_full))
    for i in range(5):
        for kk, dd in zip(keys_q[i], dists_q[i]):
            if kk is None:
                continue
            true_d = np_pairwise_dist(q[i][None], v[kk][None])[0, 0]
            assert abs(dd - true_d) < 1e-4
    g.delete(keys_q[0][0])
    keys_after, _ = g.batch_search(q[:1], k)
    assert keys_q[0][0] not in keys_after[0]


def test_streaming_exact_hbm_chunk_cache(tmp_path):
    n, d, k = 2000, 16, 5
    v = make_vectors(n, d, seed=124)
    q = make_vectors(16, d, seed=125)
    idx = StreamingExactIndex(str(tmp_path / "sx"), metric="cosine",
                              chunk_rows=512, hbm_cache_bytes=10 << 20)
    idx.batch_add(list(range(n)), v)
    keys, _ = idx.batch_search(q, k)
    assert len(idx._cache) == 3
    assert all(ent[0].device.type == "cpu" for ent in idx._cache.values())
    keys2, _ = idx.batch_search(q, k)
    assert keys2 == keys
    _, gt_i = np_exact_topk(q, v, k, "cosine")
    for i in range(len(q)):
        assert keys[i] == [int(x) for x in gt_i[i]]
    target = int(gt_i[0][0])
    idx.batch_add([target], -v[target][None])
    assert len(idx._cache) == 2
    keys3, _ = idx.batch_search(q, k)
    assert keys3[0][0] != target
    idx0 = StreamingExactIndex(str(tmp_path / "sx0"), metric="cosine",
                               chunk_rows=512, hbm_cache_bytes=0)
    idx0.batch_add(list(range(n)), v)
    k0, _ = idx0.batch_search(q, k)
    assert not idx0._cache
    for i in range(len(q)):
        assert k0[i] == [int(x) for x in gt_i[i]]


@pytest.mark.parametrize("dt", ["bf16", "fp16", "int8"])
def test_streaming_reduced_dtype_matches_oracle(tmp_path, dt):
    n, d, k = 3000, 16, 10
    v = make_vectors(n, d, seed=130)
    q = make_vectors(24, d, seed=131)
    idx = StreamingExactIndex(str(tmp_path / f"sx_{dt}"),
                              metric="cosine", chunk_rows=512,
                              stream_dtype=dt)
    idx.batch_add(list(range(n)), v)
    keys, dists = idx.batch_search(q, k)
    gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
    rec = np.mean([len(set(keys[r]) & set(map(int, gt_i[r]))) / k
                   for r in range(len(q))])
    floor = 0.95 if dt == "int8" else 0.99
    assert rec >= floor, f"{dt} recall {rec}"
    for r in range(6):
        gmap = {int(i): float(dd) for i, dd in zip(gt_i[r], gt_d[r])}
        for kk_, dd in zip(keys[r], dists[r]):
            if kk_ in gmap:
                np.testing.assert_allclose(dd, gmap[kk_], rtol=1e-4)
    victim = keys[0][0]
    idx.delete(victim)
    keys2, _ = idx.batch_search(q[:1], k)
    assert victim not in keys2[0]


def test_streaming_reduced_cache_and_mode_switch(tmp_path):
    n, d, k = 2000, 16, 5
    v = make_vectors(n, d, seed=132)
    q = make_vectors(8, d, seed=133)
    idx = StreamingExactIndex(str(tmp_path / "sxc"), metric="cosine",
                              chunk_rows=512, hbm_cache_bytes=10 << 20,
                              stream_dtype="int8")
    idx.batch_add(list(range(n)), v)
    k1, _ = idx.batch_search(q, k)
    assert len(idx._cache) == 3
    assert idx._cache_bytes < 512 * 3 * (d * 4 + 9)
    k2, _ = idx.batch_search(q, k)
    assert k2 == k1
    idx.stream_dtype = "float32"
    k3, _ = idx.batch_search(q, k)
    assert idx._cache_stream_dtype == "float32"
    gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
    for i in range(len(q)):
        assert k3[i] == [int(x) for x in gt_i[i]]


# ------------------------------------------------- the JAX object beside it

def _pair(tmp_path, metric, dt, n=2600, d=16, seed=140, **kw):
    v = make_vectors(n, d, seed=seed)
    j = JStreamingExactIndex(str(tmp_path / "j"), metric=metric,
                             stream_dtype=dt, **kw)
    t = StreamingExactIndex(str(tmp_path / "t"), metric=metric,
                            stream_dtype=dt, **kw)
    for idx in (j, t):
        idx.batch_add(list(range(n)), v)
        idx.batch_delete(list(range(0, n, 97)))
    return j, t, v


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_streaming_float32_equals_jax(tmp_path, metric):
    """Chunks of 512 rows (the last one short, padded to 8), deletes:
    equal ids, distances within 1e-5."""
    j, t, _ = _pair(tmp_path, metric, "float32", chunk_rows=512)
    q = make_vectors(37, 16, seed=141)
    dj, ij = j.batch_search_slots(q, 10)
    dt, it = t.batch_search_slots(q, 10)
    assert it.dtype == np.int64
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)
    # k past the live rows of a chunk and past the index: misses agree
    dj, ij = j.batch_search_slots(q[:3], 600)
    dt, it = t.batch_search_slots(q[:3], 600)
    np.testing.assert_array_equal(it, ij)


@pytest.mark.parametrize("dt", ["bf16", "fp16", "int8"])
def test_streaming_reduced_rungs_match_jax(tmp_path, dt):
    j, t, v = _pair(tmp_path, "cosine", dt, chunk_rows=512)
    q = make_vectors(32, 16, seed=142)
    k = 10
    dj, ij = j.batch_search_slots(q, k)
    dd, it = t.batch_search_slots(q, k)
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ij, it))
    assert hits >= 0.99 * ij.size, hits / ij.size
    same = ij == it
    np.testing.assert_allclose(dd[same], dj[same], atol=1e-5, rtol=0)
    live = np.ones(len(v), bool)
    live[::97] = False
    _, gt = np_exact_topk(q, v[live], k, "cosine")
    gt = np.flatnonzero(live)[gt]
    rec = sum(len(set(a.tolist()) & set(b.tolist()))
              for a, b in zip(it, gt)) / gt.size
    assert rec >= (0.95 if dt == "int8" else 0.99), rec


@pytest.mark.parametrize("dt", ["bf16", "fp16", "int8"])
def test_host_casts_equal_numpy(dt):
    """The port's host cast of a chunk equals the JAX package's numpy /
    ml_dtypes cast bit for bit (round to nearest even; int8's scales)."""
    import ml_dtypes
    rng = np.random.default_rng(143)
    raw = (rng.standard_normal((300, 24)) * 3).astype(np.float32)
    raw[5] = 0.0                                 # a zero row: scale 1
    raw[6, :4] = [1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, 65504.0, 2 ** -20]
    out = torch.empty((304, 24), dtype=streaming_mod._CHUNK_DTYPE[dt])
    scales = torch.empty((304,), dtype=torch.float32)
    streaming_mod.cast_rows(raw, dt, out, scales)
    got = out[:300]
    if dt == "int8":
        amax = np.max(np.abs(raw), axis=1)
        s = np.where(amax > 0, amax / 127.0, 1.0)
        want = np.clip(np.rint(raw / s[:, None]), -127, 127).astype(np.int8)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(scales[:300].numpy(),
                                      s.astype(np.float32))
        # the same through a reused scratch buffer, as the stream casts
        out.zero_()
        streaming_mod.cast_rows(raw, dt, out, scales,
                                torch.full((304, 24), np.nan))
        np.testing.assert_array_equal(got.numpy(), want)
    elif dt == "bf16":
        want = raw.astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16), want)
    else:
        np.testing.assert_array_equal(got.numpy(), raw.astype(np.float16))


def test_mmap_store_directories_cross_between_packages(tmp_path):
    """mmap_store.json + vectors.f32 + sidecar.npz: a store written by
    either package opens in the other with equal rows, norms and
    tombstones, and grows there."""
    v = make_vectors(200, 8, seed=144)
    for w_cls, r_cls, sub in ((JMmapVectorStore, MmapVectorStore, "j"),
                              (MmapVectorStore, JMmapVectorStore, "t")):
        p = str(tmp_path / sub)
        w = w_cls(p, dim=8, capacity=16)
        w.put_batch(np.arange(200), v)
        w.kill(17)
        w.close()
        r = r_cls(p)
        assert r.dim == 8 and r.capacity == w.capacity
        np.testing.assert_array_equal(np.asarray(r.vectors[:200]), v)
        np.testing.assert_array_equal(r.alive[:200], np.arange(200) != 17)
        np.testing.assert_array_equal(r.sq_norms[:200], w.sq_norms[:200])
        r.put(300, v[0])
        assert r.capacity >= 301
        np.testing.assert_array_equal(r.get(300), v[0])


def test_streaming_directory_opened_by_the_other_package(tmp_path):
    """The streaming tier's mmap directory is the store's: rows written by
    JAX's StreamingExactIndex serve from the port's after a reopen."""
    v = make_vectors(700, 16, seed=145)
    p = str(tmp_path / "sx")
    j = JStreamingExactIndex(p, metric="l2", chunk_rows=256)
    j.batch_add(list(range(700)), v)
    j.close()
    t = StreamingExactIndex(p, metric="l2", chunk_rows=256)
    assert t.store.capacity >= 700 and t.store.alive[:700].all()
    # the key map is the caller's (as in JAX): slots are re-assigned
    slots = [t.slots.assign(i)[0] for i in range(700)]
    assert slots == list(range(700))
    _, it = t.batch_search_slots(v[:20], 1)
    np.testing.assert_array_equal(it[:, 0], np.arange(20))
