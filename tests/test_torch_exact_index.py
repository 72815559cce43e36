"""hnsw_tpu_torch.ExactIndex against hnsw_tpu.ExactIndex on the CPU.

Both indexes get the same keys and vectors (numpy, seeded), the same
mutations and the same queries. With host_serve_max_batch = 0 both serve
from their device scan (JAX on the CPU backend, torch on the CPU); ids
must be equal and distances within 1e-5 (f32 sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
import hnsw_tpu_torch  # noqa: E402

METRICS = ["cosine", "l2", "sqeuclidean", "dot"]


def _data(seed, n, d=32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


def _pair(metric, fast=False, host_tier=False):
    j = hnsw_tpu.ExactIndex(metric=metric, fast_math=fast)
    t = hnsw_tpu_torch.ExactIndex(metric=metric, fast_math=fast,
                                  device="cpu")
    if not host_tier:
        j.host_serve_max_batch = t.host_serve_max_batch = 0
    return j, t


def _same(j, t, queries, k):
    dj, ij = j.batch_search_slots(queries, k)
    dt, it = t.batch_search_slots(queries, k)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)
    assert dt.dtype == np.float32 and it.dtype == np.int64


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_search_matches_jax(metric, fast):
    j, t = _pair(metric, fast)
    v = _data(1, 3000)
    keys = [f"k{i}" for i in range(len(v))]
    j.batch_add(keys, v)
    t.batch_add(keys, v)
    _same(j, t, _data(2, 37), 10)


def test_add_delete_search_matches_jax():
    j, t = _pair("l2")
    v = _data(3, 1200)
    for idx in (j, t):
        idx.batch_add(list(range(1000)), v[:1000])
        idx.add(5000, v[1000])
        assert idx.batch_delete([3, 4, 999, 12345]) == [True, True, True,
                                                       False]
        idx.batch_add(list(range(2000, 2199)), v[1001:1200])  # reuses slots
    q = np.concatenate([v[[3, 4, 10]], _data(4, 20)])
    _same(j, t, q, 12)
    assert len(j) == len(t)
    kj, _ = j.batch_search(q[:4], 5)
    kt, _ = t.batch_search(q[:4], 5)
    assert kj == kt
    assert t.search(v[10], 1)[0][0] == 10


def test_k_exceeds_live_count_matches_jax():
    j, t = _pair("cosine")
    v = _data(5, 6)
    for idx in (j, t):
        idx.batch_add(list(range(6)), v)
        idx.delete(2)
    _same(j, t, _data(6, 9), 8)


def test_host_latency_tier_matches_jax():
    """Small batches take the native host scan in both packages."""
    j, t = _pair("cosine", host_tier=True)
    v = _data(7, 2000)
    j.batch_add(list(range(2000)), v)
    t.batch_add(list(range(2000)), v)
    _same(j, t, _data(8, 4), 10)


def test_empty_index_and_bad_k():
    t = hnsw_tpu_torch.ExactIndex(device="cpu")
    d, i = t.batch_search_slots(_data(9, 2), 3)
    assert np.all(i == -1) and np.all(d >= hnsw_tpu_torch.ops.distance
                                      .INF_DIST)
    with pytest.raises(ValueError):
        t.batch_search_slots(_data(9, 2), 0)


@pytest.mark.parametrize("dtype", ["bf16", "fp16", "int8", "auto"])
def test_capacity_modes_not_ported(dtype):
    """The capacity modes, once not ported, now serve like JAX's: the
    reduced scan may cut its candidate pool at another near tie, so ids
    overlap >= 0.99; both rerank in f32 with the same numpy code, so
    matched distances agree within 1e-5."""
    j = hnsw_tpu.ExactIndex(metric="cosine", hbm_dtype=dtype)
    t = hnsw_tpu_torch.ExactIndex(metric="cosine", hbm_dtype=dtype,
                                  device="cpu")
    j.host_serve_max_batch = t.host_serve_max_batch = 0
    v = _data(10, 3000)
    j.batch_add(list(range(3000)), v)
    t.batch_add(list(range(3000)), v)
    q = _data(11, 37)
    dj, ij = j.batch_search_slots(q, 10)
    dt, it = t.batch_search_slots(q, 10)
    assert t._resolved_hbm == j._resolved_hbm
    hits = sum(len(set(a) & set(b)) for a, b in zip(it, ij))
    assert hits / ij.size >= 0.99
    same = it == ij
    np.testing.assert_allclose(dt[same], dj[same], atol=1e-5, rtol=0)
    assert dt.dtype == np.float32 and it.dtype == np.int64
