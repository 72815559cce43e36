"""hnsw_tpu_torch.LSHIndex against hnsw_tpu's on the CPU.

The re-rank function gets the same seeded inputs in both packages:
distances within 1e-5, the -1 padding masked alike. Searches are compared
on an index carried across with ``convert.lsh_from_jax`` (same planes,
buckets and store): equal keys, distances within 1e-5, on the device
path (batches above host_serve_max_batch) and the host latency path.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.index import lsh as jlsh  # noqa: E402
from hnsw_tpu_torch import LSHIndex  # noqa: E402
from hnsw_tpu_torch.convert import lsh_from_jax  # noqa: E402
from hnsw_tpu_torch.index import lsh as tlsh  # noqa: E402
from hnsw_tpu_torch.ops.topk import np_exact_topk  # noqa: E402
from tests.conftest import make_vectors  # noqa: E402


@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
def test_rerank_matches_jax(metric):
    rng = np.random.default_rng(11)
    v = rng.standard_normal((256, 24)).astype(np.float32)
    sq = np.sum(v * v, axis=1)
    q = rng.standard_normal((16, 24)).astype(np.float32)
    cands = rng.integers(0, 256, (16, 32)).astype(np.int64)
    cands[:, 20:] = -1
    cands[3] = -1
    dj = np.asarray(jlsh._lsh_rerank(jnp.asarray(q), jnp.asarray(v),
                                     jnp.asarray(sq), jnp.asarray(cands),
                                     metric))
    dt = tlsh._lsh_rerank(torch.from_numpy(q), torch.from_numpy(v),
                          torch.from_numpy(sq), torch.from_numpy(cands),
                          metric).numpy()
    np.testing.assert_array_equal(dt >= 1e38, cands < 0)
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)


def _filled_pair(metric="cosine", n=600, d=24, seed=60):
    # embedding scale: the Gram-form l2 cancels at large coordinates
    v = (make_vectors(n, d, seed=seed, kind="clustered") / 30).astype(
        np.float32)
    j = jlsh.LSHIndex(metric=metric, num_tables=6, num_bits=6)
    j.batch_add(list(range(n)), v)
    return j, lsh_from_jax(j, device="cpu"), v


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("batch", [40, 4])
def test_search_on_a_carried_index_matches_jax(metric, batch):
    j, t, v = _filled_pair(metric)
    q = v[:batch] + 0.01 * make_vectors(batch, v.shape[1], seed=61)
    assert (batch <= t.host_serve_max_batch) == (batch == 4)
    kj, dj = j.batch_search(q, 10)
    kt, dt = t.batch_search(q, 10)
    assert kt == kj
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)
    assert t.get_candidates(q[0]) == j.get_candidates(q[0])


def test_batch_add_builds_the_same_buckets_as_jax():
    v = make_vectors(300, 16, seed=62)
    j = jlsh.LSHIndex()
    t = LSHIndex(device="cpu")
    j.batch_add(list(range(300)), v)
    t.batch_add(list(range(300)), v)
    np.testing.assert_array_equal(t.planes, j.planes)
    assert t.tables == j.tables


def test_lsh_recall_reasonable():
    """Port twin of tests/test_hybrid.py's LSH recall spec."""
    n, d, k = 400, 32, 10
    v = make_vectors(n, d, seed=60, kind="clustered")
    idx = LSHIndex(num_tables=8, num_bits=6, device="cpu")
    idx.batch_add(list(range(n)), v)
    q = v[:20] + 0.01 * make_vectors(20, d, seed=61)
    _, gt = np_exact_topk(q, v, k, "cosine")
    keys, _ = idx.batch_search(q, k)
    hits = sum(len({x for x in keys[i] if x is not None} &
                   set(map(int, gt[i]))) for i in range(20))
    assert hits / (20 * k) >= 0.3
    for i in range(20):
        assert keys[i][0] == i


def test_lsh_candidates_and_delete():
    v = make_vectors(100, 16, seed=62)
    idx = LSHIndex(device="cpu")
    idx.batch_add(list(range(100)), v)
    assert 5 in idx.get_candidates(v[5])
    assert idx.delete(5)
    assert 5 not in idx.get_candidates(v[5])
    assert not idx.delete(5)
    assert len(idx) == 99


def test_lsh_duplicate_key_replace():
    idx = LSHIndex(device="cpu")
    idx.add("a", np.ones(8, np.float32))
    idx.add("a", -np.ones(8, np.float32))
    assert len(idx) == 1
    assert idx.search(-np.ones(8, np.float32), 1)[0][0] == "a"


def test_device_table_is_rebuilt_after_a_mutation_and_dropped_on_close():
    v = make_vectors(64, 8, seed=3)
    idx = LSHIndex(device="cpu")
    idx.batch_add(list(range(64)), v)
    idx.batch_search(v[:32], 3)
    table, _ = idx._dev
    assert table.device.type == "cpu" and table.shape == (64, 8)
    idx.add(64, v[0] * 2)
    idx.batch_search(v[:32], 3)
    assert idx._dev[0].shape == (128, 8)
    idx.close()
    assert idx._dev is None
    assert idx.batch_search(v[:32], 1)[0][5] == [5]
