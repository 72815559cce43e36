"""hnsw_tpu_torch.HybridIndex against hnsw_tpu's on the CPU.

The same seeded rows go into both packages' HybridIndex. The host graph
builder is the same C++ engine with the same seed, so both hold the same
graph: the exact oracles (``_exact_scan``, ``_oracle_scan``) agree within
1e-5 with equal keys, both calibrate a route that serves a recall target,
and the tiered dispatch picks the same tier. The hybrid specs of
tests/test_hybrid.py run against the port as well, and
``MultiIndexAdapter`` over the port's indexes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.config import HybridConfig as JHybridConfig  # noqa: E402
from hnsw_tpu.index.hybrid import HybridIndex as JHybridIndex  # noqa: E402
from hnsw_tpu_torch import (ExactIndex, Graph, HybridConfig,  # noqa: E402
                            HybridIndex, LSHIndex, MultiIndexAdapter)
from hnsw_tpu_torch.index import hnsw as hnsw_mod  # noqa: E402
from hnsw_tpu_torch.index.adapters import SearchableIndex  # noqa: E402
from hnsw_tpu_torch.ops.topk import np_exact_topk  # noqa: E402
from tests.conftest import make_vectors  # noqa: E402


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


def _recall(keys, gt, k):
    hits = sum(len({x for x in keys[i] if x is not None} &
                   set(map(int, gt[i]))) for i in range(len(gt)))
    return hits / (len(gt) * k)


def _pair(n=1200, d=24, seed=100, **cfg):
    v = (make_vectors(n, d, seed=seed, kind="clustered") / 30).astype(
        np.float32)
    j = JHybridIndex(JHybridConfig(exact_threshold=100, **cfg))
    t = HybridIndex(HybridConfig(exact_threshold=100, **cfg), device="cpu")
    j.batch_add(list(range(n)), v)
    t.batch_add(list(range(n)), v)
    return j, t, v


# --------------------------------------------------- against the JAX package

def test_exact_oracles_match_jax():
    j, t, v = _pair()
    for idx in (j, t):
        assert idx.delete(5)
    q = v[:20] + 0.01 * make_vectors(20, v.shape[1], seed=101)
    for name in ("_exact_scan", "_oracle_scan"):
        kj, dj = getattr(j, name)(q, 8)
        kt, dt = getattr(t, name)(q, 8)
        assert kt == kj, name
        np.testing.assert_allclose(dt, np.asarray(dj), atol=1e-5, rtol=0)
        assert isinstance(dt, np.ndarray)
        assert all(5 not in row for row in kt)
    # the two oracles are one function of the same rows
    ka, _ = t._exact_scan(q, 8)
    kb, _ = t._oracle_scan(q, 8)
    assert ka == kb


def test_tiered_dispatch_matches_jax():
    # the LSH tier: an IVF tier would be trained apart in each package
    j, t, v = _pair(n=700, partition_size=30, num_partitions=8,
                    large_strategy="lsh")
    assert t._lsh_tier() and j._lsh_tier()
    assert t._strategy() == j._strategy() == "lsh"
    kj, dj = j.batch_search(v[:12], 5)
    kt, dt = t.batch_search(v[:12], 5)
    assert t.stats.last_strategy == j.stats.last_strategy
    # same planes, same buckets, same f32 rerank
    assert kt == kj
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)
    assert t.get_partition_stats() == j.get_partition_stats()
    assert vars(t.stats) == vars(j.stats)


def test_calibrated_route_meets_the_target_as_in_jax():
    """The route is the fastest candidate that meets the target, picked by
    wall time, so the two packages may settle on different ones: each must
    come from the same candidate list and serve the target."""
    j, t, v = _pair(large_strategy="ivf", num_partitions=16,
                    partition_size=50)
    q = v[:40] + 0.01 * make_vectors(40, v.shape[1], seed=102)
    kj, _ = j.batch_search(q, 10, target_recall=0.9)
    kt, _ = t.batch_search(q, 10, target_recall=0.9)
    for idx in (j, t):
        (tier, param), = {c["route"] for c in idx._calib.values()}
        assert tier in ("hnsw", "ivf", "exact")
        assert idx.stats.last_strategy.startswith(tier)
    _, gt = np_exact_topk(q, v, 10, "cosine")
    assert _recall(kt, gt, 10) >= 0.88 and _recall(kj, gt, 10) >= 0.88
    assert set(t.calibration_state()) == set(j.calibration_state())


def test_calibration_state_round_trip():
    _, t, v = _pair(n=600)
    t.batch_search(v[:16], 5, target_recall=0.9)
    state = t.calibration_state()
    assert state["routes"] and state["routes"][0][:2] == [5, 0.9]
    other = HybridIndex(HybridConfig(exact_threshold=100), device="cpu")
    other.restore_calibration(state)
    assert other._calib.keys() == t._calib.keys()


# ------------------------- port twins of tests/test_hybrid.py (hybrid tier)

def test_hybrid_small_uses_exact():
    v = make_vectors(50, 16, seed=64)
    h = HybridIndex(config=HybridConfig(exact_threshold=100), device="cpu")
    h.batch_add(list(range(50)), v)
    res = h.search(v[7], 5)
    assert res[0][0] == 7
    assert h.stats.last_strategy == "exact"
    assert len(h) == 50


def test_hybrid_migrates_past_threshold():
    v = make_vectors(300, 16, seed=65)
    h = HybridIndex(config=HybridConfig(exact_threshold=100), device="cpu")
    h.batch_add(list(range(100)), v[:100])
    assert h.stats.last_strategy == ""
    assert len(h.exact) == 100
    h.batch_add(list(range(100, 300)), v[100:])
    assert len(h.exact) == 0            # migrated
    assert len(h.graph) == 300
    res = h.search(v[42], 5)
    assert res[0][0] == 42
    assert h.stats.last_strategy == "hnsw"
    _, gt = np_exact_topk(v[:10], v, 5, "cosine")
    keys, _ = h.batch_search(v[:10], 5)
    assert _recall(keys, gt, 5) >= 0.8


def test_hybrid_delete_fans_out():
    v = make_vectors(150, 8, seed=66)
    h = HybridIndex(config=HybridConfig(exact_threshold=50), device="cpu")
    h.batch_add(list(range(150)), v)
    assert h.delete(3)
    assert not h.delete(3)
    assert len(h) == 149
    keys, _ = h.batch_search(v[3:4], 5)
    assert 3 not in keys[0]
    assert h.get_partition_stats()["total"] == 149
    assert h.force_rebalance() >= 0


def test_multi_index_adapter():
    v = make_vectors(80, 8, seed=68)
    e = ExactIndex(device="cpu")
    l = LSHIndex(device="cpu")
    m = MultiIndexAdapter([e, l])
    m.batch_add(list(range(80)), v)
    assert len(m) == 80
    res = m.search(v[9], 5)
    assert res[0][0] == 9
    assert m.delete(9)
    assert m.search(v[9], 1)[0][0] != 9
    assert isinstance(e, SearchableIndex)
    assert isinstance(Graph(seed=0, device="cpu"), SearchableIndex)


def test_hybrid_ivf_large_strategy():
    v = make_vectors(400, 16, seed=130)
    h = HybridIndex(config=HybridConfig(exact_threshold=50,
                                        partition_size=30,
                                        num_partitions=8,
                                        large_strategy="ivf",
                                        ivf_nprobe=8), device="cpu")
    h.batch_add(list(range(400)), v)
    assert h._lsh_tier()          # 400 >= 30*8
    res = h.search(v[9], 5)
    assert res[0][0] == 9
    assert h.stats.last_strategy == "lsh"  # tier name; backed by ivf
    assert h.ivf is not None and len(h.ivf) == 400
    assert h.ivf.device.type == "cpu"
    assert h.delete(9)
    assert h.search(v[9], 1)[0][0] != 9
    h.close()
    assert h.ivf._dev is None


def test_hybrid_readd_does_not_inflate_count():
    v = make_vectors(30, 8, seed=150)
    h = HybridIndex(config=HybridConfig(exact_threshold=100), device="cpu")
    h.batch_add(list(range(30)), v)
    h.batch_add(list(range(10)), v[:10])  # re-add = replace
    assert len(h) == 30
    h.add(5, v[5])
    assert len(h) == 30


def test_hybrid_duplicate_keys_in_batch_counted_once():
    v = make_vectors(4, 8, seed=90)
    h = HybridIndex(exact_threshold=1000, device="cpu")
    h.batch_add(["a", "b", "a"], v[:3])
    assert len(h) == 2
    assert h.stats.total_vectors == 2
    res = h.search(v[2], 1)                 # last write wins
    assert res[0][0] == "a" and res[0][1] < 1e-5
    h.batch_add(["a", "b"], v[2:4])
    assert h.stats.total_vectors == 2


@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_target_recall_routing_meets_target(kind):
    n, d, k, target = 2000, 24, 10, 0.95
    v = make_vectors(n, d, seed=100, kind=kind)
    q = make_vectors(50, d, seed=101, kind=kind)
    h = HybridIndex(HybridConfig(exact_threshold=100,
                                 large_strategy="ivf",
                                 num_partitions=16, partition_size=50),
                    device="cpu")
    h.batch_add(list(range(n)), v)
    keys, _ = h.batch_search(q, k, target_recall=target)
    _, gt_i = np_exact_topk(q, v, k, "cosine")
    recall = _recall(keys, gt_i, k)
    assert recall >= target - 0.03, (h.stats.last_strategy, recall)
    tier = h.stats.last_strategy            # the route is cached
    h.batch_search(q, k, target_recall=target)
    assert h.stats.last_strategy == tier


def test_target_recall_one_means_exact_quality():
    n, d, k = 1500, 16, 5
    v = make_vectors(n, d, seed=102)
    h = HybridIndex(HybridConfig(exact_threshold=100), device="cpu")
    h.batch_add(list(range(n)), v)
    res = h.search(v[7], k, target_recall=1.0)
    assert res[0][0] == 7 and res[0][1] < 1e-5


def test_hybrid_batch_delete_is_a_single_sweep(monkeypatch):
    """Port twin of the HybridIndex part of tests/test_hybrid.py's
    batch_delete facade spec: one Graph.batch_delete, no per-key loop."""
    calls = {"batch": 0, "single": 0}
    real_batch = hnsw_mod.Graph.batch_delete
    real_single = hnsw_mod.Graph.delete

    def spy_batch(self, keys, refine=False):
        calls["batch"] += 1
        return real_batch(self, keys, refine=refine)

    def spy_single(self, key):
        calls["single"] += 1
        return real_single(self, key)

    monkeypatch.setattr(hnsw_mod.Graph, "batch_delete", spy_batch)
    monkeypatch.setattr(hnsw_mod.Graph, "delete", spy_single)
    rng = np.random.default_rng(3)
    n, d = 300, 16
    data = rng.standard_normal((n, d)).astype(np.float32)
    doomed = list(range(0, n, 3)) + ["never-added"]
    h = HybridIndex(config=HybridConfig(exact_threshold=50), device="cpu")
    h.batch_add(list(range(n)), data)
    calls.update(batch=0, single=0)
    flags = h.batch_delete(doomed)
    assert calls["batch"] == 1 and calls["single"] == 0, calls
    assert flags[:-1] == [True] * (len(doomed) - 1) and flags[-1] is False
    keys_out, _ = h.batch_search(data[:8], 5)
    gone = set(doomed[:-1])
    assert all(kk not in gone for row in keys_out for kk in row)
    assert h.stats.total_vectors == n - (len(doomed) - 1)


def test_every_sub_index_lives_on_the_engine_device():
    h = HybridIndex(HybridConfig(large_strategy="ivf"), device="cpu")
    for sub in (h.exact, h.graph, h.lsh, h.partitioner, h.ivf):
        assert sub.device == torch.device("cpu")
