"""hnsw_tpu_torch.AdaptiveHybridIndex and AdaptiveSelector on the CPU.

The selector is host code: with the same seed, the same queries and the
same recorded metrics it must decide exactly as hnsw_tpu's does, single
queries and batches, thresholds and statistics included. The engine's
specs of tests/test_hybrid.py run against the port, the stream arm with a
real StreamingExactIndex and the DiskGraph part of the batch_delete
facade spec included. ``warm()`` and ``fallback_errors`` are the port's
own: they are checked here.
"""

import unittest.mock as mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.config import AdaptiveConfig as JAdaptiveConfig  # noqa: E402
from hnsw_tpu.index.adaptive import (  # noqa: E402
    AdaptiveSelector as JAdaptiveSelector)
from hnsw_tpu.telemetry import QueryMetrics as JQueryMetrics  # noqa: E402
from hnsw_tpu_torch import (AdaptiveConfig, AdaptiveHybridIndex,  # noqa: E402
                            AdaptiveSelector, HybridConfig)
from hnsw_tpu_torch.index import adaptive as adaptive_mod  # noqa: E402
from hnsw_tpu_torch.index import hnsw as hnsw_mod  # noqa: E402
from hnsw_tpu_torch.ops.topk import np_exact_topk  # noqa: E402
from hnsw_tpu_torch.telemetry import MetricsWindow, QueryMetrics  # noqa: E402
from tests.conftest import make_vectors  # noqa: E402


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


def _adaptive(hybrid=None, adaptive=None):
    return AdaptiveHybridIndex(hybrid_config=hybrid, adaptive_config=adaptive,
                               device="cpu")


def _served_recall(out, gt, k):
    return np.mean([len({kk for kk, _ in out[i]} & set(map(int, gt[i]))) / k
                    for i in range(len(gt))])


# ---------------------------------------------- selector against the JAX one

@pytest.mark.parametrize("explore", [0.0, 0.3])
def test_selector_decides_as_jax_for_same_seed_and_metrics(explore):
    cfg = dict(exploration_factor=explore, min_samples_for_adaptation=12,
               recall_target=0.9)
    sj = JAdaptiveSelector(JAdaptiveConfig(**cfg), seed=7)
    st = AdaptiveSelector(AdaptiveConfig(**cfg), seed=7)
    rng = np.random.default_rng(5)
    arms = ["exact", "hnsw", "lsh", "ivf", "hybrid"]
    picks_j, picks_t = [], []
    for step in range(60):
        q = np.round(rng.standard_normal((6, 16)), 1).astype(np.float32)
        n, dim = (80, 16) if step % 7 == 0 else (5000, 16 if step % 5 else
                                                 2048)
        picks_j.append(sj.select_strategy(q[0], n, dim))
        picks_t.append(st.select_strategy(q[0], n, dim))
        assert st.last_was_exploration == sj.last_was_exploration
        picks_j.append(sj.select_strategies_batch(q, n, dim))
        picks_t.append(st.select_strategies_batch(q, n, dim))
        assert st.last_explored_idx == sj.last_explored_idx
        m = dict(strategy=arms[step % 5],
                 duration_s=float(rng.random()) * 1e-3, result_count=10,
                 success=bool(step % 11),
                 recall=(float(rng.random()) if step % 3 else None))
        sj.record(JQueryMetrics(**m))
        st.record(QueryMetrics(**m))
    assert picks_t == picks_j
    assert st._select_by_performance() == sj._select_by_performance()
    assert st.get_stats() == sj.get_stats()
    assert (st.exact_threshold, st.dim_threshold) == \
        (sj.exact_threshold, sj.dim_threshold)


# --------------------- port twins of tests/test_hybrid.py (adaptive engine)

def test_adaptive_selector_thresholds_and_exploration():
    sel = AdaptiveSelector(AdaptiveConfig(exploration_factor=0.0))
    q = np.ones(16, np.float32)
    assert sel.select_strategy(q, 100, 16) == "exact"
    assert sel.select_strategy(q, 10_000, 1024) == "lsh"
    q2 = np.arange(16).astype(np.float32)
    assert sel.select_strategy(q2, 10_000, 64) == "hnsw"
    for _ in range(4):
        sel.select_strategy(q2, 10_000, 64)
    assert sel.select_strategy(q2, 10_000, 64) == "hybrid"


def test_adaptive_selector_performance_override():
    sel = AdaptiveSelector(AdaptiveConfig(exploration_factor=0.0,
                                          min_samples_for_adaptation=10))
    for _ in range(20):
        sel.record(QueryMetrics(strategy="hnsw", duration_s=0.001,
                                result_count=10, recall=0.99))
        sel.record(QueryMetrics(strategy="exact", duration_s=0.1,
                                result_count=10, recall=1.0))
    assert sel.select_strategy(np.ones(8, np.float32), 50, 8) == "hnsw"


def test_adaptive_hybrid_end_to_end():
    v = make_vectors(300, 24, seed=67)
    a = _adaptive(HybridConfig(exact_threshold=100),
                  AdaptiveConfig(exploration_factor=0.0))
    a.batch_add(list(range(300)), v)
    assert len(a) == 300
    res = a.search(v[11], 5)
    assert res[0][0] == 11
    a.search(v[12], 5)  # first sample per strategy is warm-up, unrecorded
    assert a.get_stats()["total_queries"] >= 1
    assert a.delete(11)
    assert a.search(v[11], 5)[0][0] != 11
    assert len(a.batch_search(v[:4], 3)) == 4
    assert a.fallback_errors == 0


def test_adaptive_batch_search_groups_by_strategy():
    v = make_vectors(500, 16, seed=91)
    q = make_vectors(64, 16, seed=92)
    a = _adaptive(adaptive=AdaptiveConfig(exploration_factor=0.0))
    a.batch_add(list(range(500)), v)
    res = a.batch_search(q, 5)
    assert len(res) == 64
    assert all(len(r) == 5 for r in res)
    res_self = a.batch_search(v[:16], 1)
    assert [r[0][0] for r in res_self] == list(range(16))
    a.batch_search(q, 5)
    assert a.get_stats()["total_queries"] >= 64


def test_adaptive_exact_fast_capacity_tier():
    v = make_vectors(400, 24, seed=103)
    a = _adaptive(HybridConfig(exact_threshold=100),
                  AdaptiveConfig(exploration_factor=0.0,
                                 min_samples_for_adaptation=10))
    a.batch_add(list(range(400)), v)
    for _ in range(20):
        a.selector.record(QueryMetrics(strategy="exact_fast",
                                       duration_s=0.0005,
                                       result_count=5, recall=0.99))
        a.selector.record(QueryMetrics(strategy="hnsw", duration_s=0.05,
                                       result_count=5, recall=0.9))
    strategies = a.selector.select_strategies_batch(v[:8], 400, 24)
    assert set(strategies) == {"exact_fast"}
    out = a.batch_search(v[:8], 5)
    assert [r[0][0] for r in out] == list(range(8))


def test_adaptive_recall_probe_feeds_bandit():
    v = make_vectors(600, 24, seed=104)
    a = _adaptive(HybridConfig(exact_threshold=100),
                  AdaptiveConfig(exploration_factor=0.0,
                                 initial_exact_threshold=100,
                                 recall_probe_interval=1))
    a.batch_add(list(range(600)), v)
    a.batch_search(v[:16], 5)   # warm-up (unrecorded)
    a.batch_search(v[:16], 5)
    st = a.get_stats()["strategies"].get("hnsw")
    assert st is not None and st["avg_recall"] > 0.5, st


def test_selector_score_penalizes_wrong_fast_tier():
    sel = AdaptiveSelector(AdaptiveConfig(exploration_factor=0.0,
                                          min_samples_for_adaptation=10))
    for _ in range(20):
        sel.record(QueryMetrics(strategy="exact_fast", duration_s=0.0019,
                                result_count=10, recall=0.2))
        sel.record(QueryMetrics(strategy="exact", duration_s=0.002,
                                result_count=10, recall=1.0))
    assert sel._select_by_performance() == "exact"


def test_measured_zero_recall_is_recorded_not_dropped():
    w = MetricsWindow(window_size=10)
    w.record(QueryMetrics(strategy="lsh", duration_s=0.001,
                          result_count=10, recall=0.0))
    assert w.by_strategy["lsh"].avg_recall() == 0.0
    w2 = MetricsWindow(window_size=10)
    w2.record(QueryMetrics(strategy="lsh", duration_s=0.001,
                           result_count=10))          # unprobed
    assert w2.by_strategy["lsh"].avg_recall() is None


def test_forced_reduced_exact_tier_is_not_its_own_oracle():
    rng = np.random.default_rng(3)
    data = rng.standard_normal((300, 32)).astype(np.float32)
    a = _adaptive(HybridConfig(), AdaptiveConfig())
    a.exact.hbm_dtype = "int8"
    a.exact._resolved_hbm = "int8"
    assert not a._exact_is_oracle()
    assert _adaptive(HybridConfig(), AdaptiveConfig())._exact_is_oracle()
    for i in range(300):
        a.add(i, data[i])
    ok = a._probe_oracle(data[:4], 3)
    assert ok is not None
    for j in range(4):
        assert ok[j][0] == j               # self-NN


def test_below_target_arm_loses_arbitration_despite_latency():
    sel = AdaptiveSelector(AdaptiveConfig(exploration_factor=0.0,
                                          min_samples_for_adaptation=10,
                                          recall_target=0.95))
    for _ in range(20):
        sel.record(QueryMetrics(strategy="hnsw", duration_s=0.00015,
                                result_count=10, recall=0.34))
        sel.record(QueryMetrics(strategy="exact", duration_s=0.0003,
                                result_count=10, recall=1.0))
    assert sel._select_by_performance() == "exact"
    sel2 = AdaptiveSelector(AdaptiveConfig(exploration_factor=0.0,
                                           min_samples_for_adaptation=10,
                                           recall_target=0.99))
    for _ in range(20):
        sel2.record(QueryMetrics(strategy="hnsw", duration_s=0.001,
                                 result_count=10, recall=0.5))
        sel2.record(QueryMetrics(strategy="lsh", duration_s=0.001,
                                 result_count=10, recall=0.9))
    assert sel2._select_by_performance() == "lsh"


def test_probe_miss_self_tunes_graph_ef():
    a = _adaptive(HybridConfig(ef_search=20),
                  AdaptiveConfig(recall_target=0.95, max_ef=128))
    assert a._graph_ef is None
    a._note_recall("hnsw", 0.6)
    assert a._graph_ef == 40
    a._note_recall("hnsw", 0.6)
    a._note_recall("hybrid", 0.6)
    a._note_recall("hnsw", 0.6)
    assert a._graph_ef == 128              # capped at max_ef
    a._note_recall("hnsw", 0.999)
    assert a._graph_ef == 96               # decays on comfortable pass
    a._note_recall("exact", 0.1)           # non-graph arms: no-op
    assert a._graph_ef == 96
    a._note_recall("hnsw", None)
    assert a._graph_ef == 96


def test_adaptive_serves_target_recall_on_random_data():
    n, d, k = 2000, 64, 10
    v = make_vectors(n, d, seed=105)
    q = make_vectors(64, d, seed=106)
    a = _adaptive(HybridConfig(exact_threshold=100, ef_search=20),
                  AdaptiveConfig(exploration_factor=0.0,
                                 initial_exact_threshold=100,
                                 min_samples_for_adaptation=6,
                                 recall_probe_interval=1,
                                 recall_target=0.95))
    a.batch_add(list(range(n)), v)
    for _ in range(4):                     # probes feed the bandit
        a.batch_search(q[:32], k)
    out = a.batch_search(q, k)
    _, gt = np_exact_topk(q, v, k, "cosine")
    rec = _served_recall(out, gt, k)
    assert rec >= 0.9, rec
    assert a.fallback_errors == 0


def test_exploration_serves_champion_backstop():
    n, d, k = 800, 32, 5
    v = make_vectors(n, d, seed=107)
    a = _adaptive(HybridConfig(exact_threshold=100),
                  AdaptiveConfig(exploration_factor=0.0,
                                 min_samples_for_adaptation=10,
                                 recall_target=0.95))
    a.batch_add(list(range(n)), v)
    for _ in range(12):
        a.selector.record(QueryMetrics(strategy="lsh", duration_s=0.001,
                                       result_count=k, recall=0.3))
        a.selector.record(QueryMetrics(strategy="exact",
                                       duration_s=0.002,
                                       result_count=k, recall=1.0))
    assert a._backstop_arm("lsh") == "exact"
    assert a._backstop_arm("exact") is None
    assert a._backstop_arm("hnsw") is None   # unmeasured: no backstop
    a._warmed.update(("lsh", "exact"))
    with mock.patch.object(a.selector, "select_strategies_batch",
                           return_value=["lsh"] * 8):
        out = a.batch_search(v[:8], k)
    assert [r[0][0] for r in out] == list(range(8))
    for r in out:
        assert r[0][1] < 1e-5
    with mock.patch.object(a.selector, "select_strategy",
                           return_value="lsh"):
        res = a.search(v[3], k)
    assert res[0][0] == 3 and res[0][1] < 1e-5


def test_strategy_stats_running_sums_match_window():
    rng = np.random.default_rng(9)
    w = MetricsWindow(window_size=16)
    for i in range(100):
        w.record(QueryMetrics(
            strategy="hnsw", duration_s=float(rng.random()),
            result_count=10,
            recall=(float(rng.random()) if i % 3 else None),
            success=bool(i % 7)))
    st = w.by_strategy["hnsw"]
    lats = [m.duration_s for m in st.window]
    recs = [m.recall for m in st.window if m.recall is not None]
    assert abs(st.avg_latency() - sum(lats) / len(lats)) < 1e-12
    assert abs(st.avg_recall() - sum(recs) / len(recs)) < 1e-12
    assert abs(st.success_rate()
               - sum(1 for m in st.window if m.success) / len(st.window)
               ) < 1e-12


def test_adaptive_batch_delete_is_a_single_sweep(monkeypatch):
    """Port twin of the AdaptiveHybridIndex part of tests/test_hybrid.py's
    batch_delete facade spec."""
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
    n, d = 300, 16
    data = np.random.default_rng(3).standard_normal((n, d)).astype(
        np.float32)
    doomed = list(range(0, n, 3)) + ["never-added"]
    a = _adaptive()
    a.batch_add(list(range(n)), data)
    flags = a.batch_delete(doomed)
    assert calls["batch"] == 1 and calls["single"] == 0, calls
    assert flags[:-1] == [True] * (len(doomed) - 1) and not flags[-1]
    assert len(a) == len(a.ivf) == len(a.lsh) == n - (len(doomed) - 1)


def _clustered(n, d, nc, nq, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32) * 5
    data = (centers[rng.integers(0, nc, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    q = (centers[rng.integers(0, nc, nq)]
         + 0.3 * rng.standard_normal((nq, d)).astype(np.float32))
    return data, q


def test_bandit_capacity_arm_demoted_on_clustered_data():
    n, d, k = 3000, 32, 10
    data, q = _clustered(n, d, 30, 16, seed=7)
    _, gt = np_exact_topk(q, data, k, "cosine")
    idx = _adaptive(adaptive=AdaptiveConfig(
        capacity_arms=("int8", "fp16"), recall_probe_interval=1,
        recall_target=0.95, exploration_factor=1.0))
    assert "exact_int8" in idx.selector.explore
    idx.batch_add(list(range(n)), data)
    idx.selector.explore = ("exact_int8",)
    for _ in range(2):
        out = idx.batch_search(q, k)
    st = idx.selector.metrics.stats("exact_int8")
    assert st is not None and st.avg_recall() is not None
    assert st.avg_recall() < 0.95, st.avg_recall()   # measured broken
    assert idx._backstop_arm("exact_int8") == "exact"
    rec = _served_recall(out, gt, k)                 # champion served
    assert rec >= 0.95, rec
    idx.selector.explore = ("exact_fp16",)
    for _ in range(2):
        idx.batch_search(q, k)
    st16 = idx.selector.metrics.stats("exact_fp16")
    assert st16 is not None and st16.avg_recall() is not None
    assert st16.avg_recall() >= 0.95, st16.avg_recall()
    assert idx._backstop_arm("exact_fp16") is None
    assert idx.fallback_errors == 0
    idx.close()


def test_bandit_ivf_arm_elected_on_clustered_data():
    n, d, k = 50_000, 32, 10
    data, q = _clustered(n, d, 500, 32, seed=11)
    idx = _adaptive(adaptive=AdaptiveConfig(
        recall_probe_interval=1, recall_target=0.95,
        exploration_factor=1.0))
    assert "ivf" in idx.selector.explore
    idx.batch_add(list(range(n)), data)
    assert len(idx.ivf) == n            # writes fan out to the arm
    idx.selector.explore = ("ivf",)
    for _ in range(2):
        out = idx.batch_search(q, k)
    st = idx.selector.metrics.stats("ivf")
    assert st is not None and st.avg_recall() is not None
    assert st.avg_recall() >= 0.95, st.avg_recall()
    assert idx._backstop_arm("ivf") is None   # meets the floor
    _, gt = np_exact_topk(q, data, k, "cosine")
    rec = _served_recall(out, gt, k)
    assert rec >= 0.95, rec
    for arm in ("hnsw", "lsh"):
        for _ in range(5):
            idx.selector.record(QueryMetrics(
                strategy=arm, duration_s=1e-4, result_count=k,
                success=True, recall=0.5))
    idx.selector.metrics.by_strategy.pop("exact", None)
    assert idx.selector._select_by_performance() == "ivf"
    idx.selector.cfg = AdaptiveConfig(
        recall_probe_interval=1, recall_target=0.95,
        exploration_factor=0.0)
    before = idx.selector.metrics.stats("ivf").count
    out2 = idx.batch_search(q, k)
    assert idx.selector.metrics.stats("ivf").count > before
    rec2 = _served_recall(out2, gt, k)
    assert rec2 >= 0.95, rec2
    assert idx.delete(0)                # deletes fan out to the arm
    assert len(idx.ivf) == n - 1
    assert idx.fallback_errors == 0
    idx.close()
    assert idx.ivf._dev is None


# ------------------------------------------- warm(), fallback_errors, device

def test_warm_runs_and_marks_every_arm_and_records_nothing():
    v = make_vectors(400, 16, seed=108)
    a = _adaptive(HybridConfig(exact_threshold=100),
                  AdaptiveConfig(capacity_arms=("int8",),
                                 exploration_factor=0.0,
                                 initial_exact_threshold=100))
    a.warm(5)                            # empty index: nothing to do
    assert a._warmed == set()
    a.batch_add(list(range(400)), v)
    seen = []
    real_batch, real_one = a._run_batch, a._run
    with mock.patch.object(a, "_run_batch", side_effect=lambda s, q, k: (
            seen.append((s, len(q))), real_batch(s, q, k))[1]), \
         mock.patch.object(a, "_run", side_effect=lambda s, q, k: (
            seen.append((s, 1)), real_one(s, q, k))[1]):
        a.warm(5)
    arms = {"exact", "exact_fast", "hnsw", "lsh", "ivf", "hybrid",
            "exact_int8"}
    assert a._warmed == arms
    assert {s for s, _ in seen} == arms
    # one batch (WARM_BATCH rows, or every stored row) and one query an arm
    assert {(s, 400) for s in arms} | {(s, 1) for s in arms} == set(seen)
    assert a.get_stats()["total_queries"] == 0
    assert a.fallback_errors == 0
    # the next batch and the next single query are probed ones
    due = a.selector.cfg.recall_probe_interval - 1
    assert (a._since_probe, a._since_probe_q) == (due, due)
    # a warmed arm's first served query is recorded, not dropped
    a.search(v[3], 5)
    assert a.get_stats()["total_queries"] == 1
    assert a._since_probe_q == 0
    assert a.get_stats()["strategies"]["hnsw"]["avg_recall"] is not None


def test_warm_raises_what_an_arm_raises():
    v = make_vectors(300, 16, seed=109)
    a = _adaptive()
    a.batch_add(list(range(300)), v)
    with mock.patch.object(a.lsh, "batch_search",
                           side_effect=RuntimeError("launch failed")):
        with pytest.raises(RuntimeError, match="launch failed"):
            a.warm(5)
    assert a.fallback_errors == 0


def test_warm_batch_is_capped_at_warm_batch_rows(monkeypatch):
    monkeypatch.setattr(adaptive_mod, "WARM_BATCH", 48)
    v = make_vectors(300, 16, seed=111)
    a = _adaptive()
    a.batch_add(list(range(300)), v)
    sizes = []
    real = a._run_batch
    with mock.patch.object(a, "_run_batch", side_effect=lambda s, q, k: (
            sizes.append(len(q)), real(s, q, k))[1]):
        a.warm(5)
    assert set(sizes) == {48}


@pytest.mark.parametrize("armed", [True, False])
def test_warm_makes_the_first_served_batch_a_probed_one(armed):
    """Why warm() arms the probe counters: with them left at zero the
    first batches are served by the rule-chosen graph arm at its
    configured ef, unmeasured and so without a backstop."""
    rng = np.random.default_rng(3)
    n, d, k = 4000, 64, 10
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((64, d)).astype(np.float32)
    _, gt = np_exact_topk(q, v, k, "cosine")
    a = _adaptive(HybridConfig(exact_threshold=100),
                  AdaptiveConfig(exploration_factor=0.0,
                                 initial_exact_threshold=100))
    a.batch_add(list(range(n)), v)
    a.warm(k)
    if not armed:
        a._since_probe = a._since_probe_q = 0
    rec = _served_recall(a.batch_search(q, k), gt, k)
    if armed:
        assert rec >= 0.98, rec          # probed, found low, backstopped
        assert a.get_stats()["strategies"]["hnsw"]["avg_recall"] < 0.9
    else:
        assert rec < 0.9, rec            # the graph at ef 20, unmeasured
        assert a.get_stats()["strategies"]["hnsw"]["avg_recall"] is None


def test_fallback_errors_counts_what_the_exact_arm_covered():
    v = make_vectors(300, 16, seed=110)
    a = _adaptive(HybridConfig(exact_threshold=100),
                  AdaptiveConfig(exploration_factor=0.0,
                                 initial_exact_threshold=100))
    a.batch_add(list(range(300)), v)
    boom = RuntimeError("arm down")
    with mock.patch.object(a.graph, "search", side_effect=boom), \
         mock.patch.object(a.graph, "batch_search", side_effect=boom):
        res = a.search(v[4], 3)                      # served all the same
        assert res[0][0] == 4
        assert a.fallback_errors == 1 and a.last_fallback_error is boom
        out = a.batch_search(v[:8], 3)
        assert [r[0][0] for r in out] == list(range(8))
        assert a.fallback_errors == 2
    before = a.fallback_errors
    a.batch_search(v[:8], 3)
    assert a.fallback_errors == before


def test_an_exact_arm_failure_is_not_covered():
    v = make_vectors(200, 16, seed=111)
    a = _adaptive(adaptive=AdaptiveConfig(exploration_factor=0.0))
    a.batch_add(list(range(200)), v)           # 200 <= threshold: exact arm
    with mock.patch.object(a.exact, "batch_search",
                           side_effect=RuntimeError("no kernel")), \
         mock.patch.object(a.exact, "search",
                           side_effect=RuntimeError("no kernel")):
        with pytest.raises(RuntimeError, match="no kernel"):
            a.search(v[0], 3)
        with pytest.raises(RuntimeError, match="no kernel"):
            a.batch_search(v[:4], 3)


def test_every_arm_lives_on_the_engine_device_and_returns_numpy():
    v = make_vectors(300, 16, seed=112)
    a = _adaptive(adaptive=AdaptiveConfig(capacity_arms=("fp16",)))
    for sub in (a.exact, a.graph, a.lsh, a.ivf, *a.capacity.values()):
        assert sub.device == torch.device("cpu")
    a.batch_add(list(range(300)), v)
    for arm in a.selector.explore + ("hybrid",):
        rows = a._run_batch(arm, v[:20], 4)
        assert len(rows) == 20
        for key, dist in rows[0]:
            assert isinstance(dist, (float, np.floating))
            assert not torch.is_tensor(key)
        assert all(isinstance(d, float) for _, d in a._run(arm, v[0], 4))


def test_attach_stream_registers_the_arm_and_fans_out(tmp_path):
    """The stream arm is an attribute and a fan-out: writes and deletes
    reach the attached StreamingExactIndex, which serves the arm."""
    from hnsw_tpu_torch.index.streaming import StreamingExactIndex
    v = make_vectors(300, 16, seed=113)
    a = _adaptive(adaptive=AdaptiveConfig(exploration_factor=1.0,
                                          recall_probe_interval=1,
                                          recall_target=0.9))
    a.attach_stream(StreamingExactIndex(str(tmp_path / "st"),
                                        chunk_rows=128, device="cpu"))
    assert "stream" in a.selector.explore
    a.batch_add(list(range(300)), v)
    assert len(a.stream) == 300
    a.selector.explore = ("stream",)
    for _ in range(2):
        out = a.batch_search(v[:8], 3)
    assert [r[0][0] for r in out] == list(range(8))
    assert a.selector.metrics.stats("stream").avg_recall() >= 0.9
    assert a.delete(0) and len(a.stream) == 299
    assert a.batch_delete([1, 2]) == [True, True] and len(a.stream) == 297


def test_bandit_stream_arm_serves_and_is_probed(tmp_path):
    """Port of tests/test_hybrid.py's stream-arm spec: the streaming
    (disk) tier joins the bandit via attach_stream, writes fan out to it,
    its arm serves real results and the oracle probe measures it."""
    from hnsw_tpu_torch.index.streaming import StreamingExactIndex
    n, d, k = 600, 16, 5
    v = make_vectors(n, d, seed=77)
    q = make_vectors(8, d, seed=78)
    idx = _adaptive(adaptive=AdaptiveConfig(
        recall_probe_interval=1, recall_target=0.9,
        exploration_factor=1.0))
    idx.attach_stream(StreamingExactIndex(str(tmp_path / "st"),
                                          metric="cosine", device="cpu"))
    assert "stream" in idx.selector.explore
    idx.batch_add(list(range(n)), v)
    assert len(idx.stream) == n

    idx.selector.explore = ("stream",)
    for _ in range(2):
        out = idx.batch_search(q, k)
    st = idx.selector.metrics.stats("stream")
    assert st is not None and st.count > 0
    # streaming exact is f32-faithful: measured at 1.0
    assert st.avg_recall() is not None and st.avg_recall() >= 0.9
    _, gt = np_exact_topk(q, v, k, "cosine")
    assert _served_recall(out, gt, k) >= 0.9
    assert idx.delete(0)
    assert len(idx.stream) == n - 1
    idx.close()


def test_disk_graph_batch_delete_is_a_single_sweep(monkeypatch, tmp_path):
    """Port of the DiskGraph part of tests/test_hybrid.py's batch_delete
    facade spec: one Graph.batch_delete sweep, WAL records per successful
    key, per-key flags."""
    from hnsw_tpu_torch import DiskGraph
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
    n, d = 300, 16
    data = np.random.default_rng(3).standard_normal((n, d)).astype(
        np.float32)
    doomed = list(range(0, n, 3)) + ["never-added"]
    dg = DiskGraph(str(tmp_path / "dg"), device="cpu")
    dg.batch_add(list(range(n)), data)
    calls.update(batch=0, single=0)
    flags = dg.batch_delete(doomed)
    assert calls["batch"] == 1 and calls["single"] == 0, calls
    assert flags[:-1] == [True] * (len(doomed) - 1) and not flags[-1]
    assert len(dg) == n - (len(doomed) - 1)
    assert sum(c.type == "delete" for c in dg.wal.pending) \
        == len(doomed) - 1
    dg._stop_flusher.set()
