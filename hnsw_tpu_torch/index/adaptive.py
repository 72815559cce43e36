"""Adaptive hybrid index (port of hnsw_tpu/index/adaptive.py) — capability
parity with hybrid/adaptive.go + hybrid/adaptive_hybrid.go.

AdaptiveSelector: a per-query strategy bandit. Selection order mirrors
adaptive.go:196-241: ε-greedy exploration, threshold rules (size ->
exact, dim -> lsh, query-cluster hit -> hybrid, else hnsw), overridden
by a weighted performance score (latency/recall/success,
adaptive.go:346-372) once enough samples exist. Thresholds self-tune
multiplicatively from observed relative latencies (adaptive.go:316-343).
Query clustering keys on the rounded query prefix (adaptive.go:375-424).

AdaptiveHybridIndex (adaptive_hybrid.go): writes every vector to ALL
three sub-indexes and dispatches per query with fallback chains
HNSW <-> LSH -> Exact. Metrics are recorded synchronously (the
reference's detached-goroutine recording is an artifact of Go, not a
capability).

Beyond the reference: the bandit also arbitrates this engine's CAPACITY
tiers — ``exact_fast`` (bf16-operand scan + f32 rerank, same device
table as ``exact``) joins the strategy set, the exact tier honors
``HybridConfig.exact_hbm_dtype`` (bf16/int8/auto device tables for N
beyond an f32 table), and a periodic oracle probe
(AdaptiveConfig.recall_probe_interval) feeds MEASURED recall into the
score so a fast-but-wrong tier loses arbitration on workloads where
reduced precision breaks ranking (tight clusters).

Every sub-index lives on the engine's ``device`` (default: the CUDA
device; raises without one). Every arm returns numpy, so an arm's wall
time, which the bandit scores, includes its device work. ``warm(k)``
pays each arm's first-call costs before serving; ``fallback_errors``
counts the arm failures that the exact arm covered.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import AdaptiveConfig, HybridConfig
from hnsw_tpu_torch.core.state import default_device
from hnsw_tpu_torch.index.exact import ExactIndex
from hnsw_tpu_torch.index.hnsw import Graph
from hnsw_tpu_torch.index.ivf import IVFIndex
from hnsw_tpu_torch.index.lsh import LSHIndex
from hnsw_tpu_torch.telemetry import (DistanceStats, MetricsWindow, QueryMetrics)

STRATEGIES = ("exact", "exact_fast", "lsh", "hnsw", "hybrid", "ivf")
#: strategies the ε-greedy arm may explore (reference explores its three
#: base strategies, adaptive.go:199; ``exact_fast`` is this engine's
#: capacity tier — bf16 scan + f32 rerank — and must be explored for
#: the bandit to discover its latency edge; ``ivf`` is the engine's
#: large-N clustered tier — HybridConfig.large_strategy defaults to it
#: — so the flagship bandit must be able to discover and elect it too).
EXPLORE_STRATEGIES = ("exact", "exact_fast", "lsh", "hnsw", "ivf")
#: rows of the batch that AdaptiveHybridIndex.warm() sends through every
#: arm (fewer when the index holds fewer)
WARM_BATCH = 1024


class AdaptiveSelector:
    """hybrid/adaptive.go:49+."""

    def __init__(self, config: Optional[AdaptiveConfig] = None,
                 seed: int = 42):
        self.cfg = config or AdaptiveConfig()
        self.cfg.validate()
        self.metrics = MetricsWindow(self.cfg.window_size)
        self.exact_threshold = self.cfg.initial_exact_threshold
        self.dim_threshold = self.cfg.initial_dim_threshold
        self.rng = random.Random(seed)
        self.query_clusters: Dict[bytes, int] = {}
        #: arms ε-greedy may explore; AdaptiveHybridIndex extends this
        #: with its capacity rungs (exact_int8/...) and stream tier.
        self.explore: Tuple[str, ...] = EXPLORE_STRATEGIES

    # -- query clustering (adaptive.go:375-424) ------------------------------
    def _cluster_key(self, query: np.ndarray) -> bytes:
        # rounded-head bytes: same bucketing as the reference's
        # formatted-string key without per-query string formatting
        head = np.round(np.asarray(query[:8], np.float64), 1) + 0.0
        return head.tobytes()

    def observe_query_cluster(self, query: np.ndarray) -> bool:
        key = self._cluster_key(query)
        seen = self.query_clusters.get(key, 0)
        self.query_clusters[key] = seen + 1
        if len(self.query_clusters) > 10_000:  # bound memory
            self.query_clusters.clear()
        return seen >= 3

    # -- selection (adaptive.go:196-241) ---------------------------------------
    def select_strategy(self, query: np.ndarray, dataset_size: int,
                        dim: int) -> str:
        #: consumed by AdaptiveHybridIndex._backstop_arm: exploration
        #: picks of UNMEASURED arms get champion-backstopped serves.
        self.last_was_exploration = False
        if self.rng.random() < self.cfg.exploration_factor:
            self.last_was_exploration = True
            return self.rng.choice(self.explore)  # explore
        clustered = self.observe_query_cluster(query)
        if dataset_size <= self.exact_threshold:
            choice = "exact"
        elif dim > self.dim_threshold:
            choice = "lsh"
        elif clustered:
            choice = "hybrid"
        else:
            choice = "hnsw"
        if self._enough_samples():
            perf = self._select_by_performance()
            if perf is not None:
                choice = perf
        return choice

    def select_strategies_batch(self, queries: np.ndarray,
                                dataset_size: int, dim: int
                                ) -> List[str]:
        """Vectorized batch selection with an exploration QUOTA.

        Same decision rules as select_strategy, restructured for
        batches (per-query ε-greedy coin flips fragment every batch
        into small padded device groups):

          * dataset_size / dim / the performance override are
            batch-global — decided once, not per query;
          * only the cluster-hit test varies per query (vectorized
            rounding + one count-dict pass);
          * exploration spends its expected per-query volume (ε·B
            queries: floor + a Bernoulli coin on the remainder, so the
            long-run rate is ε at every B) on ONE side strategy per batch
            (rotated by the selector's rng) — ε-greedy's long-run
            exploration rates without >2 device dispatch groups.
        """
        q = np.atleast_2d(np.asarray(queries, np.float32))
        B = q.shape[0]
        # vectorized cluster keys: one rounding pass, one dict sweep
        heads = np.round(q[:, :8].astype(np.float64), 1) + 0.0
        keys = [row.tobytes() for row in heads]
        clustered = np.zeros(B, bool)
        for i, key in enumerate(keys):
            seen = self.query_clusters.get(key, 0)
            self.query_clusters[key] = seen + 1
            clustered[i] = seen >= 3
        if len(self.query_clusters) > 10_000:
            self.query_clusters.clear()

        if dataset_size <= self.exact_threshold:
            base = np.full(B, "exact", object)
        elif dim > self.dim_threshold:
            base = np.full(B, "lsh", object)
        else:
            base = np.where(clustered, "hybrid", "hnsw").astype(object)
        if self._enough_samples():
            perf = self._select_by_performance()
            if perf is not None:
                base[:] = perf
        # floor + Bernoulli(remainder): the long-run exploration rate
        # is exactly ε at EVERY batch size. ceil() over-explored small
        # batches catastrophically — at B=1 it routed 100% of queries
        # (not ε) to a random strategy.
        n_exp = 0
        if self.cfg.exploration_factor > 0:
            vol = self.cfg.exploration_factor * B
            n_exp = int(vol)
            if self.rng.random() < vol - n_exp:
                n_exp += 1
        self.last_explored_idx: set = set()
        if n_exp > 0:
            strat = self.rng.choice(self.explore)
            idx = self.rng.sample(range(B), min(n_exp, B))
            base[idx] = strat
            self.last_explored_idx = set(idx)
        return list(base)

    def _enough_samples(self) -> bool:
        return (self.metrics.total >= self.cfg.min_samples_for_adaptation
                and len(self.metrics.by_strategy) >= 2)

    def _select_by_performance(self) -> Optional[str]:
        """Weighted latency/recall/success score (adaptive.go:346-372);
        higher is better. Arms whose MEASURED recall sits below
        cfg.recall_target are a second class: any arm meeting the target
        (or unprobed) beats every arm missing it — the latency weight
        must not elect a fast-but-wrong tier (a low-recall graph arm at
        half the exact arm's latency)."""
        best, best_key = None, None
        lats = {s: st.avg_latency()
                for s, st in self.metrics.by_strategy.items() if st.count}
        if not lats:
            return None
        max_lat = max(lats.values()) or 1e-9
        target = self.cfg.recall_target
        for s, st in self.metrics.by_strategy.items():
            if st.count < 3:
                continue
            lat_score = 1.0 - (st.avg_latency() / max_lat)
            r = st.avg_recall()
            recall = 0.5 if r is None else r   # unprobed != measured 0.0
            # epsilon absorbs windowed-mean float error (mean of 20
            # exact 0.95s is 0.9499999999999998)
            below = bool(target and r is not None and r < target - 1e-6)
            score = (self.cfg.latency_weight * lat_score
                     + self.cfg.recall_weight * recall
                     + self.cfg.success_rate_weight * st.success_rate())
            key = (not below, score)           # meets-target first
            if best_key is None or key > best_key:
                best, best_key = s, key
        return best

    # -- recording + threshold adaptation (adaptive.go:244-343) ----------------
    def record(self, m: QueryMetrics) -> None:
        self.metrics.record(m)
        if self.metrics.total % 10 == 0:
            self._adapt_thresholds()

    def _adapt_thresholds(self) -> None:
        lr = self.cfg.learning_rate
        ex = self.metrics.stats("exact")
        hn = self.metrics.stats("hnsw")
        ls = self.metrics.stats("lsh")
        if ex and hn and ex.count >= 3 and hn.count >= 3:
            if ex.avg_latency() < hn.avg_latency():
                self.exact_threshold = int(self.exact_threshold * (1 + lr))
            else:
                self.exact_threshold = max(
                    100, int(self.exact_threshold * (1 - lr)))
        if ls and hn and ls.count >= 3 and hn.count >= 3:
            if ls.avg_latency() < hn.avg_latency():
                self.dim_threshold = max(
                    32, int(self.dim_threshold * (1 - lr)))
            else:
                self.dim_threshold = int(self.dim_threshold * (1 + lr))

    def get_stats(self) -> Dict[str, Any]:
        """adaptive.go:436-469 GetStats."""
        return {
            "strategies": self.metrics.as_dict(),
            "exact_threshold": self.exact_threshold,
            "dim_threshold": self.dim_threshold,
            "total_queries": self.metrics.total,
        }


class AdaptiveHybridIndex:
    """hybrid/adaptive_hybrid.go — every vector in all sub-indexes,
    per-query adaptive dispatch with fallbacks."""

    def __init__(self, hybrid_config: Optional[HybridConfig] = None,
                 adaptive_config: Optional[AdaptiveConfig] = None,
                 device=None):
        self.hcfg = hybrid_config or HybridConfig()
        self.hcfg.validate()
        self.device = dev = torch.device(device) if device is not None \
            else default_device()
        self.selector = AdaptiveSelector(adaptive_config,
                                         seed=self.hcfg.seed)
        self.exact = ExactIndex(metric=self.hcfg.metric,
                                hbm_dtype=self.hcfg.exact_hbm_dtype,
                                device=dev)
        self.graph = Graph(m=self.hcfg.m, ml=self.hcfg.ml,
                           ef_search=self.hcfg.ef_search,
                           metric=self.hcfg.metric, seed=self.hcfg.seed,
                           device=dev)
        self.lsh = LSHIndex(metric=self.hcfg.metric,
                            num_tables=self.hcfg.num_hash_tables,
                            num_bits=self.hcfg.num_hash_bits,
                            seed=self.hcfg.seed, device=dev)
        # the engine's large-N clustered tier (HybridIndex's
        # large_strategy default) — same parameterization as
        # HybridIndex's so the bandit arbitrates the identical tier the
        # tiered dispatcher ships
        self.ivf = IVFIndex(num_partitions=self.hcfg.num_partitions,
                            nprobe=self.hcfg.ivf_nprobe,
                            metric=self.hcfg.metric,
                            seed=self.hcfg.seed, device=dev)
        #: CAPACITY arms (AdaptiveConfig.capacity_arms): one strategy
        #: `exact_<rung>` per reduced-precision device-table
        #: rung, served from an ExactIndex SHARING the exact tier's
        #: slots + host store (no 2x host RAM) but with its own
        #: reduced-precision device table. The oracle probes + quality
        #: floor demote a rung that cannot rank this workload (int8 on
        #: tight clusters) within one probe interval.
        self.capacity: Dict[str, ExactIndex] = {}
        for arm in self.selector.cfg.capacity_arms:
            ex = ExactIndex(metric=self.hcfg.metric, hbm_dtype=arm,
                            device=dev)
            ex.slots = self.exact.slots
            ex.store = self.exact.store
            # the arm exists to measure its REDUCED rung — the f32
            # host latency path would mask it at small batches (the
            # f32 path is already the "exact" arm)
            ex.host_serve_max_batch = 0
            self.capacity[f"exact_{arm}"] = ex
        #: optional STREAMING tier arm (disk-resident vectors served in
        #: chunks bounded by device memory); registered via
        #: attach_stream().
        self.stream = None
        if self.capacity:
            self.selector.explore = (EXPLORE_STRATEGIES
                                     + tuple(self.capacity))
        self._dim: Optional[int] = None
        #: strategies whose first sample was dropped: a strategy's
        #: first query pays one-off costs (a kernel build, library
        #: handles, first-shape allocations), and recording that latency
        #: would bias the bandit against it. warm() marks every arm.
        self._warmed: set = set()
        #: arm failures that search / batch_search caught and covered
        #: with the exact arm (or, for a backstop, with the results they
        #: had), and the last such exception. A serving process should
        #: watch this: on the card a caught error can be a failed launch.
        self.fallback_errors = 0
        self.last_fallback_error: Optional[BaseException] = None
        #: batch_search calls since the last oracle recall probe
        #: (AdaptiveConfig.recall_probe_interval).
        self._since_probe = 0
        #: single-query search() calls since the last oracle probe.
        self._since_probe_q = 0
        #: self-tuned graph ef (None = Graph's configured default).
        #: Probe misses against recall_target double it, comfortable
        #: passes decay it back — the quality analogue of the
        #: reference's latency-threshold adaptation (adaptive.go:316).
        self._graph_ef: Optional[int] = None

    def __len__(self) -> int:
        return len(self.exact)

    # -- mutation (adaptive_hybrid.go:64-129: all three) ------------------------
    def add(self, key: Hashable, vector) -> None:
        self.batch_add([key], np.asarray(vector, np.float32)[None])

    def attach_stream(self, stream) -> None:
        """Register a StreamingExactIndex as the bandit's ``stream``
        arm (the disk tier for N >> host or device memory). The caller keeps
        ownership of its CONTENTS in sync (subsequent mutations through
        this index fan out to it like every other sub-index); the
        recall probes + quality floor arbitrate it like any arm."""
        self.stream = stream
        extra = tuple(self.capacity) + ("stream",)
        self.selector.explore = EXPLORE_STRATEGIES + extra

    def _mark_capacity_dirty(self, count: int) -> None:
        # slots + host store are shared with self.exact; the arms only
        # need their reduced-precision device tables invalidated
        for ex in self.capacity.values():
            ex._dirty = True
            ex._host_scan = None
            ex._muts_since_fit += count

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        self._dim = vectors.shape[1]
        self.exact.batch_add(keys, vectors)
        self._mark_capacity_dirty(len(keys))
        if len(keys) >= 256:
            self.graph.build(list(keys), vectors)
        else:
            self.graph.batch_add(list(keys), vectors)
        self.lsh.batch_add(keys, vectors)
        self.ivf.batch_add(keys, vectors)
        if self.stream is not None:
            self.stream.batch_add(keys, vectors)

    def delete(self, key: Hashable) -> bool:
        a = self.exact.delete(key)
        self._mark_capacity_dirty(1)
        b = self.graph.delete(key)
        c = self.lsh.delete(key)
        e = self.ivf.delete(key)
        d = self.stream.delete(key) if self.stream is not None else False
        return a or b or c or d or e

    def batch_delete(self, keys: Sequence[Hashable]) -> List[bool]:
        """One vectorized graph in-edge sweep for the whole batch
        (adaptive_hybrid.go delete fan-out, batched)."""
        a = self.exact.batch_delete(keys)
        self._mark_capacity_dirty(len(keys))
        b = self.graph.batch_delete(keys)
        c = self.lsh.batch_delete(keys)
        e = self.ivf.batch_delete(keys)
        flags = [x or y or z or w
                 for x, y, z, w in zip(a, b, c, e)]
        if self.stream is not None:
            d = self.stream.batch_delete(keys)
            flags = [f or dd for f, dd in zip(flags, d)]
        return flags

    # -- search (adaptive_hybrid.go:132-282) --------------------------------------
    def _note_fallback(self, err: BaseException) -> None:
        self.fallback_errors += 1
        self.last_fallback_error = err

    def warm(self, k: int) -> None:
        """Pay every arm's first-call costs before serving: one batch of
        WARM_BATCH stored vectors and one single query go through every
        arm, and the batch and single-query recall probes run once (the
        build of the exact-screen kernel, library handles and first-shape
        allocations land here, not in a served query). Marks every arm
        warmed, so its first served sample is recorded; records no metric
        itself. An arm that fails here raises.

        The next batch and the next single query are made probed ones.
        Left at zero, the probe counters would let the first
        recall_probe_interval - 1 batches be served by the rule-chosen
        arm (the graph at its configured ef) with no measured recall and
        so no backstop: on 4,000 x 64 Gaussian rows the first batch
        then comes back at recall@10 under 0.9, where the armed engine
        serves 0.98 or more (tests/test_torch_adaptive.py,
        test_warm_makes_the_first_served_batch_a_probed_one)."""
        if len(self) == 0:
            return
        n = self.exact.slots.capacity_used
        live = np.flatnonzero(self.exact.store.alive[:n])[:WARM_BATCH]
        qs = np.ascontiguousarray(self.exact.store.vectors[live])
        for arm in dict.fromkeys(self.selector.explore + ("hybrid",)):
            self._run_batch(arm, qs, k)
            self._run(arm, qs[0], k)
            self._warmed.add(arm)
        self._probe_oracle(qs[:32], k)
        self._probe_oracle(qs[:1], k)
        due = max(self.selector.cfg.recall_probe_interval - 1, 0)
        self._since_probe = self._since_probe_q = due

    def _exact_call(self, queries: np.ndarray, k: int, fast: bool):
        """One exact-tier sweep with the fast_math flag pinned.

        The flag is read per call (exact.py batch_search_slots), so
        toggling it runs the bf16 scan + f32 rerank capacity path on the
        SAME device-resident table — no re-upload, no second index.
        Catches nothing: a device error here reaches the caller."""
        prev = self.exact.fast_math
        self.exact.fast_math = fast
        try:
            return self.exact.batch_search(queries, k)
        finally:
            self.exact.fast_math = prev

    def _exact_is_oracle(self) -> bool:
        """Whether the exact tier's slow path is trustworthy ground
        truth: a f32 table, or the "auto" ladder (which only settles on
        a reduced rung after certifying >=0.99 arithmetic-faithful
        fidelity at k+margin — ExactIndex._resolve_hbm_dtype). A FORCED
        reduced rung (hbm_dtype="int8"/"bf16"/"fp16") carries no such
        certificate — int8 misranks tight clusters — so its output must
        not anchor the recall probe."""
        return (self.exact._resolved_hbm == "float32"
                or self.exact.hbm_dtype == "auto")

    def _probe_oracle(self, queries: np.ndarray, k: int):
        """Ground-truth keys for the recall probe, or None when no
        trustworthy oracle is affordable. Trust order: the exact tier's
        slow path when it IS an oracle (_exact_is_oracle); else the
        host f32 BLAS scan, bounded to ~2M rows (a 32-query scan stays
        sub-second there on one core)."""
        if self._exact_is_oracle():
            return self._exact_call(queries, k, fast=False)[0]
        ex = self.exact
        n = ex.slots.capacity_used
        if n > (1 << 21):
            return None
        prev_b, prev_r = ex.host_serve_max_batch, ex.host_serve_max_rows
        ex.host_serve_max_batch = max(prev_b, len(queries))
        ex.host_serve_max_rows = max(prev_r, n)
        try:
            return ex.batch_search(queries, k)[0]
        finally:
            ex.host_serve_max_batch, ex.host_serve_max_rows = prev_b, prev_r

    def _run(self, strategy: str, query: np.ndarray, k: int
             ) -> List[Tuple[Any, float]]:
        if strategy in ("exact", "exact_fast"):
            keys, dists = self._exact_call(query[None], k,
                                           strategy == "exact_fast")
            return [(kk, float(dd)) for kk, dd in zip(keys[0], dists[0])
                    if kk is not None]
        if strategy in self.capacity or strategy == "stream":
            sub = self.stream if strategy == "stream" \
                else self.capacity[strategy]
            keys, dists = sub.batch_search(query[None], k)
            return [(kk, float(dd)) for kk, dd in zip(keys[0], dists[0])
                    if kk is not None]
        if strategy == "lsh":
            return self.lsh.search(query, k)
        if strategy == "ivf":
            return self.ivf.search(query, k)
        if strategy == "hybrid":
            # LSH candidates + graph refinement, merged
            res = {k_: d for k_, d in self.lsh.search(query, k)}
            for k_, d in self.graph.search(query, k, ef=self._graph_ef):
                res.setdefault(k_, d)
            return sorted(res.items(), key=lambda r: r[1])[:k]
        return self.graph.search(query, k, ef=self._graph_ef)

    def search(self, query, k: int) -> List[Tuple[Any, float]]:
        query = np.asarray(query, np.float32)
        strat = self.selector.select_strategy(
            query, len(self), self._dim or len(query))
        explored = getattr(self.selector, "last_was_exploration", False)
        t0 = time.perf_counter()
        success = True
        try:
            res = self._run(strat, query, k)
            # fallback chain (adaptive_hybrid.go:145-233)
            if len(res) < min(k, len(self)):
                for fb in ("hnsw", "lsh", "exact"):
                    if fb == strat:
                        continue
                    res = self._run(fb, query, k)
                    if len(res) >= min(k, len(self)):
                        strat = fb
                        # the serve is now the FALLBACK's, not the
                        # exploration pick's — don't double-serve it
                        explored = False
                        break
        except Exception as err:
            self._note_fallback(err)
            success = False
            res = self.exact.search(query, k)
            strat = "exact"
        dt = time.perf_counter() - t0
        # oracle probe every Nth single query (the batch path already
        # probes): without it the single-query bandit only ever sees
        # latency, and a fast low-recall graph arm beats the
        # exact arm forever. Probe cost stays out of the recorded
        # latency — it measures quality, not the serving path.
        recall = (1.0 if strat == "exact" and self._exact_is_oracle()
                  else None)
        interval = self.selector.cfg.recall_probe_interval
        if interval > 0 and success and recall is None:
            self._since_probe_q += 1
            if self._since_probe_q >= interval:
                self._since_probe_q = 0
                ok = self._probe_oracle(query[None], k)
                if ok is not None:
                    oracle = {kk for kk in ok[0] if kk is not None}
                    if oracle:
                        recall = (len(oracle & {kk for kk, _ in res})
                                  / len(oracle))
                        self._note_recall(strat, recall)
        if strat in self._warmed:
            self.selector.record(QueryMetrics(
                strategy=strat, duration_s=dt, result_count=len(res),
                success=success, recall=recall,
                distance_stats=DistanceStats.from_distances(
                    [d for _, d in res])))
        else:
            self._warmed.add(strat)
        # serve the champion when the explored/rule-picked arm is
        # measured below the quality floor (its metrics above stay —
        # exploration keeps learning; the user keeps quality)
        champ = (self._backstop_arm(strat, explored=explored)
                 if success else None)
        if champ is not None:
            t0 = time.perf_counter()
            try:
                res_c = self._run(champ, query, k)
            except Exception as err:
                self._note_fallback(err)
                return res
            # keep the fallback chain's completeness guarantee: only
            # serve the champion when it is at least as complete
            if len(res_c) >= len(res):
                res = res_c
            if champ in self._warmed:
                self.selector.record(QueryMetrics(
                    strategy=champ,
                    duration_s=time.perf_counter() - t0,
                    result_count=len(res_c), success=True,
                    recall=(1.0 if champ == "exact"
                            and self._exact_is_oracle() else None),
                    distance_stats=DistanceStats.from_distances(
                        [d for _, d in res_c])))
            else:
                self._warmed.add(champ)
        return res

    def _run_batch(self, strategy: str, queries: np.ndarray, k: int
                   ) -> List[List[Tuple[Any, float]]]:
        """One batched device sweep for a whole strategy group."""
        if strategy in ("exact", "exact_fast"):
            keys, dists = self._exact_call(queries, k,
                                           strategy == "exact_fast")
        elif strategy in self.capacity or strategy == "stream":
            sub = self.stream if strategy == "stream" \
                else self.capacity[strategy]
            keys, dists = sub.batch_search(queries, k)
        elif strategy == "lsh":
            keys, dists = self.lsh.batch_search(queries, k)
        elif strategy == "ivf":
            keys, dists = self.ivf.batch_search(queries, k)
        elif strategy == "hybrid":
            lk, ld = self.lsh.batch_search(queries, k)
            gk, gd = self.graph.batch_search(queries, k,
                                             ef=self._graph_ef)
            out = []
            for qi in range(len(queries)):
                merged = {kk: dd for kk, dd in zip(lk[qi], ld[qi])
                          if kk is not None}
                for kk, dd in zip(gk[qi], gd[qi]):
                    if kk is not None:
                        merged.setdefault(kk, dd)
                out.append(sorted(merged.items(), key=lambda r: r[1])[:k])
            return out
        else:
            keys, dists = self.graph.batch_search(queries, k,
                                                  ef=self._graph_ef)
        return [[(kk, float(dd)) for kk, dd in zip(keys[qi], dists[qi])
                 if kk is not None] for qi in range(len(queries))]

    def _backstop_arm(self, strategy: str,
                      explored: bool = False) -> Optional[str]:
        """Champion arm whose results should REPLACE a serve from
        ``strategy`` when that arm is measured below recall_target —
        or is an UNMEASURED ε-greedy pick (``explored``).

        ε-greedy exploration (and the pre-adaptation threshold rules)
        must keep running below-target arms to keep their metrics
        fresh — but the reference's flagship table serves 0.96-0.98
        recall, and 10% of queries served raw at 0.3-0.5 recall caps
        the mix at ~0.94. So: explore in the shadow, serve the
        champion. A measured arm MEETING the target serves its own
        results (no extra cost in steady state)."""
        target = self.selector.cfg.recall_target
        if not target:
            return None
        st = self.selector.metrics.stats(strategy)
        r = st.avg_recall() if st is not None else None
        if r is None and not explored:
            return None
        if r is not None and r >= target - 1e-6:
            return None
        # below target: prefer the exact oracle (recall 1.0 by
        # construction); else the performance pick if IT meets target
        if strategy != "exact" and self._exact_is_oracle():
            return "exact"
        perf = self.selector._select_by_performance()
        if perf and perf != strategy:
            ps = self.selector.metrics.stats(perf)
            pr = ps.avg_recall() if ps is not None else None
            if pr is not None and pr >= target - 1e-6:
                return perf
        return None

    def _note_recall(self, strategy: str, recall: Optional[float]) -> None:
        """Feed a measured group recall into the graph tier's ef
        self-tuning. A miss against cfg.recall_target doubles ef (cap
        cfg.max_ef); a comfortable pass (target + 0.03) decays it 25%
        back toward the configured default, so a transient hard batch
        does not pin the tier at max_ef forever."""
        target = self.selector.cfg.recall_target
        if recall is None or not target or strategy not in ("hnsw",
                                                            "hybrid"):
            return
        base = self.graph.ef_search
        cur = self._graph_ef or base
        if recall < target:
            # ceiling never tunes BELOW the configured default: with
            # ef_search=1536 and max_ef=1024 a probe miss must not
            # LOWER the serving ef
            self._graph_ef = min(max(cur * 2, base),
                                 max(self.selector.cfg.max_ef, base))
        elif recall > min(target + 0.03, 0.998) and cur > base:
            # cap the decay bar below 1.0 so a high target (0.98+)
            # can still shed a transient ef bump
            self._graph_ef = max(base, int(cur * 0.75))

    def batch_search(self, queries, k: int) -> List[List[Tuple[Any, float]]]:
        """Batched adaptive dispatch: select strategies for the whole
        batch at once (exploration quota caps the group count at 2 —
        see AdaptiveSelector.select_strategies_batch), one batched
        device sweep per group, then ONE consolidated exact sweep over
        every shortfall row — the guaranteed tail of the reference's
        per-query fallback chain (adaptive_hybrid.go:145-233) without
        per-group re-dispatch. Metric recording is bounded by the
        sliding window size: recording B metrics into a maxlen-100
        deque is O(B) Python for <= 100 survivors."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        B = queries.shape[0]
        dim = self._dim or queries.shape[1]
        strategies = self.selector.select_strategies_batch(
            queries, len(self), dim)
        groups: Dict[str, List[int]] = {}
        for qi, s in enumerate(strategies):
            groups.setdefault(s, []).append(qi)
        out: List[Optional[List[Tuple[Any, float]]]] = [None] * B
        want = min(k, len(self))
        shortfall: List[int] = []
        # oracle recall probe (AdaptiveConfig.recall_probe_interval):
        # every Nth call, score each non-exact group's leading <=32
        # results against one f32 exact sweep and feed the measured
        # recall to the bandit. Without it avg_recall defaults to 0.5
        # for every arm and the latency weight alone would keep a fast
        # wrong tier (bf16 ranking collapses on tight clusters).
        interval = self.selector.cfg.recall_probe_interval
        probe_due = interval > 0 and self._since_probe + 1 >= interval
        self._since_probe = 0 if probe_due else self._since_probe + 1
        group_ok: Dict[str, bool] = {}
        for strat, idxs in groups.items():
            qs = queries[idxs]
            t0 = time.perf_counter()
            success = True
            try:
                results = self._run_batch(strat, qs, k)
            except Exception as err:
                self._note_fallback(err)
                success = False
                results = self._run_batch("exact", qs, k)
            group_ok[strat] = success
            dt = (time.perf_counter() - t0) / max(len(idxs), 1)
            for j, qi in enumerate(idxs):
                out[qi] = results[j]
                if len(results[j]) < want and success:
                    shortfall.append(qi)
            # None = unprobed (telemetry treats it as "no measurement",
            # NOT zero); the exact arm is 1.0 only when its slow path is
            # actually an oracle — a FORCED reduced hbm rung is probed
            # like any other arm (against the host f32 oracle)
            exact_oracle = self._exact_is_oracle()
            grp_recall = 1.0 if (strat == "exact" and exact_oracle) \
                else None
            probe_this = (probe_due and success and idxs
                          and not (strat == "exact" and exact_oracle))
            if probe_this:
                np_ = min(32, len(idxs))
                ok = self._probe_oracle(qs[:np_], k)
                if ok is not None:
                    hits = tot = 0
                    for j in range(np_):
                        oracle = {kk for kk in ok[j] if kk is not None}
                        got = {kk for kk, _ in results[j]}
                        hits += len(oracle & got)
                        tot += len(oracle)
                    grp_recall = hits / tot if tot else None
                    self._note_recall(strat, grp_recall)
            if strat in self._warmed:
                # stride-sample down to the window size (extra records
                # would only be evicted from the deque anyway)
                W = self.selector.cfg.window_size
                step = max(1, len(results) // W)
                for r in results[::step][:W]:
                    self.selector.record(QueryMetrics(
                        strategy=strat, duration_s=dt,
                        result_count=len(r), success=success,
                        recall=grp_recall,
                        distance_stats=DistanceStats.from_distances(
                            [d for _, d in r])))
            else:
                self._warmed.add(strat)
        # champion backstop (see _backstop_arm): queries served by a
        # measured-below-target arm are re-served from the champion,
        # one batched sweep per champion arm. The below-target group's
        # own run above already recorded its metrics — exploration
        # keeps learning while the served results keep quality.
        backstops: Dict[str, List[int]] = {}
        explored_idx = getattr(self.selector, "last_explored_idx", set())
        for strat, idxs in groups.items():
            if not group_ok.get(strat, False):
                continue   # group already served by the exact fallback
            ch = self._backstop_arm(strat)
            if ch is not None:            # measured below target: all
                backstops.setdefault(ch, []).extend(idxs)
                continue
            exp = [qi for qi in idxs if qi in explored_idx]
            if exp:                       # unmeasured exploration picks
                ch = self._backstop_arm(strat, explored=True)
                if ch is not None:
                    backstops.setdefault(ch, []).extend(exp)
        for ch, idxs in backstops.items():
            try:
                res_c = self._run_batch(ch, queries[idxs], k)
            except Exception as err:
                self._note_fallback(err)
                continue
            for qi, r in zip(idxs, res_c):
                # never trade completeness for the backstop; an
                # incomplete champion result joins the shortfall tail
                if len(r) >= len(out[qi] or ()):
                    out[qi] = r
                if len(r) < want:
                    shortfall.append(qi)
        if shortfall:
            sf = sorted(set(shortfall))
            fb_res = self._run_batch("exact", queries[sf], k)
            for qi, r in zip(sf, fb_res):
                if len(r) > len(out[qi] or ()):
                    out[qi] = r
        return out  # type: ignore[return-value]

    def get_stats(self) -> Dict[str, Any]:
        return self.selector.get_stats()

    def close(self) -> None:
        self.exact.close()
        self.lsh.close()
        self.ivf.close()
        for ex in self.capacity.values():
            ex.close()
        if self.stream is not None:
            self.stream.close()
