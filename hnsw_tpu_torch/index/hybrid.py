"""Hybrid strategy index (port of hnsw_tpu/index/hybrid.py) — capability
parity with hybrid/hybrid.go.

Tiered static dispatch (hybrid.go:126-539):
  * dataset small (<= exact_threshold)      -> exact brute force
  * dataset very large (>= partition_size * num_partitions)
                                            -> LSH candidates + re-rank
  * otherwise                               -> HNSW graph

On an accelerator the "exact" tier is itself a batched matmul scan, so
the crossover points shift upward — thresholds stay configurable with
reference defaults. Deletes fan to every sub-index (hybrid.go:406). The
partitioner routes vectors for stats/rebalancing (hybrid.go:233).

Every sub-index lives on the engine's ``device`` (default: the CUDA
device; raises without one).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import HybridConfig, canonical_metric
from hnsw_tpu_torch.core.state import default_device, upload
from hnsw_tpu_torch.index.exact import ExactIndex
from hnsw_tpu_torch.index.hnsw import Graph
from hnsw_tpu_torch.index.ivf import IVFIndex
from hnsw_tpu_torch.index.lsh import LSHIndex
from hnsw_tpu_torch.index.partitioner import Partitioner
from hnsw_tpu_torch.ops.distance import registered
from hnsw_tpu_torch.ops.topk import exact_topk


@dataclasses.dataclass
class IndexStats:
    """hybrid.go:148-154."""
    total_vectors: int = 0
    exact_count: int = 0
    hnsw_count: int = 0
    lsh_count: int = 0
    search_count: int = 0
    last_strategy: str = ""


class HybridIndex:
    """Static-threshold hybrid dispatch (hybrid.go:126)."""

    def __init__(self, config: Optional[HybridConfig] = None, device=None,
                 **kw):
        self.cfg = config or HybridConfig(**kw)
        self.cfg.validate()
        self.device = dev = torch.device(device) if device is not None \
            else default_device()
        self.exact = ExactIndex(metric=self.cfg.metric,
                                fast_math=self.cfg.fast_exact,
                                hbm_dtype=self.cfg.exact_hbm_dtype,
                                device=dev)
        self.graph = Graph(m=self.cfg.m, ml=self.cfg.ml,
                           ef_search=self.cfg.ef_search,
                           metric=self.cfg.metric, seed=self.cfg.seed,
                           device=dev)
        if registered(self.cfg.metric) is None:
            # serving config: bf16 traversal + f32 rerank, contiguous
            # neighbor blocks, pivot-seeded entry. Custom metrics keep
            # the plain f32 path.
            self.graph.fast_math = True
            self.graph.block_layout = True
            self.graph.entry_mode = "pivots"
        self.lsh = LSHIndex(metric=self.cfg.metric,
                            num_tables=self.cfg.num_hash_tables,
                            num_bits=self.cfg.num_hash_bits,
                            seed=self.cfg.seed, device=dev)
        self.partitioner = Partitioner(self.cfg.num_partitions,
                                       metric=self.cfg.metric,
                                       seed=self.cfg.seed, device=dev)
        self.ivf = None
        if self.cfg.large_strategy == "ivf":
            self.ivf = IVFIndex(num_partitions=self.cfg.num_partitions,
                                nprobe=self.cfg.ivf_nprobe,
                                metric=self.cfg.metric,
                                seed=self.cfg.seed, device=dev)
        self.stats = IndexStats()
        #: (k, target) -> {"route": (tier, param), "n": count at calibration}
        self._calib: Dict[Tuple[int, float], Dict[str, Any]] = {}
        #: per-(k, target) validation cadence state: {"stride", "since"}.
        #: Exponential back-off on consecutive passes (1, 2, 4, ... up to
        #: _VALIDATE_MAX_STRIDE batches between oracle checks); reset to
        #: stride 1 on a miss or any mutation.
        self._vstate: Dict[Tuple[int, float], Dict[str, int]] = {}

    _VALIDATE_MAX_STRIDE = 256

    # -- sizing tiers ---------------------------------------------------------
    def _lsh_tier(self) -> bool:
        return (len(self) >=
                self.cfg.partition_size * self.cfg.num_partitions)

    def __len__(self) -> int:
        return self.stats.total_vectors

    # -- mutation --------------------------------------------------------------
    def add(self, key: Hashable, vector) -> None:
        self.batch_add([key], np.asarray(vector, np.float32)[None])

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        """Small datasets live in the exact tier; once past the
        threshold everything (incl. the exact tier's contents) migrates
        to HNSW + LSH (hybrid.go:233's Add flow, batched)."""
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if len(set(keys)) != len(keys):
            # duplicates within one batch are one stored vector, not
            # several (last write wins) — dedup before counting/storing
            order = sorted({k: i for i, k in enumerate(keys)}.values())
            keys = [keys[i] for i in order]
            vectors = vectors[order]
        fresh = sum(1 for k in keys
                    if k not in self.exact.slots
                    and k not in self.graph.slots
                    and k not in self.lsh.slots)
        new_total = self.stats.total_vectors + fresh
        if new_total <= self.cfg.exact_threshold:
            self.exact.batch_add(keys, vectors)
            self.stats.exact_count = len(self.exact)
        else:
            if len(self.exact) > 0:
                # migrate exact tier into the graph tiers
                mig_keys = self.exact.keys()
                mig_vecs = np.stack([self.exact.vector_of(k)
                                     for k in mig_keys])
                self.graph.build(mig_keys, mig_vecs)
                self.lsh.batch_add(mig_keys, mig_vecs)
                self.partitioner.batch_assign(mig_keys, mig_vecs)
                if self.ivf is not None:
                    self.ivf.batch_add(mig_keys, mig_vecs)
                self.exact.batch_delete(mig_keys)
                self.stats.exact_count = 0
            if len(keys) >= 256:
                self.graph.build(list(keys), vectors)
            else:
                self.graph.batch_add(list(keys), vectors)
            self.lsh.batch_add(keys, vectors)
            self.partitioner.batch_assign(keys, vectors)
            if self.ivf is not None:
                self.ivf.batch_add(keys, vectors)
        self.stats.total_vectors = new_total
        self.stats.hnsw_count = len(self.graph)
        self.stats.lsh_count = len(self.lsh)
        self._vstate.clear()   # mutations reset the validation back-off

    def delete(self, key: Hashable) -> bool:
        """Fan to all sub-indexes (hybrid.go:406)."""
        ok = False
        ok |= self.exact.delete(key)
        ok |= self.graph.delete(key)
        ok |= self.lsh.delete(key)
        if self.ivf is not None:
            self.ivf.delete(key)
        self.partitioner.remove(key)
        if ok:
            self.stats.total_vectors -= 1
            self.stats.exact_count = len(self.exact)
            self.stats.hnsw_count = len(self.graph)
            self.stats.lsh_count = len(self.lsh)
            self._vstate.clear()
        return ok

    def batch_delete(self, keys: Sequence[Hashable]) -> List[bool]:
        """hybrid.go:418 BatchDelete: per-key success flags, but ONE
        vectorized in-edge sweep for the whole batch — the graph tier's
        Graph.batch_delete repairs all touched neighborhoods in a
        single pass instead of one O(N*M) scan per key."""
        ok_exact = self.exact.batch_delete(keys)
        ok_graph = self.graph.batch_delete(keys)
        ok_lsh = self.lsh.batch_delete(keys)
        if self.ivf is not None:
            self.ivf.batch_delete(keys)
        for k in keys:
            self.partitioner.remove(k)
        flags = [a or b or c
                 for a, b, c in zip(ok_exact, ok_graph, ok_lsh)]
        n_ok = sum(flags)
        if n_ok:
            self.stats.total_vectors -= n_ok
            self.stats.exact_count = len(self.exact)
            self.stats.hnsw_count = len(self.graph)
            self.stats.lsh_count = len(self.lsh)
            self._vstate.clear()
        return flags

    # -- search ------------------------------------------------------------------
    def _strategy(self) -> str:
        if len(self.exact) > 0:
            return "exact"
        if self._lsh_tier():
            return "lsh"
        return "hnsw"

    # -- recall-aware routing ---------------------------------------------------
    def _oracle_scan(self, queries: np.ndarray, k: int
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        """Exact oracle over the DEVICE-RESIDENT graph arrays — the
        cheap path for per-batch route validation (``_exact_scan``
        uploads the whole host store again per call). Falls back to the
        host-store scan in the quantized capacity mode (vectors not
        resident). Cosine distances are invariant to the device store's
        prenormalization.
        """
        g = self.graph
        dev = g.device_graph()
        if dev.vectors.shape[0] <= 1:
            return self._exact_scan(queries, k)
        q = np.atleast_2d(np.asarray(queries, np.float32))
        nq = q.shape[0]
        q_pad = 1 << max(3, (nq - 1).bit_length())
        if q_pad != nq:
            q = np.pad(q, ((0, q_pad - nq), (0, 0)))
        d, i = exact_topk(torch.from_numpy(q).to(dev.vectors.device),
                          dev.vectors, dev.sq_norms, dev.alive, k=k,
                          metric=g.metric)
        i = i[:nq].cpu().numpy()
        keys = [g.slots.keys_for(row) for row in i]
        return keys, d[:nq].cpu().numpy()

    def _exact_scan(self, queries: np.ndarray, k: int
                    ) -> Tuple[List[List[Any]], np.ndarray]:
        """Brute-force scan over the graph tier's vector store (the
        ground-truth oracle once the exact tier has migrated out)."""
        g = self.graph
        n = g.slots.capacity_used
        dev = self.device
        q = np.atleast_2d(np.ascontiguousarray(queries, np.float32))
        d, i = exact_topk(torch.from_numpy(q).to(dev),
                          upload(g.store.vectors[:n], 0.0,
                                 (n, g.store.dim), dev),
                          upload(g.store.sq_norms[:n], 0.0, (n,), dev),
                          upload(g.store.alive[:n], False, (n,), dev),
                          k=k, metric=canonical_metric(self.cfg.metric))
        i = i.cpu().numpy()
        keys = [g.slots.keys_for(row) for row in i]
        return keys, d.cpu().numpy()

    def calibrate(self, k: int, target_recall: float,
                  sample: int = 64, seed: int = 0,
                  probe_queries: Optional[np.ndarray] = None
                  ) -> Tuple[str, Any]:
        """Pick the cheapest (tier, param) meeting ``target_recall``,
        measured against a sampled exact oracle over the index's own
        data. Replaces raw count thresholds when the caller states a
        recall target (IVF otherwise serves low recall on random
        data without notice). Cached per (k, target); re-measured when
        the index grows or shrinks by >25%.

        ``probe_queries`` calibrates against REAL workload queries
        instead of synthesized member probes — batch_search passes a
        sample of the incoming batch when the cached route misses its
        target on that sample (member-derived probes can be easier
        than adversarial workloads such as fully random queries)."""
        import time as _time
        key = (int(k), round(float(target_recall), 3))
        cached = self._calib.get(key)
        n_now = len(self)
        if probe_queries is None and cached is not None \
                and cached["n"] > 0 \
                and abs(n_now - cached["n"]) <= 0.25 * cached["n"]:
            return cached["route"]
        g = self.graph
        n_cap = g.slots.capacity_used
        if len(self.exact) > 0 or n_cap == 0:
            route = ("exact", None)
            self._calib[key] = {"route": route, "n": n_now}
            return route
        live = np.flatnonzero(g.store.alive[:n_cap])
        rng = np.random.default_rng(seed)
        probe = rng.choice(live, size=min(sample, len(live)),
                           replace=False)
        # Probes must be OFF-node: a query sitting exactly on a member
        # is far easier for the beam (it anchors its own basin), so
        # raw-member probes overestimate recall and under-provision
        # ef. Mixing a 15% step toward another member keeps the probe
        # near the data
        # manifold but off every node; ground truth is recomputed
        # exactly for the perturbed probes, so no self-exclusion games
        # are needed (the seed member is an honest neighbor the search
        # must find like any other).
        if probe_queries is not None:
            queries = np.atleast_2d(np.asarray(probe_queries, np.float32))
        else:
            mix = rng.choice(live, size=len(probe))
            bad = mix == probe     # collision: probe would stay ON-node
            if bad.any() and len(live) > 1:
                pos = {int(v): i for i, v in enumerate(live)}
                mix[bad] = live[(np.array([pos[int(v)]
                                           for v in probe[bad]]) + 1)
                                % len(live)]
            queries = np.asarray(
                0.85 * g.store.vectors[probe]
                + 0.15 * g.store.vectors[mix], np.float32)
        gt_keys, _ = self._oracle_scan(queries, k)
        gts = [set(row) for row in gt_keys]

        def measure(run):
            t0 = _time.perf_counter()
            keys, _ = run(queries, k)
            dt = _time.perf_counter() - t0
            hits = sum(
                len({kk for kk in row if kk is not None} & gts[qi])
                for qi, row in enumerate(keys))
            total = sum(len(gt) for gt in gts) or 1
            return hits / total, dt

        candidates: List[Tuple[str, Any]] = []
        base_ef = max(self.cfg.ef_search, k)
        for ef in (base_ef, 2 * base_ef, 64, 96, 128, 192, 256, 384):
            if ef >= k:
                candidates.append(("hnsw", int(ef)))
        if self.ivf is not None and len(self.ivf) > 0:
            for nprobe in (1, 2, 4, 8, 16, 32, 64):
                if nprobe <= self.ivf.P:
                    candidates.append(("ivf", nprobe))
        best: Optional[Tuple[str, Any]] = None
        best_dt = np.inf
        seen_params = set()
        for tier, param in candidates:
            if (tier, param) in seen_params:
                continue
            seen_params.add((tier, param))
            if tier == "hnsw":
                rec, dt = measure(
                    lambda q, kk, p=param: g.batch_search(q, kk, ef=p))
            else:
                old = self.ivf.nprobe
                self.ivf.nprobe = param
                try:
                    rec, dt = measure(
                        lambda q, kk: self.ivf.batch_search(q, kk))
                finally:
                    self.ivf.nprobe = old
            # margin above the target: a route serving exactly AT the
            # target fails the per-batch sample check ~half the time by
            # binomial noise alone, thrashing recalibration
            margin = min(0.02, (1.0 - target_recall) / 2)
            if rec >= target_recall + margin and dt < best_dt:
                best, best_dt = (tier, param), dt
        route = best if best is not None else ("exact", None)
        self._calib[key] = {"route": route, "n": n_now}
        return route

    def _route_batch(self, route: Tuple[str, Any], queries, k: int
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        tier, param = route
        if tier == "hnsw":
            return self.graph.batch_search(queries, k, ef=param)
        if tier == "ivf":
            old = self.ivf.nprobe
            self.ivf.nprobe = param
            try:
                return self.ivf.batch_search(queries, k)
            finally:
                self.ivf.nprobe = old
        return self._exact_scan(queries, k)

    def search(self, query, k: int,
               target_recall: Optional[float] = None
               ) -> List[Tuple[Any, float]]:
        self.stats.search_count += 1
        if target_recall is not None and len(self.exact) == 0:
            route = self.calibrate(k, target_recall)
            self.stats.last_strategy = f"{route[0]}:{route[1]}"
            keys, dists = self._route_batch(
                route, np.asarray(query, np.float32)[None], k)
            return [(kk, float(dd)) for kk, dd in zip(keys[0], dists[0])
                    if kk is not None]
        strat = self._strategy()
        self.stats.last_strategy = strat
        if strat == "exact":
            return self.exact.search(query, k)
        if strat == "lsh":
            if self.ivf is not None:
                return self.ivf.search(query, k)
            res = self.lsh.search(query, k)
            if len(res) >= k:
                return res
            # fallback: LSH candidates too sparse -> graph (hybrid.go:358)
            return self.graph.search(query, k)
        return self.graph.search(query, k)

    def batch_search(self, queries, k: int,
                     target_recall: Optional[float] = None
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        queries2d = np.atleast_2d(np.asarray(queries, np.float32))
        self.stats.search_count += int(queries2d.shape[0])
        if target_recall is not None and len(self.exact) == 0:
            key = (int(k), round(float(target_recall), 3))
            route = self.calibrate(k, target_recall)
            # Serve the batch through the cached route FIRST — the
            # leading rows double as the validation sample, so a
            # passing check costs zero extra route dispatches.
            got = self._route_batch(route, queries2d, k)
            if route[0] != "exact" and queries2d.shape[0] >= 8:
                # Validate against the exact oracle on <=64 real batch
                # queries (member-derived calibration probes can
                # under-provision for hard workloads).
                # Amortized: every `stride` batches, stride doubling on
                # consecutive passes up to _VALIDATE_MAX_STRIDE; a miss
                # recalibrates on the real queries and resets to 1.
                vs = self._vstate.setdefault(key,
                                             {"stride": 1, "since": 0})
                vs["since"] += 1
                if vs["since"] >= vs["stride"]:
                    vs["since"] = 0
                    ns = min(64, queries2d.shape[0])
                    sq = queries2d[:ns]
                    gt_keys, _ = self._oracle_scan(sq, k)
                    hits = sum(len({kk for kk in row if kk is not None}
                                   & set(gt))
                               for row, gt in zip(got[0][:ns], gt_keys))
                    total = sum(len(gt) for gt in gt_keys) or 1
                    if hits / total < target_recall:
                        # calibrate() re-caches the workload-derived
                        # route; re-serve the whole batch through it
                        route = self.calibrate(k, target_recall,
                                               probe_queries=sq)
                        vs["stride"] = 1
                        got = self._route_batch(route, queries2d, k)
                    else:
                        vs["stride"] = min(2 * vs["stride"],
                                           self._VALIDATE_MAX_STRIDE)
            self.stats.last_strategy = f"{route[0]}:{route[1]}"
            return got
        strat = self._strategy()
        self.stats.last_strategy = strat
        if strat == "exact":
            return self.exact.batch_search(queries, k)
        if strat == "lsh":
            if self.ivf is not None:
                return self.ivf.batch_search(queries, k)
            return self.lsh.batch_search(queries, k)
        return self.graph.batch_search(queries, k)

    # -- maintenance ----------------------------------------------------------
    def force_rebalance(self) -> int:
        """hybrid.go:526 ForceRebalance."""
        return self.partitioner.rebalance()

    def get_partition_stats(self) -> Dict[str, object]:
        """hybrid.go:517 GetPartitionStats."""
        return self.partitioner.stats()

    def get_stats(self) -> Dict[str, object]:
        return dataclasses.asdict(self.stats)

    def calibration_state(self) -> dict:
        """JSON-able snapshot of every calibration this engine has paid
        for: the target_recall route table, the core graph's
        calibrate_ef cache, and IVF auto-nprobe. Persist alongside the
        index (e.g. next to a DiskGraph) and feed back through
        restore_calibration so a reopened large index serves
        immediately instead of re-running the host oracle scans. Every
        entry carries the index size it was measured at; the >25% drift
        checks re-measure stale entries."""
        state: Dict[str, Any] = {
            "routes": [[kk, tt, c["route"][0], c["route"][1], c["n"]]
                       for (kk, tt), c in self._calib.items()],
            "graph": self.graph.calibration_state(),
        }
        if self.ivf is not None:
            state["ivf"] = self.ivf.calibration_state()
        return state

    def restore_calibration(self, state: Optional[dict]) -> None:
        """Inverse of calibration_state (no-op on None/empty)."""
        if not state:
            return
        for kk, tt, tier, param, n in state.get("routes", []):
            self._calib[(int(kk), round(float(tt), 3))] = {
                "route": (tier, None if param is None else int(param)),
                "n": int(n)}
        self.graph.restore_calibration(state.get("graph"))
        if self.ivf is not None:
            self.ivf.restore_calibration(state.get("ivf"))

    def close(self) -> None:
        self.exact.close()
        self.lsh.close()
        if self.ivf is not None:
            self.ivf.close()
