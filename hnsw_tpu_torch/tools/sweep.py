"""Benchmark sweep of the port (counterpart of ``benchmarks/sweep.py``).

    python3 -m hnsw_tpu_torch.tools.sweep [--small] [--cpu] [--big]

Prints one JSON row per measurement. The configurations are the JAX
sweep's, each a method of ``Sweep`` that returns its rows:

  1. cosine graph build + search, 10k x 128 Gaussian rows: the ef sweep,
     the block layout + pivot entry, ef autoscale, the exact tier (f32
     and fast_math, with ``mfu`` / ``floor_frac``), IVF fixed and "auto";
  2. l2 and dot graphs on normalised 10k x 100 rows (GloVe-100 angular's
     shape; synthetic: no dataset is downloaded);
  3. batch delete with neighbour repair, with and without refinement;
  4. the adaptive engine: a batch, single-query latency (native graph
     and adaptive), the reference's adaptive table, ``target_recall``
     routing on random and clustered rows;
  5. faceted and negative-example query overhead;
  6. disk-tier operation timings (``DiskGraph``: parquet and arrow, or
     npz where pyarrow is missing) and the Arrow appender;
  7. 10k x 512 exact (full size only) and the distance surface's cost;
  8. ``--big``: K1's roofline ladder, 1,048,576 and 8,388,608 rows x 128
     with 8,192 queries (f32 and fast_math at 1M, fast_math at 8M), rows
     generated on the card from a seeded ``torch.Generator``; all 8,192
     queries of each row are held against the plain scan
     (``ops/topk.exact_topk``), f32 at 8M too.

``--small`` runs reduced sizes (800 x 32, 64 queries); ``--cpu`` runs on
the CPU. Without ``--cpu`` the sweep runs on the CUDA card or exits with
an error. Every exact scan goes through ``ops/exact_screen.exact_scan``
(K1 at >= 32,768 rows on the card), and every timed call ends in a
synchronisation of the card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from typing import Iterator, List

import numpy as np
import torch


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


#: widest f32 distance gap that counts as a tie between an exact scan and
#: the plain one: their f32 sums of 128 products differ by <= 2.4e-7 (two
#: ulps at 1.0; 200k x 128 cosine, 256 queries), the median gap between
#: neighbouring ranks is 2.8e-3
TIE_TOL = 4e-6


def plain_agreement(res, plain) -> tuple:
    """(ok, entries whose id differs) of an exact scan's (dists, ids)
    against the plain scan's. ok: each row holds k distinct ids, and at
    every rank the distance is within ``TIE_TOL`` of the plain scan's, so
    an id differs only where two rows tie to f32 rounding (the two scans
    sum in other orders)."""
    kd, ki = res
    gd, gi = plain
    srt = torch.sort(ki, dim=1).values
    distinct = bool((ki >= 0).all() and (srt[:, 1:] != srt[:, :-1]).all())
    close = bool(((kd - gd).abs() <= TIE_TOL).all())
    return distinct and close, int((ki != gi).sum())


def recall_of(ids, gt, k: int) -> float:
    hits = sum(len({int(x) for x in ids[i][:k] if x is not None and
                    (not hasattr(x, "item") or x >= 0)} &
                   set(map(int, gt[i][:k]))) for i in range(len(gt)))
    return hits / (len(gt) * k)


class Sweep:
    """The sweep's data and the graph configurations 1, 4 and 5 share."""

    #: the ladder's rows and queries (config 8)
    BIG_ROWS = (1 << 20, 8 << 20)
    BIG_QUERIES = 8192

    def __init__(self, small: bool = False, device=None, big: bool = False):
        from hnsw_tpu_torch.core.state import default_device
        from hnsw_tpu_torch.ops.topk import np_exact_topk
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.platform = "gpu" if self.device.type == "cuda" else "cpu"
        self.small, self.big = small, big
        self.n = 800 if small else 10_000
        self.d, self.k = (32 if small else 128), 10
        self.n_q = 64 if small else 1024
        rng = np.random.default_rng(0)
        self.data = rng.standard_normal((self.n, self.d)).astype(np.float32)
        self.queries = rng.standard_normal((self.n_q, self.d)).astype(
            np.float32)
        _, self.gt = np_exact_topk(self.queries, self.data, self.k, "cosine")
        self._graph = None
        self._build_s = 0.0

    # -- shared state ------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _row(self, **kw) -> dict:
        return {**kw, "platform": self.platform}

    def _timed(self, fn, reps: int = 1):
        """(mean s of ``reps`` calls after one warm call, last result)."""
        out = fn()
        self._sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        self._sync()
        return (time.perf_counter() - t0) / reps, out

    def graph(self):
        """Config 1's cosine graph (m=16, wave 1024, fast_math), built on
        first use; configs 4 and 5 serve from it."""
        if self._graph is None:
            from hnsw_tpu_torch import Graph
            g = Graph(m=16, metric="cosine", seed=0, device=self.device)
            t0 = time.perf_counter()
            g.build(list(range(self.n)), self.data, wave=1024)
            self._build_s = time.perf_counter() - t0
            g.fast_math = True
            self._graph = g
        return self._graph

    def _angular(self):
        """Config 2's normalised rows and queries, and the generator after
        them: the JAX sweep's draws in its order (seed 0)."""
        rng = np.random.default_rng(0)
        rng.standard_normal((self.n, self.d))
        rng.standard_normal((self.n_q, self.d))
        d2n = 32 if self.small else 100
        ang = rng.standard_normal((self.n, d2n)).astype(np.float32)
        ang /= np.linalg.norm(ang, axis=1, keepdims=True)
        q2 = rng.standard_normal((self.n_q, d2n)).astype(np.float32)
        q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
        return ang, q2, rng

    def _exact_row(self, config, strategy, qd, vectors, v_sq, alive, gt,
                   fast: bool) -> dict:
        from hnsw_tpu_torch.ops.exact_screen import exact_scan
        from hnsw_tpu_torch.utils.roofline import (matmul_floor_dt,
                                                   roofline_fields)
        dt, r = self._timed(lambda: exact_scan(
            qd, vectors, v_sq, alive, k=self.k, metric="cosine",
            fast_math=fast), reps=3)
        floor = matmul_floor_dt(qd, vectors, fast_math=fast)
        nq = qd.shape[0]
        return self._row(
            config=config, strategy=strategy, qps=round(nq / dt, 0),
            **{"recall@10": round(recall_of(r[1].cpu().numpy(), gt,
                                            self.k), 4)},
            **roofline_fields(n_q=nq, n=vectors.shape[0], d=qd.shape[1],
                              dt=dt, floor_dt=floor, platform=self.platform))

    # -- configurations ----------------------------------------------------
    def config1(self) -> List[dict]:
        """Cosine build + search sweep, the exact tier and IVF."""
        from hnsw_tpu_torch import IVFIndex
        from hnsw_tpu_torch.core.search import search_graph
        g, k, n_q, gt = self.graph(), self.k, self.n_q, self.gt
        queries = self.queries
        rows = [self._row(config="cosine_10kx128",
                          metric="bulk_build_seconds", n=self.n,
                          value=round(self._build_s, 1))]
        dev = g.device_graph()
        qd = torch.from_numpy(queries).to(self.device)
        for ef, E in ((96, 1), (192, 1), (256, 2), (320, 2), (384, 4)):
            dt, r = self._timed(lambda: search_graph(
                dev, qd, k=k, ef=ef, metric="cosine",
                max_hops=max(128, 2 * ef // E), fast_math=True, expand=E),
                reps=3)
            rows.append(self._row(
                config="cosine_10kx128", strategy="hnsw", ef=ef,
                qps=round(n_q / dt, 0),
                **{"recall@10": round(recall_of(r[1].cpu().numpy(), gt, k),
                                      4)}))

        # serving configuration: neighbour blocks + pivot entry
        g.block_layout = True
        g.entry_mode = "pivots"
        for ef in (192, 256, 384):
            dt, (_, i_out) = self._timed(
                lambda: g.batch_search_slots(queries, k, ef=ef), reps=3)
            rows.append(self._row(
                config="cosine_10kx128", strategy="hnsw_block_piv", ef=ef,
                qps=round(n_q / dt, 0),
                **{"recall@10": round(recall_of(i_out, gt, k), 4)}))
        g.block_layout = False
        g.entry_mode = "descent"

        # ef autoscale: calibrate_ef installs the cheapest ef meeting the
        # target on a sample of the real workload, then the default-ef
        # search rides it
        for tgt in (0.9, 0.95):
            t0 = time.perf_counter()
            ef_c, rec_c = g.calibrate_ef(tgt, k=k, seed=3,
                                         probe_queries=queries[:64])
            cal_s = time.perf_counter() - t0
            dt, (_, i_out) = self._timed(
                lambda: g.batch_search_slots(queries, k), reps=3)
            rows.append(self._row(
                config="cosine_10kx128", strategy="hnsw_autoef", target=tgt,
                ef=ef_c, probe_recall=round(rec_c, 4),
                calibrate_seconds=round(cal_s, 2), qps=round(n_q / dt, 0),
                **{"recall@10": round(recall_of(i_out, gt, k), 4)}))
            g._ef_calib.clear()
        g._ef_default = None

        for fast in (False, True):
            rows.append(self._exact_row(
                "cosine_10kx128", "exact_fast" if fast else "exact", qd,
                dev.vectors, dev.sq_norms, dev.alive, gt, fast))

        # IVF at a fixed probe count (the ablation row), then "auto", which
        # calibrates the smallest nprobe meeting the 0.9 recall floor
        for strategy, kw in (("ivf_p32_probe8", {"nprobe": 8}),
                             ("ivf_p32_auto", {})):
            ivf = IVFIndex(num_partitions=32, kmeans_iters=5,
                           device=self.device, **kw)
            try:
                ivf.build(list(range(self.n)), self.data)
                dt, (keys, _) = self._timed(
                    lambda: ivf.batch_search(queries, k))
                extra = ({} if kw else
                         {"nprobe": ivf._resolve_nprobe()})
                rows.append(self._row(
                    config="cosine_10kx128", strategy=strategy, **extra,
                    qps=round(n_q / dt, 0),
                    **{"recall@10": round(recall_of(keys, gt, k), 4)}))
            finally:
                ivf.close()
        return rows

    def config2(self) -> List[dict]:
        """l2 and dot graphs on normalised angular rows."""
        from hnsw_tpu_torch import Graph
        from hnsw_tpu_torch.ops.topk import np_exact_topk
        ang, q2, _ = self._angular()
        rows = []
        for metric in ("l2", "dot"):
            _, gt2 = np_exact_topk(q2, ang, self.k, metric)
            g2 = Graph(m=16, metric=metric, seed=0, device=self.device)
            g2.build(list(range(self.n)), ang, wave=1024)
            g2.fast_math = True
            for ef in (20, 64, 128):
                dt, (_, i_out) = self._timed(
                    lambda: g2.batch_search_slots(q2, self.k, ef=ef))
                rows.append(self._row(
                    config=f"{metric}_angular_10kx100", strategy="hnsw",
                    ef=ef, qps=round(self.n_q / dt, 0),
                    **{"recall@10": round(recall_of(i_out, gt2, self.k),
                                          4)}))
        return rows

    def config3(self) -> List[dict]:
        """Batch delete with neighbour repair, then with refinement."""
        from hnsw_tpu_torch import Graph
        from hnsw_tpu_torch.ops.topk import np_exact_topk
        n, k, data, queries = self.n, self.k, self.data, self.queries
        dele = list(range(0, n, 4))
        alive_idx = [i for i in range(n) if i % 4 != 0]
        _, gt3 = np_exact_topk(queries[:64], data[alive_idx], k, "cosine")
        gt3_keys = np.asarray(alive_idx)[gt3]
        rows = []
        for refine in (False, True):
            g3 = Graph(m=16, seed=0, device=self.device)
            g3.build(list(range(n)), data, wave=1024)
            t0 = time.perf_counter()
            g3.batch_delete(dele, refine=refine)
            self._sync()
            name = "refine" if refine else "repair"
            rows.append(self._row(
                config="batch_delete", metric=f"delete_{name}_seconds",
                n_deleted=len(dele),
                value=round(time.perf_counter() - t0, 2)))
            keys, _ = g3.batch_search(queries[:64], k, ef=96)
            rows.append(self._row(
                config="batch_delete",
                metric=f"recall_after_{'refine' if refine else 'delete'}",
                value=round(recall_of(keys, gt3_keys, k), 4)))
        # a second repair in the same process: the steady-state cost
        dele2 = list(range(1, n, 4))
        t0 = time.perf_counter()
        g3.batch_delete(dele2, refine=True)
        self._sync()
        rows.append(self._row(
            config="batch_delete", metric="delete_refine_seconds_warm",
            n_deleted=len(dele2), value=round(time.perf_counter() - t0, 2)))
        return rows

    def _adaptive(self, rows: np.ndarray):
        from hnsw_tpu_torch import AdaptiveHybridIndex, HybridConfig
        a = AdaptiveHybridIndex(
            hybrid_config=HybridConfig(exact_threshold=500),
            device=self.device)
        a.batch_add(list(range(len(rows))), rows)
        return a

    def _latency(self, fn, queries, reps: int = 200) -> List[float]:
        lat = []
        for i in range(reps):
            t0 = time.perf_counter()
            fn(queries[i % len(queries)])
            lat.append(time.perf_counter() - t0)
        return sorted(lat)

    def config4(self) -> List[dict]:
        """The adaptive engine: a batch, single-query latency, the
        reference's adaptive table and recall-aware routing."""
        from hnsw_tpu_torch import HybridConfig, HybridIndex
        from hnsw_tpu_torch.ops.topk import np_exact_topk
        from hnsw_tpu_torch.tools.datasets import synthetic_standin
        n, d, k, n_q = self.n, self.d, self.k, self.n_q
        data, queries, gt = self.data, self.queries, self.gt
        rows = []
        # 4: batched strategy-grouped dispatch
        n4 = min(n, 3000)
        a = self._adaptive(data[:n4])
        try:
            dt, _ = self._timed(lambda: a.batch_search(queries[:256], k))
            stats = a.get_stats()
        finally:
            a.close()
        rows.append(self._row(
            config="adaptive_hybrid", n=n4,
            avg_ms=round(dt / 256 * 1000, 3), qps=round(256 / dt, 0),
            strategies={s: v["count"] for s, v in stats["strategies"].items()
                        if isinstance(v, dict)}))

        # 4a: single-query latency, the native graph beam (batches of one
        # go to the host engine) at the reference's default ef 20 and up
        g = self.graph()
        nl = min(200, n_q)
        for ef_l in (20, 64, 96, 192):
            lat = self._latency(lambda q: g.search(q, k, ef=ef_l),
                                queries[:nl], nl)
            keys_l = [[kk for kk, _ in g.search(queries[i], k, ef=ef_l)]
                      for i in range(64)]
            rows.append(self._row(
                config="single_query_latency", tier="graph_native",
                ef=ef_l, p50_ms=round(lat[len(lat) // 2] * 1000, 3),
                p95_ms=round(lat[int(0.95 * len(lat))] * 1000, 3),
                **{"recall@10": round(recall_of(keys_l, gt[:64], k), 4)}))
        # the adaptive engine at full n: the reference's 2.51 ms anchor
        a10 = self._adaptive(data)
        try:
            for i in range(20):
                a10.search(queries[i], k)      # warm every strategy
            lat = self._latency(lambda q: a10.search(q, k), queries[:nl], nl)
            rows.append(self._row(
                config="single_query_latency", tier="adaptive", n=n,
                p50_ms=round(lat[len(lat) // 2] * 1000, 3),
                p95_ms=round(lat[int(0.95 * len(lat))] * 1000, 3),
                avg_ms=round(sum(lat) / len(lat) * 1000, 3)))

            # 4c: the reference's adaptive table, row for row
            # (hybrid/README.md:649-652, M2 Pro): 1k x 128 random 0.052
            # ms, 10k x 128 random 2.51, 10k x 512 random 1.97, 10k x 128
            # clustered 2.01
            ref_rows = [(1000, 128, "random", 0.052), (n, d, "random", 2.51),
                        (n, 512, "random", 1.97), (n, d, "clustered", 2.01)]
            if self.small:
                ref_rows = [(800, 32, "random", 0.052),
                            (800, 32, "clustered", 2.01)]
            for rn, rd, kind, ref_ms in ref_rows:
                own = kind == "random" and (rn, rd) == (n, d)
                if own:
                    at, base_v, qv = a10, data, queries
                else:
                    base_v, qv = synthetic_standin(rn, rd, 256, seed=11,
                                                   kind=kind)
                    at = self._adaptive(base_v)
                try:
                    for i in range(20):
                        at.search(qv[i % len(qv)], k)
                    lat = self._latency(lambda q: at.search(q, k), qv)
                    keys_a = [[kk for kk, _ in at.search(qv[i], k)]
                              for i in range(64)]
                finally:
                    if not own:
                        at.close()
                _, gta = np_exact_topk(qv[:64], base_v, k, "cosine")
                rows.append(self._row(
                    config="adaptive_reference_table",
                    rows=f"{rn}x{rd}_{kind}",
                    avg_ms=round(sum(lat) / len(lat) * 1000, 3),
                    p95_ms=round(lat[int(0.95 * len(lat))] * 1000, 3),
                    **{"recall@10": round(recall_of(keys_a, gta, k), 4)},
                    reference_avg_ms=ref_ms))
        finally:
            a10.close()

        # 4b: recall-aware routing (the target_recall contract)
        for kind in ("random", "clustered"):
            if kind == "random":
                base, qs = data, queries
            else:
                base, qs = synthetic_standin(n, d, n_q, seed=3,
                                             kind="clustered")
            _, gtt = np_exact_topk(qs, base, k, "cosine")
            h = HybridIndex(HybridConfig(exact_threshold=100,
                                         large_strategy="ivf",
                                         num_partitions=32,
                                         partition_size=max(n // 32, 1)),
                            device=self.device)
            try:
                h.batch_add(list(range(n)), base)
                for target in (0.9, 0.95, 0.99):
                    # 3 warm batches advance the validation back-off
                    # (stride 1 -> 8): the timed batch is the steady state
                    for _ in range(3):
                        h.batch_search(qs, k, target_recall=target)
                    dt, (keys, _) = self._timed(
                        lambda: h.batch_search(qs, k, target_recall=target))
                    rows.append(self._row(
                        config=f"target_recall_{kind}", n=n, target=target,
                        route=h.stats.last_strategy,
                        qps=round(len(qs) / dt, 0),
                        **{"recall@10": round(recall_of(keys, gtt, k), 4)}))
            finally:
                h.close()
        return rows

    def config5(self) -> List[dict]:
        """Faceted (over-fetch and masked exact) and negative-example
        batches of 64."""
        from hnsw_tpu_torch import EqualityFilter, Facet, FacetedGraph
        g, k, q64 = self.graph(), self.k, self.queries[:64]
        fg = FacetedGraph(g)
        for i in range(self.n):
            fg.store.add(i, [Facet("bucket", i % 5)])
        flt = [EqualityFilter("bucket", 3)]
        rows = []
        for metric, fn in (
                ("filtered_batch64_seconds",
                 lambda: fg.batch_search(q64, k, flt)),
                ("exact_filtered_batch64_seconds",
                 lambda: fg.batch_search_exact(q64, k, flt))):
            dt, _ = self._timed(fn)
            rows.append(self._row(config="faceted", metric=metric,
                                  value=round(dt, 3)))
        negs = [self.data[i:i + 1] for i in range(64)]
        dt, _ = self._timed(
            lambda: g.batch_search_with_negatives(q64, negs, k, 0.5))
        rows.append(self._row(config="negative",
                              metric="negative_batch64_seconds",
                              value=round(dt, 3)))
        return rows

    def config6(self) -> List[dict]:
        """Disk-tier operation timings (reference rows: add 5.24 ms,
        search 128 us, delete 2.37 ms, arrow save 11.4 ms / load 2.0 ms,
        appender 410 us a record). parquet and arrow need pyarrow; without
        it the tables are npz and the appender row is left out."""
        from hnsw_tpu_torch import DiskGraph, Graph, StoreConfig
        try:
            import pyarrow as pa
            fmts = ("parquet", "arrow")
        except ImportError:
            pa, fmts = None, ("npz",)
        nd, k, data = min(self.n, 2000), self.k, self.data
        rows = []
        for fmt in fmts:
            td = tempfile.mkdtemp(prefix=f"sweep_{fmt}_")
            try:
                scfg = StoreConfig(directory=td, format=fmt,
                                   wal_flush_interval_seconds=0)
                dg = DiskGraph(td, store_config=scfg, device=self.device)
                t0 = time.perf_counter()
                dg.batch_add(list(range(nd)), data[:nd])
                add_s = time.perf_counter() - t0
                qn = len(self.queries[:256])
                search_s, _ = self._timed(
                    lambda: dg.batch_search(self.queries[:qn], k))
                t0 = time.perf_counter()
                dg.batch_delete(list(range(64)))
                del_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                dg.save()
                save_s = time.perf_counter() - t0
                dg.close()
                t0 = time.perf_counter()
                dg2 = DiskGraph(td, store_config=scfg, device=self.device)
                load_s = time.perf_counter() - t0
                r = dg2.search(data[nd - 1], 1)
                dg2.close()
                if not (r and r[0][0] == nd - 1):
                    raise RuntimeError(f"disk_{fmt}: the reopened graph "
                                       f"lost key {nd - 1}: {r}")
                rows.append(self._row(
                    config=f"disk_{fmt}", format=fmt, n=nd,
                    add_us_per_vec=round(add_s / nd * 1e6, 1),
                    search_us_per_q=round(search_s / qn * 1e6, 1),
                    delete_us_per_key=round(del_s / 64 * 1e6, 1),
                    save_ms=round(save_s * 1e3, 1),
                    load_ms=round(load_s * 1e3, 1)))
            finally:
                shutil.rmtree(td, ignore_errors=True)
        if pa is None:
            print("# appender row left out: ArrowAppender needs pyarrow, "
                  "which is not installed", file=sys.stderr, flush=True)
            return rows
        from hnsw_tpu_torch import ArrowAppender
        app = ArrowAppender(Graph(seed=0, device=self.device))
        batch = pa.record_batch(
            {"key": pa.array(list(range(nd)), pa.int64()),
             "vector": pa.array([data[i].tolist() for i in range(nd)],
                                pa.list_(pa.float32()))})
        t0 = time.perf_counter()
        app.append_record(batch)
        rows.append(self._row(
            config="appender", n=nd,
            ingest_us_per_rec=round((time.perf_counter() - t0) / nd * 1e6,
                                    1)))
        return rows

    def config7(self) -> List[dict]:
        """10k x 512 exact (full size only; reference: adaptive 1.97 ms a
        query at recall .96) and the distance surface's batched cost."""
        from hnsw_tpu_torch.ops.topk import np_exact_topk
        from hnsw_tpu_torch.utils.surface import BasicSurface, VectorDistance
        rows = []
        if not self.small:
            _, _, rng = self._angular()
            d512 = 512
            data512 = rng.standard_normal((self.n, d512)).astype(np.float32)
            q512 = rng.standard_normal((256, d512)).astype(np.float32)
            _, gt512 = np_exact_topk(q512, data512, self.k, "cosine")
            v512 = torch.from_numpy(data512).to(self.device)
            rows.append(self._exact_row(
                "cosine_10kx512", "exact",
                torch.from_numpy(q512).to(self.device), v512,
                (v512 * v512).sum(1),
                torch.ones(self.n, dtype=torch.bool, device=self.device),
                gt512, False))
        vd = VectorDistance(BasicSurface("cosine"))
        data = self.data
        a_host = data[:1024]
        b_host = data[1024:2048] if self.n >= 2048 else data[:1024]
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            vd.batch(a_host, b_host)
        # batch returns the full [A, B] matrix: A*B pairs a call
        per_pair = ((time.perf_counter() - t0)
                    / (reps * len(a_host) * len(b_host)) * 1e9)
        rows.append(self._row(config="surface_overhead",
                              batched_ns_per_pair=round(per_pair, 2)))
        return rows

    def config8(self) -> List[dict]:
        """K1's roofline ladder (``--big``, full size only): exact scans of
        8,192 queries over 1M and 8M Gaussian rows x d made on the card
        (seed 7), each row with ``mfu`` / ``floor_frac`` against this
        run's bare product. f32 and fast_math are timed on the first rung,
        fast_math alone on the others. Every query is held against the
        plain scan (``ops/topk.exact_topk``): recall@10 for each row, and
        for f32 ``ids_equal_plain`` (``plain_agreement``). Where only
        fast_math is timed, the f32 scan runs once untimed for the row's
        ``f32_ids_equal_plain``."""
        from hnsw_tpu_torch.ops.exact_screen import exact_scan
        from hnsw_tpu_torch.ops.topk import exact_topk
        from hnsw_tpu_torch.utils.roofline import (matmul_floor_dt,
                                                   roofline_fields)
        if not self.big or self.small:
            return []
        d, k, nq = self.d, self.k, self.BIG_QUERIES
        gen = torch.Generator(device=self.device).manual_seed(7)
        rows = []
        for nn in self.BIG_ROWS:
            vb = torch.randn((nn, d), generator=gen, device=self.device)
            sqb = (vb * vb).sum(1)
            alb = torch.ones(nn, dtype=torch.bool, device=self.device)
            qbig = torch.randn((nq, d), generator=gen, device=self.device)

            def scan(fast):
                return exact_scan(qbig, vb, sqb, alb, k=k, metric="cosine",
                                  fast_math=fast)
            plain = exact_topk(qbig, vb, sqb, alb, k=k, metric="cosine")
            gt = plain[1].cpu().numpy()
            timed = (False, True) if nn == self.BIG_ROWS[0] else (True,)
            for fast in timed:
                dt, r = self._timed(lambda: scan(fast), reps=3)
                extra = {}
                if not fast:
                    ok, n_diff = plain_agreement(r, plain)
                    extra = {"ids_equal_plain": ok, "ids_differ": n_diff}
                elif False not in timed:
                    ok, n_diff = plain_agreement(scan(False), plain)
                    extra = {"f32_ids_equal_plain": ok,
                             "f32_ids_differ": n_diff}
                rows.append(self._row(
                    config=f"exact_roofline_{nn >> 20}m",
                    strategy="exact_fast" if fast else "exact", n=nn,
                    qps=round(nq / dt, 0),
                    **{"recall@10": round(
                        recall_of(r[1].cpu().numpy(), gt, k), 6)},
                    checked_queries=nq, **extra,
                    **roofline_fields(
                        n_q=nq, n=nn, d=d, dt=dt,
                        floor_dt=matmul_floor_dt(qbig, vb, fast_math=fast),
                        platform=self.platform)))
            del vb, sqb, alb, qbig, plain
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        return rows

    CONFIGS = ("config1", "config2", "config3", "config4", "config5",
               "config6", "config7", "config8")

    def rows(self) -> Iterator[dict]:
        """Every configuration's rows, in order."""
        for name in self.CONFIGS:
            yield from getattr(self, name)()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="reduced sizes (800 x 32, 64 queries)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--big", action="store_true",
                    help="append K1's 1M / 8M roofline ladder (config 8)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("sweep: no CUDA device is available; pass --cpu "
                         "to run on the CPU")
    sweep = Sweep(small=args.small, device="cpu" if args.cpu else None,
                  big=args.big)
    for rec in sweep.rows():
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
