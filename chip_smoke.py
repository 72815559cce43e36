#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (hnsw_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path once at a size users of an ANN library
call real, and fails (non-zero exit, no result line) on any failed check:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles the CUDA kernel (csrc/exact_screen.cu) and the native
   host engine from the sources in the checkout;
3. kernel vs plain: exact_topk_fused through the kernel against the same
   wrapper with the plain torch screen in its place, on the card;
4. exact tier at SIFT1M's shape (1,000,000 x 128 f32, L2, k=10; synthetic
   data from a seed): recall@10 against the numpy oracle and QPS, with
   the kernel's launch count from this phase;
5. graph tier: the default Graph (m=16, ef_construction=100, cosine,
   descent entry, bitonic merge, f32 store) built on 100,000 x 128 by the
   native builder and served on the card at ef 64 and 192;
6. exact capacity ladder at BIGANN-10M's shape (10,000,000 x 128, L2,
   k=10; synthetic rows from a seed): the float32 rung through the kernel,
   checked against a chunked numpy scan, then hbm_dtype int8, bf16 and
   fp16 with recall@10 against the float32 rung, QPS, and
   batch_search_stream against sequential search;
7. hbm_dtype="auto" on 1,000,000 x 128 tight clusters (two widths): the
   rung it resolves to, and the kernel's launches when that is float32;
8. the graph tier's serving modes on the same 100k graph: bench.py's
   configuration (fast_math, block_layout, entry_mode="pivots") at ef 192
   and 384, hbm_mode float16 and quantized at ef 192, and compact upper
   layers at ef 64 (ids equal to the dense layout's).

The last two lines are the kernel table and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one CUDA card and no network; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_EXACT, N_GRAPH, DIM = 1_000_000, 100_000, 128
N_CAPACITY, N_CLUSTER = 10_000_000, 1_000_000
BATCH, N_BATCHES = 1024, 8
#: where the index phases serve; the smoke itself refuses to run off CUDA
DEVICE = "cuda"
KERNEL = {"name": "exact_screen", "route": "cuda",
          "source": "hnsw_tpu_torch/csrc/exact_screen.cu",
          "replaces": "hnsw_tpu/ops/pallas_exact.py:175"}


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise SystemExit(f"check failed: {what}")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs (after one warm-up),
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(f"# device: {name} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | python {sys.version.split()[0]}")
    print(f"# nvidia-smi: {smi}", flush=True)
    return smi


def phase_build() -> None:
    from hnsw_tpu_torch import native
    from hnsw_tpu_torch.ops import exact_screen
    t0 = time.perf_counter()
    exact_screen._load()
    t1 = time.perf_counter()
    check(native.available(), "native host engine builds and loads")
    t2 = time.perf_counter()
    print(f"# build: exact_screen.cu {t1 - t0:.1f} s, native engine "
          f"{t2 - t1:.1f} s", flush=True)


def _overlap(a: np.ndarray, b: np.ndarray) -> float:
    hits = sum(len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
               for x, y in zip(a, b))
    return hits / max(1, sum(int((y >= 0).sum()) for y in b))


def _matched_err(da, ia, db, ib) -> float:
    """Max |dist| difference over ids present in both results."""
    err = 0.0
    for ra, rb, xa, xb in zip(ia, ib, da, db):
        pos = {int(i): j for j, i in enumerate(rb) if i >= 0}
        for j, i in enumerate(ra):
            if i >= 0 and int(i) in pos:
                err = max(err, abs(float(xa[j]) - float(xb[pos[int(i)]])))
    return err


def phase_kernel_vs_plain() -> dict:
    """exact_topk_fused through the kernel against the plain screen in its
    place, both reranked in f32 on the card."""
    from hnsw_tpu_torch.ops.exact_screen import (exact_screen,
                                                 exact_screen_reference,
                                                 exact_topk_fused,
                                                 rerank_pool)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def table(n, n_valid, d=DIM):
        v = torch.randn((n, d), generator=gen, device="cuda")
        valid = torch.zeros(n, dtype=torch.bool, device="cuda")
        valid[:n_valid] = True
        return v, (v * v).sum(-1), valid

    big = table(1_048_576, 1_000_000)
    q_big = torch.randn((1000, DIM), generator=gen, device="cuda")
    cases = [(f"N=1048576 (48576 invalid) Q=1000 {m} fast={f}", q_big, big,
              10, m, f)
             for m in ("cosine", "l2", "sqeuclidean", "dot")
             for f in (False, True)]
    rag = table(40_000, 40_000)
    q_rag = torch.randn((37, DIM), generator=gen, device="cuda")
    few = table(5_000, 6)
    q_few = torch.randn((64, DIM), generator=gen, device="cuda")
    cases += [(f"ragged N=40000 Q=37 cosine fast={f}", q_rag, rag, 10,
               "cosine", f) for f in (False, True)]
    cases += [(f"k=10 > 6 valid rows, l2 fast={f}", q_few, few, 10, "l2", f)
              for f in (False, True)]

    max_err = 0.0
    print("# kernel vs plain (exact_topk_fused; median of 5 reps, ms)")
    for label, q, (v, sq, valid), k, metric, fast in cases:
        def kern():
            return exact_topk_fused(q, v, sq, valid, k=k, metric=metric,
                                    fast_math=fast)

        def plain():
            k_sel = min(k + 8, 128, v.shape[0])
            _, ids = exact_screen_reference(q, v, sq, valid, k_sel=k_sel,
                                            metric=metric, fast_math=fast)
            return rerank_pool(q, v, sq, ids, k=k, metric=metric)

        dk, ik = (t.cpu().numpy() for t in kern())
        dp, ip = (t.cpu().numpy() for t in plain())
        check(np.isfinite(dk).all() and dk.shape == (q.shape[0], k),
              f"{label}: finite [{q.shape[0]}, {k}] result")
        err = _matched_err(dk, ik, dp, ip)
        max_err = max(max_err, err)
        if fast:
            ov = _overlap(ik, ip)
            check(ov >= 0.999 and err <= 1e-5,
                  f"{label}: id overlap {ov:.5f} >= 0.999, matched dists "
                  f"within 1e-5 ({err:.2e})")
        else:
            check(np.array_equal(ik, ip) and err <= 1e-5,
                  f"{label}: ids equal, dists within 1e-5 ({err:.2e})")
        n_valid = int(valid.sum())
        if n_valid < k:
            check(bool((ik[:, n_valid:] == -1).all()),
                  f"{label}: slots past the {n_valid} valid rows are -1")
        t_k, t_p = cuda_ms(kern), cuda_ms(plain)
        print(f"  {label}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms",
              flush=True)

    # the screen alone at the exact tier's shapes (Q padded to 1024)
    q = torch.randn((1024, DIM), generator=gen, device="cuda")
    v, sq, valid = big
    ms = cuda_ms(lambda: exact_screen(q, v, sq, valid, k_sel=18,
                                      metric="l2"))
    plain_ms = cuda_ms(lambda: exact_screen_reference(
        q, v, sq, valid, k_sel=18, metric="l2"))
    print(f"# screen alone, Q=1024 N=1048576 D=128 k_sel=18 l2: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    del big, v, sq, valid
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _recall(found: np.ndarray, truth: np.ndarray, k: int) -> float:
    return sum(len(set(f[:k].tolist()) & set(t[:k].tolist()))
               for f, t in zip(found, truth)) / (k * len(truth))


def _sync_device() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _qps(fn, n_queries: int, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync_device()
        times.append(time.perf_counter() - t0)
    return n_queries / statistics.median(times)


def phase_exact_tier() -> int:
    from hnsw_tpu_torch import ExactIndex
    from hnsw_tpu_torch.ops import exact_screen
    from hnsw_tpu_torch.ops.topk import np_exact_topk
    rng = np.random.default_rng(0)
    base = rng.standard_normal((N_EXACT, DIM), dtype=np.float32)
    queries = rng.standard_normal((10_000, DIM), dtype=np.float32)
    _, gt = np_exact_topk(queries[:100], base, 10, "l2")
    idx = ExactIndex(metric="l2", device="cuda")
    t0 = time.perf_counter()
    idx.batch_add(list(range(N_EXACT)), base)
    idx.batch_search_slots(queries[:1000], 10)   # table upload + warm-up
    print(f"# exact tier: {N_EXACT} x {DIM} l2, add + upload "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(1000 > idx.host_serve_max_batch,
          "batches of 1000 are above the host latency tier")

    def serve():
        return [idx.batch_search_slots(queries[b:b + 1000], 10)
                for b in range(0, len(queries), 1000)]

    launches = 0
    for fast in (False, True):
        idx.fast_math = fast
        exact_screen.launches = 0
        out = serve()
        launches += exact_screen.launches
        check(exact_screen.launches == 10,
              f"fast_math={fast}: 10 batches launched the kernel "
              f"{exact_screen.launches} times")
        d0, i0 = out[0]
        check(np.isfinite(d0).all() and i0.shape == (1000, 10),
              f"fast_math={fast}: finite [1000, 10] results")
        rec = _recall(i0[:100], gt, 10)
        floor = 0.999 if fast else 1.0
        check(rec >= floor, f"fast_math={fast}: recall@10 {rec:.4f} >= "
              f"{floor} against the numpy oracle (100 queries)")
        qps = _qps(serve, len(queries))
        print(f"  exact tier fast_math={fast}: {qps:.1f} QPS (10,000 "
              f"queries in batches of 1000, median of 3)", flush=True)
    del idx
    torch.cuda.empty_cache()
    return launches


def phase_graph_tier() -> dict:
    from hnsw_tpu_torch import ExactIndex, Graph, native
    from hnsw_tpu_torch.convert import graph_from_host_arrays
    rng = np.random.default_rng(1)
    base = rng.standard_normal((N_GRAPH, DIM), dtype=np.float32)
    queries = rng.standard_normal((1024, DIM), dtype=np.float32)
    check(native.available(), "native builder available")
    g = Graph(m=16, ef_construction=100, metric="cosine", seed=0,
              device=DEVICE)
    t0 = time.perf_counter()
    g.build(list(range(N_GRAPH)), base, method="host")
    print(f"# graph tier: native build of {N_GRAPH} x {DIM} cosine "
          f"{time.perf_counter() - t0:.1f} s, {g.num_layers} layers",
          flush=True)
    g.native_serve_max_batch = 0

    oracle = ExactIndex(metric="cosine", device=DEVICE)
    oracle.host_serve_max_batch = 0
    oracle.batch_add(list(range(N_GRAPH)), base)
    _, gt = oracle.batch_search_slots(queries, 10)

    cpu = graph_from_host_arrays(
        g.cfg, g.slots.slot_to_key, g.store.vectors[:g.slots.capacity_used],
        g.store.alive[:g.slots.capacity_used], *g.host.arrays(),
        device="cpu")
    cpu.native_serve_max_batch = 0
    for ef in (64, 192):
        _, ids = g.batch_search_slots(queries, 10, ef=ef)
        hops = list(g.last_search_hops)
        check(ids.shape == (1024, 10) and (ids >= 0).all(),
              f"ef={ef}: [1024, 10] results, no misses")
        _, ids_cpu = cpu.batch_search_slots(queries[:128], 10, ef=ef)
        ov = _overlap(ids[:128], ids_cpu)
        check(ov >= 0.99, f"ef={ef}: card vs CPU id overlap {ov:.4f} >= "
              f"0.99 (128 queries)")
        _, self_ids = g.batch_search_slots(base[:1024], 1, ef=ef)
        hit = float(np.mean(self_ids[:, 0] == np.arange(1024)))
        check(hit >= 0.99, f"ef={ef}: self-retrieval {hit:.4f} >= 0.99")
        qps = _qps(lambda: g.batch_search_slots(queries, 10, ef=ef), 1024)
        print(f"  graph tier ef={ef}: {qps:.1f} QPS (1024-query batch, "
              f"median of 3), recall@10 {_recall(ids, gt, 10):.4f} vs the "
              f"exact tier, hops per layer (top..0) {hops}", flush=True)
        if ef == 64:
            dense_ids = ids
    del oracle
    torch.cuda.empty_cache()
    return {"g": g, "cpu": cpu, "base": base, "queries": queries, "gt": gt,
            "dense_ids_ef64": dense_ids}


def _np_scan_topk(queries, rows, sq, k: int, metric: str,
                  chunk: int = 1 << 20):
    """Exact top-k by a chunked numpy scan: (dists [Q, k], ids [Q, k])."""
    from hnsw_tpu_torch.ops.distance import np_gram_epilogue
    q = np.asarray(queries, np.float32)
    q_sq = np.sum(q * q, axis=1)
    best_d = np.empty((len(q), 0), np.float32)
    best_i = np.empty((len(q), 0), np.int64)
    for c0 in range(0, len(rows), chunk):
        d = np_gram_epilogue(q @ rows[c0:c0 + chunk].T, q_sq[:, None],
                             sq[None, c0:c0 + chunk], metric)
        part = np.argpartition(d, k - 1, axis=1)[:, :k]
        best_d = np.concatenate([best_d, np.take_along_axis(d, part, 1)], 1)
        best_i = np.concatenate([best_i, part + c0], 1)
    order = np.argsort(best_d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(best_d, order, 1),
            np.take_along_axis(best_i, order, 1))


def _recall_ties(found_d: np.ndarray, truth_d: np.ndarray,
                 tol: float = 1e-5) -> float:
    """recall@k that counts a returned neighbor as right when its exact
    distance is within ``tol`` of the true k-th distance: on clustered
    data f32 sums in another order can swap near ties at rank k."""
    k = truth_d.shape[1]
    return float(np.mean(found_d[:, :k] <= truth_d[:, -1:] + tol))


def _fill(idx, n: int, make_rows, chunk: int = 1 << 20) -> None:
    """Add rows 0..n-1 (keys = row numbers) in chunks from
    make_rows(count), into a host store sized to n up front."""
    from hnsw_tpu_torch.utils.keystore import HostVectorStore
    idx.store = HostVectorStore(DIM, capacity=n)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        idx.batch_add(range(c0, c1), make_rows(c1 - c0))


def _check_table(idx, rung: str, n: int) -> None:
    from hnsw_tpu_torch.core.state import bucket_pow2
    want = {"float32": torch.float32, "bf16": torch.bfloat16,
            "fp16": torch.float16, "int8": torch.int8}[rung]
    v, sq, alive, scales = idx._dev
    check(idx._resolved_hbm == rung and v.device.type == DEVICE
          and v.dtype == want and tuple(v.shape) == (bucket_pow2(n), DIM)
          and (scales is not None) == (rung == "int8"),
          f"{rung}: the table sits on {DEVICE} as {want} "
          f"[{v.shape[0]}, {DIM}], {v.numel() * v.element_size() / 1e9:.2f} "
          f"GB")


def phase_capacity_ladder() -> int:
    """BIGANN-10M's shape through the hbm_dtype ladder; returns the
    kernel's launches (the float32 rung)."""
    from hnsw_tpu_torch import ExactIndex
    from hnsw_tpu_torch.ops import exact_screen
    rng = np.random.default_rng(2)
    idx = ExactIndex(metric="l2", device=DEVICE)
    t0 = time.perf_counter()
    _fill(idx, N_CAPACITY,
          lambda m: rng.standard_normal((m, DIM), dtype=np.float32))
    batches = [rng.standard_normal((BATCH, DIM), dtype=np.float32)
               for _ in range(N_BATCHES)]
    n_q = BATCH * N_BATCHES
    print(f"# capacity ladder: {N_CAPACITY} x {DIM} l2, k=10, "
          f"{N_BATCHES} batches of {BATCH}; add {time.perf_counter() - t0:.1f}"
          f" s, host f32 store {idx.store.vectors.nbytes / 1e9:.2f} GB",
          flush=True)

    def serve():
        return [idx.batch_search_slots(b, 10) for b in batches]

    def timed(fn):
        _sync_device()
        t = time.perf_counter()
        out = fn()
        _sync_device()
        return out, time.perf_counter() - t

    exact_screen.launches = 0
    t0 = time.perf_counter()
    idx._sync()
    t_sync = time.perf_counter() - t0
    _check_table(idx, "float32", N_CAPACITY)
    truth, wall = timed(serve)
    truth = np.concatenate([i for _, i in truth])
    launches = exact_screen.launches
    check(launches == N_BATCHES, f"float32: {N_BATCHES} batches launched "
          f"the kernel {launches} times")
    d_np, i_np = _np_scan_topk(batches[0][:20],
                               idx.store.vectors[:N_CAPACITY],
                               idx.store.sq_norms[:N_CAPACITY], 10, "l2")
    d_k, i_k = idx.batch_search_slots(batches[0], 10)
    rec = _recall_ties(d_k[:20], d_np, 1e-4)
    err = _matched_err(d_k[:20], i_k[:20], d_np, i_np)
    check(rec == 1.0 and err <= 1e-4, f"float32 (kernel): recall@10 "
          f"{rec:.4f} == 1 against a chunked numpy scan of 20 queries "
          f"(ties within 1e-4), matched dists within 1e-4 ({err:.2e})")
    print(f"  capacity float32 (kernel): {n_q / wall:.1f} QPS ({n_q} "
          f"queries, one pass), upload {t_sync:.1f} s", flush=True)
    launches = exact_screen.launches

    for rung in ("int8", "bf16", "fp16"):
        idx.hbm_dtype = rung
        t0 = time.perf_counter()
        idx._sync()
        t_sync = time.perf_counter() - t0
        _check_table(idx, rung, N_CAPACITY)
        idx.batch_search_slots(batches[0], 10)             # warm-up
        exact_screen.launches = 0
        seq, t_seq = timed(serve)
        streamed, t_stream = timed(
            lambda: list(idx.batch_search_stream(iter(batches), 10)))
        check(exact_screen.launches == 0,
              f"{rung}: the capacity scan runs without the float32 kernel")
        found = np.concatenate([i for _, i in seq])
        check(found.shape == (n_q, 10) and np.isfinite(
            np.concatenate([d for d, _ in seq])).all(),
            f"{rung}: finite [{n_q}, 10] results")
        rec = _recall(found, truth, 10)
        check(rec >= 0.99, f"{rung}: recall@10 {rec:.4f} >= 0.99 against "
              f"the float32 rung ({n_q} queries)")
        same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(seq, streamed))
        check(same and len(streamed) == N_BATCHES,
              f"{rung}: batch_search_stream equals batch_search_slots over "
              f"{N_BATCHES} batches")
        print(f"  capacity {rung}: {n_q / t_seq:.1f} QPS, recall@10 "
              f"{rec:.4f} vs float32; {N_BATCHES} batches sequential "
              f"{t_seq:.3f} s, stream {t_stream:.3f} s; upload "
              f"{t_sync:.1f} s", flush=True)
    idx.close()
    del idx
    torch.cuda.empty_cache()
    return launches


def phase_auto_ladder() -> int:
    """hbm_dtype="auto" on tight clusters (tests/test_fast_serving.py's
    recipe, then five times tighter); returns the kernel's launches."""
    from hnsw_tpu_torch import ExactIndex
    from hnsw_tpu_torch.ops import exact_screen
    launches = 0
    for noise, want in ((0.3, None), (0.05, "float32")):
        rng = np.random.default_rng(3)
        centers = rng.standard_normal((40, DIM)).astype(np.float32) * 5

        def rows(m):
            return (centers[rng.integers(0, 40, m)] + noise * rng
                    .standard_normal((m, DIM)).astype(np.float32))

        idx = ExactIndex(hbm_dtype="auto", device=DEVICE)       # cosine
        _fill(idx, N_CLUSTER, rows)
        q = rows(BATCH)
        exact_screen.launches = 0
        t0 = time.perf_counter()
        d, i = idx.batch_search_slots(q, 10)
        _sync_device()
        t_first = time.perf_counter() - t0
        rung = idx._resolved_hbm
        n_k = exact_screen.launches
        qps = _qps(lambda: idx.batch_search_slots(q, 10), BATCH)
        _check_table(idx, rung, N_CLUSTER)
        d_np, _ = _np_scan_topk(q[:100], idx.store.vectors[:N_CLUSTER],
                                idx.store.sq_norms[:N_CLUSTER], 10,
                                "cosine")
        rec = _recall_ties(d[:100], d_np)
        # a reduced rung is admitted at a containment >= 0.99 measured on
        # 32 probes; it serves 100 other queries at 0.98 or better
        floor = 1.0 if rung == "float32" else 0.98
        check(rec >= floor and np.isfinite(d).all(),
              f"auto, clusters of width {noise} ({rung}): recall@10 "
              f"{rec:.4f} >= {floor} against a numpy scan of 100 queries "
              f"(ties within 1e-5)")
        if want is not None:
            check(rung == want, f"auto, clusters of width {noise}: "
                  f"resolves to {rung} (expected {want})")
        if rung == "float32":
            check(n_k == 1, f"auto -> float32: one batch launched the "
                  f"kernel {n_k} times")
        else:
            check(n_k == 0, f"auto -> {rung}: the kernel was not launched")
        launches += exact_screen.launches
        print(f"  auto, {N_CLUSTER} x {DIM} cosine in 40 clusters of width "
              f"{noise}: resolves to {rung}; {qps:.1f} QPS (1024-query "
              f"batch, median of 3); first batch with the fit checks and "
              f"upload {t_first:.1f} s", flush=True)
        idx.close()
        del idx
        torch.cuda.empty_cache()
    return launches


def phase_graph_modes(st: dict) -> None:
    """bench.py's serving configuration and the capacity modes on the
    100k graph of phase_graph_tier (no second build)."""
    g, cpu, base, queries, gt = (st[k] for k in
                                 ("g", "cpu", "base", "queries", "gt"))

    def serve(label, ef, setup):
        for x in (g, cpu):
            setup(x)
        _, ids = g.batch_search_slots(queries, 10, ef=ef)
        hops = list(g.last_search_hops)
        check(ids.shape == (1024, 10) and (ids >= 0).all(),
              f"{label} ef={ef}: [1024, 10] results, no misses")
        _, ids_cpu = cpu.batch_search_slots(queries[:128], 10, ef=ef)
        ov = _overlap(ids[:128], ids_cpu)
        check(ov >= 0.99, f"{label} ef={ef}: card vs CPU id overlap "
              f"{ov:.4f} >= 0.99 (128 queries)")
        _, self_ids = g.batch_search_slots(base[:1024], 1, ef=ef)
        hit = float(np.mean(self_ids[:, 0] == np.arange(1024)))
        check(hit >= 0.99, f"{label} ef={ef}: self-retrieval {hit:.4f} "
              f">= 0.99")
        qps = _qps(lambda: g.batch_search_slots(queries, 10, ef=ef), 1024)
        print(f"  {label} ef={ef}: {qps:.1f} QPS (1024-query batch, median "
              f"of 3), recall@10 {_recall(ids, gt, 10):.4f} vs the exact "
              f"tier, hops per layer (top..0) {hops}", flush=True)
        return ids

    def bench_config(x):
        x.fast_math = True
        x.block_layout = True
        x.entry_mode = "pivots"

    print("# graph tier serving modes (the 100k graph above)", flush=True)
    for ef in (192, 384):
        serve("fast_math + block_layout + pivots", ef, bench_config)
    dev = g.device_graph()
    blocks = dev.nbr_blocks
    check(blocks is not None and blocks.device.type == DEVICE,
          f"neighbor blocks on {DEVICE}")
    print(f"  block_dtype resolves to {g._resolve_block_dtype(N_GRAPH)}; "
          f"nbr_blocks {list(blocks.shape)} {blocks.dtype}, "
          f"{blocks.numel() * blocks.element_size() / 1e9:.3f} GB",
          flush=True)
    for mode in ("float16", "quantized"):
        def capacity(x, mode=mode):
            x.block_layout = False
            x.hbm_mode = mode
        serve(f"hbm_mode={mode} + fast_math + pivots", 192, capacity)
        dev = g.device_graph()
        if mode == "float16":
            check(dev.vectors.dtype == torch.float16 and dev.qvec is None,
                  "hbm_mode=float16: an fp16 store on the card")
        else:
            check(tuple(dev.vectors.shape) == (1, DIM)
                  and dev.qvec.dtype == torch.int8
                  and dev.qvec.device.type == DEVICE,
                  "hbm_mode=quantized: only the int8 store on the card")

    def compact(x):
        x.hbm_mode = "full"
        x.fast_math = False
        x.entry_mode = "descent"
        x.split_layers = "compact"
        x._dirty = True

    ids = serve("split_layers=compact", 64, compact)
    check(isinstance(g.device_graph().nbr_upper, tuple),
          "compact upper layers on the card")
    check(np.array_equal(ids, st["dense_ids_ef64"]),
          "compact uppers: ids equal the dense layout's at ef=64")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    timing = phase_kernel_vs_plain()
    launches = phase_exact_tier()
    graph = phase_graph_tier()
    launches += phase_capacity_ladder()
    launches += phase_auto_ladder()
    phase_graph_modes(graph)
    print(smi)
    print(json.dumps({"kernels": [dict(KERNEL, launches=launches,
                                       **timing)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
