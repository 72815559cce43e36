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
   native builder and served on the card at ef 64 and 192.

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


def _qps(fn, n_queries: int, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
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


def phase_graph_tier() -> None:
    from hnsw_tpu_torch import ExactIndex, Graph, native
    from hnsw_tpu_torch.convert import graph_from_host_arrays
    rng = np.random.default_rng(1)
    base = rng.standard_normal((N_GRAPH, DIM), dtype=np.float32)
    queries = rng.standard_normal((1024, DIM), dtype=np.float32)
    check(native.available(), "native builder available")
    g = Graph(m=16, ef_construction=100, metric="cosine", seed=0,
              device="cuda")
    t0 = time.perf_counter()
    g.build(list(range(N_GRAPH)), base, method="host")
    print(f"# graph tier: native build of {N_GRAPH} x {DIM} cosine "
          f"{time.perf_counter() - t0:.1f} s, {g.num_layers} layers",
          flush=True)
    g.native_serve_max_batch = 0

    oracle = ExactIndex(metric="cosine", device="cuda")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    timing = phase_kernel_vs_plain()
    launches = phase_exact_tier()
    phase_graph_tier()
    print(smi)
    print(json.dumps({"kernels": [dict(KERNEL, launches=launches,
                                       **timing)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
