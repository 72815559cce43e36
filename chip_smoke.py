#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (hnsw_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path once at a size users of an ANN library
call real, and fails (non-zero exit, no result line) on any failed check:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles the CUDA kernels (csrc/exact_screen.cu: K1's TF32
   wgmma route and its FMA route) and the native host engine from the
   sources in the checkout;
3. kernel vs plain: exact_topk_fused through each K1 route against the
   same wrapper with the plain torch screen in its place, on the card;
   then the screen alone timed per route and mode at the exact tier's
   shape (Q=1024, N=1,048,576, D=128, k_sel=18, l2) and, for the FMA
   route, at glove-50's, each beside its bound, with the plain version
   and torch.topk(torch.cdist) as a yardstick the port never calls;
4. exact tier at SIFT1M's shape (1,000,000 x 128 f32, L2, k=10; synthetic
   data from a seed): recall@10 against the numpy oracle and QPS, with
   K1's launches by route from this phase; then the exact tier at
   glove-50-angular's shape (1,183,514 x 50, cosine), which D % 4 != 0
   sends down the FMA route;
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
   layers at ef 64 (ids equal to the dense layout's);
9. the device wave builder on the same 100k vectors (wave 2048): a
   build checked against the native build's recall and served on the
   card and the CPU, the int8-block fp16 descent, batch_delete of every
   10th key with refine=True, and a build aborted at its deadline,
   served as its inserted prefix and finished by Graph.resume_build;
   the recall oracle is the exact tier (the kernel) on the card;
10. a device build at SIFT1M's shape (1,048,576 x 128, L2, synthetic rows
   from a seed) through Graph.build's "auto" routing: build time, peak
   memory, levels, recall@10 against the exact tier at ef 64 and 192,
   and a profile of one mid-build wave split into descent, row assembly
   (diversity selection) and reverse update.

The last two lines are the kernel table (one entry a K1 route, with its
launches on the main path) and
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
#: ANN-benchmarks' glove-50-angular: the width that takes K1's FMA route
N_GLOVE, D_GLOVE = 1_183_514, 50
N_CAPACITY, N_CLUSTER = 10_000_000, 1_000_000
BATCH, N_BATCHES = 1024, 8
#: phase 10: past the 1,000,000 rows up to which "auto" routes to the
#: native builder (hnsw_tpu_torch/index/hnsw.py _route)
N_SIFT, WAVE = 1_048_576, 2048
#: the mid-build wave phase 10 profiles
PROFILE_WAVE = 256
#: where the index phases serve; the smoke itself refuses to run off CUDA
DEVICE = "cuda"
KERNEL = {"route": "cuda",
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


def _reset_launches() -> None:
    from hnsw_tpu_torch.ops import exact_screen
    exact_screen.launches = 0
    exact_screen.launches_by_route.update(wgmma=0, fma=0)


def _launches() -> dict:
    """K1's launches by route since the last _reset_launches()."""
    from hnsw_tpu_torch.ops import exact_screen
    return dict(exact_screen.launches_by_route)


def _add(a: dict, b: dict) -> dict:
    return {r: a.get(r, 0) + b.get(r, 0) for r in set(a) | set(b)}


#: the fastest way the card has to do the screen's product, by mode
#: (whatever instruction a route uses): (passes, TFLOP/s, name). An
#: f32-accurate product takes at least 3 TF32 passes (3xTF32); fast_math's
#: bf16 operands one pass at the bf16 dense rate. H100 SXM peaks.
PRODUCT_BOUND = {False: (3, 495.0, "3xTF32"), True: (1, 989.0, "bf16")}


def _screen_bound_ms(nq: int, n: int, d: int, k_sel: int,
                     fast: bool) -> tuple:
    """(ms, "bytes" | "operations"): the least time of one screen on an
    H100 SXM: each input read once and the keys written once at 3.35
    TB/s, against 2 Q N D flops per product pass (PRODUCT_BOUND)."""
    passes, tflops, _ = PRODUCT_BOUND[fast]
    moved = 4 * (nq * d + n * d + n) + n + 8 * nq * k_sel
    t_bytes = moved / 3.35e12 * 1e3
    t_ops = passes * 2.0 * nq * n * d / (tflops * 1e12) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _time_screen(label, q, v, sq, valid, k_sel, metric, routes) -> dict:
    """The screen alone at one shape: each (route, fast_math) kernel
    through the private launcher, the plain version and the library
    yardstick (torch.cdist + torch.topk, l2 only; the port never calls
    it). Each time is printed beside its bound and share of the bound.
    Returns {"<route>[_fast]": (ms, bound_ms, bound_by, max_abs_err)}
    plus "plain" and "library" ms."""
    from hnsw_tpu_torch.ops import exact_screen as es
    nq, d = q.shape
    n = v.shape[0]
    plain_d, plain_i = es.exact_screen_reference(q, v, sq, valid,
                                                 k_sel=k_sel, metric=metric)
    plain_ms = cuda_ms(lambda: es.exact_screen_reference(
        q, v, sq, valid, k_sel=k_sel, metric=metric))
    lib_ms = None
    if metric == "l2":
        lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(q, v), k_sel,
                                            largest=False))
    out = {"plain": plain_ms, "library": lib_ms}
    print(f"# screen alone, {label}: Q={nq} N={n} D={d} k_sel={k_sel} "
          f"{metric} (median of 5 CUDA-event reps)", flush=True)
    for route, fast in routes:
        def run():
            return es._screen_cuda(q, v, sq, valid, k_sel, metric, fast,
                                   route)
        kd, ki = run()
        err = 0.0
        if not fast:
            same = ki == plain_i
            share = same.float().mean().item()
            err = (kd[same] - plain_d[same]).abs().max().item()
            check(share >= 0.99 and err <= 1e-4,
                  f"{route} f32 screen: {share:.5f} of the keys equal the "
                  f"plain version's (>= 0.99), matched dists within 1e-4 "
                  f"({err:.2e})")
        ms = cuda_ms(run)
        bound, by = _screen_bound_ms(nq, n, d, k_sel, fast)
        passes, peak, how = PRODUCT_BOUND[fast]
        key = route + ("_fast" if fast else "")
        out[key] = (ms, bound, by, err)
        print(f"  {route} fast_math={fast}: {ms:.3f} ms, bound {bound:.3f} "
              f"ms ({by}: {how}, {passes} pass(es) at {peak:g} TFLOP/s), "
              f"{bound / ms:.3f} of the bound", flush=True)
    lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "n/a"
    print(f"  plain (exact_screen_reference) {plain_ms:.3f} ms; library "
          f"yardstick torch.topk(torch.cdist) {lib}", flush=True)
    return out


def phase_kernel_vs_plain() -> dict:
    """exact_topk_fused through each K1 route against the plain screen in
    its place, both reranked in f32 on the card; then the screen alone
    timed per route."""
    from hnsw_tpu_torch.ops.exact_screen import (exact_screen_reference,
                                                 exact_topk_fused,
                                                 rerank_pool, screen_route)
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
    glove = table(N_GLOVE, N_GLOVE, D_GLOVE)
    q_glove = torch.randn((1000, D_GLOVE), generator=gen, device="cuda")
    cases += [(f"GloVe-50 shape N={N_GLOVE} D={D_GLOVE} Q=1000 cosine "
               f"fast={f}", q_glove, glove, 10, "cosine", f)
              for f in (False, True)]

    max_err = {"wgmma": 0.0, "fma": 0.0}
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

        route = screen_route(q, v)
        check(route == ("wgmma" if q.shape[1] % 4 == 0 else "fma"),
              f"{label}: D={q.shape[1]} takes the {route} route")
        _reset_launches()
        dk, ik = (t.cpu().numpy() for t in kern())
        check(_launches()[route] == 1,
              f"{label}: one launch of the {route} kernel")
        dp, ip = (t.cpu().numpy() for t in plain())
        check(np.isfinite(dk).all() and dk.shape == (q.shape[0], k),
              f"{label}: finite [{q.shape[0]}, {k}] result")
        err = _matched_err(dk, ik, dp, ip)
        max_err[route] = max(max_err[route], err)
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
        print(f"  {label}: kernel ({route}) {t_k:.3f} ms, plain {t_p:.3f} "
              f"ms", flush=True)

    # the screen alone at the exact tier's shapes (Q padded to 1024): the
    # wgmma kernel, and the FMA kernel at the same shape as the "before"
    q = torch.randn((1024, DIM), generator=gen, device="cuda")
    v, sq, valid = big
    sift = _time_screen("SIFT1M shape", q, v, sq, valid, 18, "l2",
                        [("wgmma", False), ("wgmma", True), ("fma", False),
                         ("fma", True)])
    del big, v, sq, valid
    torch.cuda.empty_cache()
    # the FMA kernel where the main path sends it: GloVe-50's D = 50
    v, sq, valid = glove
    q = torch.randn((1024, D_GLOVE), generator=gen, device="cuda")
    glv = _time_screen("GloVe-50 shape", q, v, sq, valid, 18, "l2",
                       [("fma", False), ("fma", True)])
    del glove, v, sq, valid
    torch.cuda.empty_cache()

    def entry(name, t, key, err):
        ms, bound, by, screen_err = t[key]
        return dict(KERNEL, name=name, screen_route=key,
                    max_abs_err=max(err, screen_err), ms=ms,
                    plain_ms=t["plain"], bound_ms=bound, bound_by=by,
                    library_ms=t["library"])
    # "exact_screen" continues the series of earlier runs (the f32 screen
    # at the SIFT1M shape), now on the wgmma route
    return {"wgmma": dict(entry("exact_screen", sift, "wgmma",
                                max_err["wgmma"]),
                          fast_math_ms=sift["wgmma_fast"][0],
                          fma_same_shape_ms=sift["fma"][0]),
            "fma": entry("exact_screen_fma", glv, "fma", max_err["fma"])}


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


def _profile(label: str, fn) -> None:
    """One call of ``fn`` (after a warm-up) under torch.profiler: its wall
    time, the device time of its kernels, the three largest by name, and
    the device's idle share of the wall; nothing but a note when the
    trace lost K1's event."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}   # every device activity, K1's ctypes launches included
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    k1 = [us for n, us in by_name.items() if "screen_wgmma_kernel" in n]
    if not k1:
        print(f"  profile, {label}: the trace holds no screen_wgmma_kernel "
              f"event; device split not measured", flush=True)
        return
    dev_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    print(f"  profile, {label}: wall {wall_us / 1e3:.3f} ms, device "
          f"{dev_us / 1e3:.3f} ms, idle share "
          f"{max(0.0, 1 - dev_us / wall_us):.3f}; "
          + "; ".join(f"{n[:60]} {us / 1e3:.3f} ms" for n, us in top),
          flush=True)


def phase_exact_tier() -> dict:
    """Returns K1's launches by route."""
    from hnsw_tpu_torch import ExactIndex
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

    launches = {}
    for fast in (False, True):
        idx.fast_math = fast
        _reset_launches()
        out = serve()
        by = _launches()
        launches = _add(launches, by)
        check(by == {"wgmma": 10, "fma": 0},
              f"fast_math={fast}: 10 batches launched the wgmma kernel "
              f"{by['wgmma']} times, the FMA kernel {by['fma']} times")
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
        _profile(f"one batch of 1000, fast_math={fast}",
                 lambda: idx.batch_search_slots(queries[:1000], 10))
    del idx
    torch.cuda.empty_cache()
    return launches


def phase_exact_tier_glove50() -> dict:
    """The exact tier at ANN-benchmarks' glove-50-angular shape
    (1,183,514 x 50, cosine, k=10; synthetic rows from a seed): D % 4 != 0
    sends K1 down its FMA route. Returns K1's launches by route."""
    from hnsw_tpu_torch import ExactIndex
    from hnsw_tpu_torch.ops.topk import np_exact_topk
    rng = np.random.default_rng(5)
    base = rng.standard_normal((N_GLOVE, D_GLOVE), dtype=np.float32)
    queries = rng.standard_normal((10_000, D_GLOVE), dtype=np.float32)
    gt = np.concatenate([np_exact_topk(queries[b:b + 100], base, 10,
                                       "cosine")[1]
                         for b in range(0, 1000, 100)])
    idx = ExactIndex(metric="cosine", device=DEVICE)
    idx.batch_add(list(range(N_GLOVE)), base)
    idx.batch_search_slots(queries[:1000], 10)   # table upload + warm-up

    def serve():
        return [idx.batch_search_slots(queries[b:b + 1000], 10)
                for b in range(0, len(queries), 1000)]

    _reset_launches()
    out = serve()
    by = _launches()
    check(by == {"wgmma": 0, "fma": 10}, f"glove-50 shape: 10 batches "
          f"launched the FMA kernel {by['fma']} times, the wgmma kernel "
          f"{by['wgmma']} times")
    d0, i0 = out[0]
    rec = _recall(i0, gt, 10)
    check(np.isfinite(d0).all() and i0.shape == (1000, 10) and rec == 1.0,
          f"glove-50 shape: finite [1000, 10] results, recall@10 "
          f"{rec:.4f} == 1 against the numpy oracle (1000 queries)")
    qps = _qps(serve, len(queries))
    print(f"  exact tier at glove-50's shape ({N_GLOVE} x {D_GLOVE} cosine, "
          f"FMA route): {qps:.1f} QPS (10,000 queries in batches of 1000, "
          f"median of 3)", flush=True)
    del idx
    torch.cuda.empty_cache()
    return by


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
    recall = {}
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
        recall[ef] = _recall(ids, gt, 10)
        print(f"  graph tier ef={ef}: {qps:.1f} QPS (1024-query batch, "
              f"median of 3), recall@10 {recall[ef]:.4f} vs the "
              f"exact tier, hops per layer (top..0) {hops}", flush=True)
        if ef == 64:
            dense_ids = ids
    del oracle
    torch.cuda.empty_cache()
    return {"g": g, "cpu": cpu, "base": base, "queries": queries, "gt": gt,
            "dense_ids_ef64": dense_ids, "recall": recall}


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


def phase_capacity_ladder() -> dict:
    """BIGANN-10M's shape through the hbm_dtype ladder; returns K1's
    launches by route (the float32 rung)."""
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

    _reset_launches()
    t0 = time.perf_counter()
    idx._sync()
    t_sync = time.perf_counter() - t0
    _check_table(idx, "float32", N_CAPACITY)
    truth, wall = timed(serve)
    truth = np.concatenate([i for _, i in truth])
    launches = _launches()
    check(launches == {"wgmma": N_BATCHES, "fma": 0},
          f"float32: {N_BATCHES} batches launched the wgmma kernel "
          f"{launches['wgmma']} times, the FMA kernel {launches['fma']}")
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

    for rung in ("int8", "bf16", "fp16"):
        idx.hbm_dtype = rung
        t0 = time.perf_counter()
        idx._sync()
        t_sync = time.perf_counter() - t0
        _check_table(idx, rung, N_CAPACITY)
        idx.batch_search_slots(batches[0], 10)             # warm-up
        _reset_launches()
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


def phase_auto_ladder() -> dict:
    """hbm_dtype="auto" on tight clusters (tests/test_fast_serving.py's
    recipe, then five times tighter); returns K1's launches by route."""
    from hnsw_tpu_torch import ExactIndex
    launches = {}
    for noise, want in ((0.3, None), (0.05, "float32")):
        rng = np.random.default_rng(3)
        centers = rng.standard_normal((40, DIM)).astype(np.float32) * 5

        def rows(m):
            return (centers[rng.integers(0, 40, m)] + noise * rng
                    .standard_normal((m, DIM)).astype(np.float32))

        idx = ExactIndex(hbm_dtype="auto", device=DEVICE)       # cosine
        _fill(idx, N_CLUSTER, rows)
        q = rows(BATCH)
        _reset_launches()
        t0 = time.perf_counter()
        d, i = idx.batch_search_slots(q, 10)
        _sync_device()
        t_first = time.perf_counter() - t0
        rung = idx._resolved_hbm
        n_k = _launches()
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
            check(n_k == {"wgmma": 1, "fma": 0}, f"auto -> float32: one "
                  f"batch launched the wgmma kernel {n_k['wgmma']} times, "
                  f"the FMA kernel {n_k['fma']}")
        else:
            check(n_k == {"wgmma": 0, "fma": 0},
                  f"auto -> {rung}: the kernel was not launched")
        launches = _add(launches, _launches())
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


class _NativeInserts:
    """Counts calls of the native sequential builder while installed."""

    def __enter__(self):
        from hnsw_tpu_torch import native
        self.native, self.orig, self.calls = native, native.insert_batch, 0

        def counted(*a, **kw):
            self.calls += 1
            return self.orig(*a, **kw)
        native.insert_batch = counted
        return self

    def __exit__(self, *exc):
        self.native.insert_batch = self.orig


def _device_build(keys, vecs, metric, **kw):
    """A Graph (m=16, ef_construction=100, seed 0) on the card, built by
    the wave builder; returns (graph, seconds)."""
    from hnsw_tpu_torch import Graph
    g = Graph(m=16, ef_construction=100, metric=metric, seed=0,
              device=DEVICE)
    g.native_serve_max_batch = 0
    t0 = time.perf_counter()
    g.build(keys, vecs, wave=WAVE, **kw)
    _sync_device()
    return g, time.perf_counter() - t0


def _all_inserted(g, n: int) -> bool:
    return g.host.count == n and bool((g.host.levels[:n] >= 0).all())


def _graph_recalls(g, queries, gt, label: str) -> dict:
    """recall@10 at ef 64 and 192 with finite, miss-free results."""
    out = {}
    for ef in (64, 192):
        d, ids = g.batch_search_slots(queries, 10, ef=ef)
        check(ids.shape == (len(queries), 10) and (ids >= 0).all()
              and np.isfinite(d).all(),
              f"{label} ef={ef}: finite [{len(queries)}, 10] results, no "
              f"misses")
        out[ef] = _recall(ids, gt, 10)
    return out


def _self_hits(g, vecs) -> float:
    """Share of the first 1,024 stored vectors found as their own top-1
    at ef=64."""
    _, ids = g.batch_search_slots(vecs[:1024], 1, ef=64)
    return float(np.mean(ids[:, 0] == np.arange(1024)))


def _self_retrieval(g, vecs, label: str) -> None:
    hit = _self_hits(g, vecs)
    check(hit >= 0.99, f"{label}: self-retrieval {hit:.4f} >= 0.99 (1024 "
          f"stored vectors, ef=64)")


def _check_structure(g, n: int, label: str) -> float:
    """The invariants of a built graph over slots [0, n): every node has
    layer-0 edges, every edge points at another inserted node in range,
    no row repeats an id, an upper layer's rows are empty below the
    node's level and point only at nodes of that level or higher, and
    the layer-1 share is within 0.03 of ml. Returns the share of nodes
    no layer-0 edge points at."""
    nb, levels, _, _ = g.host.arrays()
    lv = levels[:n]
    ok = bool((lv >= 0).all())
    for layer in range(nb.shape[0]):
        rows = nb[layer, :n]
        edge = rows >= 0
        member = lv >= layer
        ok &= not edge[~member].any()
        tgt = np.where(edge, rows, 0)
        ok &= bool(((tgt < n) & (lv[tgt] >= layer) | ~edge).all())
        ok &= not (edge & (rows == np.arange(n)[:, None])).any()
        srt = np.sort(np.where(edge, rows, -1 - np.arange(rows.shape[1])),
                      axis=1)
        ok &= not (srt[:, 1:] == srt[:, :-1]).any()
        if layer == 0:
            ok &= bool(edge.any(axis=1).all())
            orphans = float(np.mean(np.bincount(rows[edge], minlength=n)
                                    == 0))
    share = float(np.mean(lv >= 1))
    check(ok and abs(share - g.cfg.ml) <= 0.03,
          f"{label}: rows well formed over {n} nodes, layer-1 share "
          f"{share:.4f} within 0.03 of ml {g.cfg.ml}")
    return orphans


def phase_device_builds(st: dict) -> int:
    """Phase 9: every mode of the wave builder on the 100k cosine vectors
    of phase_graph_tier; returns K1's launches by route (the exact-tier
    oracle over the survivors of the delete)."""
    import tempfile

    from hnsw_tpu_torch import ExactIndex, Graph
    from hnsw_tpu_torch.convert import graph_from_host_arrays
    from hnsw_tpu_torch.core.build_device import BuildDeadlineExceeded
    base, queries, gt = st["base"], st["queries"], st["gt"]
    n = N_GRAPH
    keys = list(range(n))
    host_rec = st["recall"]
    _reset_launches()
    print(f"# device builds: {n} x {DIM} cosine, m=16, ef_construction=100,"
          f" wave={WAVE}", flush=True)

    with _NativeInserts() as nat:
        gd, t_build = _device_build(keys, base, "cosine", method="device")
    check(nat.calls == 0 and _all_inserted(gd, n),
          "device build: every key inserted, the native builder not called")
    orphans = _check_structure(gd, n, "device build")
    _self_retrieval(gd, base, "device build")
    rec = _graph_recalls(gd, queries, gt, "device build")
    cpu = graph_from_host_arrays(
        gd.cfg, gd.slots.slot_to_key, gd.store.vectors[:n],
        gd.store.alive[:n], *gd.host.arrays(), device="cpu")
    cpu.native_serve_max_batch = 0
    for ef in (64, 192):
        _, ids = gd.batch_search_slots(queries[:128], 10, ef=ef)
        _, ids_cpu = cpu.batch_search_slots(queries[:128], 10, ef=ef)
        ov = _overlap(ids, ids_cpu)
        check(ov >= 0.99, f"device build ef={ef}: card vs CPU id overlap "
              f"{ov:.4f} >= 0.99 (128 queries)")
        check(rec[ef] >= host_rec[ef] - 0.05,
              f"device build ef={ef}: recall@10 {rec[ef]:.4f} >= the native "
              f"build's {host_rec[ef]:.4f} - 0.05")
    del cpu
    print(f"  device build: {t_build:.1f} s ({n / t_build:.1f} nodes/s), "
          f"{gd.num_layers} layers, {orphans:.4f} of the nodes with no "
          f"layer-0 in-edge, recall@10 {rec[64]:.4f} / "
          f"{rec[192]:.4f} at ef 64 / 192 (native build "
          f"{host_rec[64]:.4f} / {host_rec[192]:.4f})", flush=True)

    gq, t_q = _device_build(keys, base, "cosine", method="device",
                            quant_descent=True, descent_dtype="float16")
    check(_all_inserted(gq, n), "int8-block fp16 descent: every key "
          "inserted")
    rec_q = _graph_recalls(gq, queries, gt, "int8-block fp16 descent")
    for ef in (64, 192):
        check(rec_q[ef] >= rec[ef] - 0.03,
              f"int8-block fp16 descent ef={ef}: recall@10 {rec_q[ef]:.4f} "
              f">= the f32 descent's {rec[ef]:.4f} - 0.03")
    print(f"  quant_descent + descent_dtype=float16: {t_q:.1f} s, recall@10 "
          f"{rec_q[64]:.4f} / {rec_q[192]:.4f}", flush=True)
    del gq

    doomed = keys[::10]
    t0 = time.perf_counter()
    oks = gd.batch_delete(doomed, refine=True)
    _sync_device()
    t_del = time.perf_counter() - t0
    check(all(oks) and len(gd) == n - len(doomed),
          f"batch_delete(refine=True) of {len(doomed)} keys")
    oracle = ExactIndex(metric="cosine", device=DEVICE)
    oracle.host_serve_max_batch = 0
    oracle.batch_add(keys, base)
    oracle.batch_delete(doomed)
    _, gt_surv = oracle.batch_search_slots(queries, 10)
    del oracle
    dead = set(doomed)
    rec_d = {}
    for ef in (64, 192):
        _, ids = gd.batch_search_slots(queries, 10, ef=ef)
        check(not dead & set(ids.ravel().tolist()),
              f"after delete ef={ef}: no deleted key returned")
        rec_d[ef] = _recall(ids, gt_surv, 10)
        check(rec_d[ef] >= 0.95 * rec[ef],
              f"after delete + refine ef={ef}: recall@10 over the survivors "
              f"{rec_d[ef]:.4f} >= 0.95 x {rec[ef]:.4f}")
    surv = np.asarray([k for k in keys[:1200] if k not in dead][:1024])
    _, self_ids = gd.batch_search_slots(base[surv], 1, ef=64)
    hit = float(np.mean(self_ids[:, 0] == surv))
    check(hit >= 0.99 and not dead & set(self_ids.ravel().tolist()),
          f"after delete: survivors find themselves ({hit:.4f} >= 0.99), "
          f"never a deleted key")
    print(f"  batch_delete(refine=True) of {len(doomed)} keys: {t_del:.1f} "
          f"s, recall@10 over the survivors {rec_d[64]:.4f} / "
          f"{rec_d[192]:.4f}", flush=True)
    del gd
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/build.npz"
        ga = Graph(m=16, ef_construction=100, metric="cosine", seed=0,
                   device=DEVICE)
        ga.native_serve_max_batch = 0
        try:
            ga.build(keys, base, method="device", wave=WAVE,
                     checkpoint_path=ckpt, abort_deadline=time.time())
            check(False, "a build past its deadline raises")
        except BuildDeadlineExceeded as e:
            check(e.graph is ga, "BuildDeadlineExceeded carries the graph")
        inserted = np.flatnonzero(ga.host.levels[:n] >= 0)
        check(512 <= len(inserted) < n, f"deadline abort: 512 <= "
              f"{len(inserted)} inserted < {n}")
        n_served = ga.mask_pending_for_serve()
        _, ids = ga.batch_search_slots(queries, 10, ef=64)
        check(n_served == len(inserted) and (ids >= 0).all()
              and set(ids.ravel().tolist()) <= set(inserted.tolist()),
              f"mask_pending_for_serve: {n_served} servable, results only "
              f"from the inserted prefix")
        del ga
        t0 = time.perf_counter()
        gr = Graph.resume_build(ckpt, wave=WAVE, device=DEVICE)
        _sync_device()
        t_res = time.perf_counter() - t0
    gr.native_serve_max_batch = 0
    check(_all_inserted(gr, n), "resume_build: every key inserted")
    rec_r = _graph_recalls(gr, queries, gt, "resumed build")
    for ef in (64, 192):
        check(rec_r[ef] >= rec[ef] - 0.05,
              f"resumed build ef={ef}: recall@10 {rec_r[ef]:.4f} >= the "
              f"straight build's {rec[ef]:.4f} - 0.05")
    print(f"  deadline abort after {len(inserted)} nodes, resume_build "
          f"{t_res:.1f} s, recall@10 {rec_r[64]:.4f} / {rec_r[192]:.4f}",
          flush=True)
    del gr
    torch.cuda.empty_cache()
    launches = _launches()
    check(launches["wgmma"] >= 1 and launches["fma"] == 0,
          f"the exact-tier oracle launched the wgmma kernel "
          f"{launches['wgmma']} times")
    return launches


class _WaveProbe:
    """Counts the device builder's waves and profiles one of them with
    torch.profiler: the wave's descent, row assembly, diversity selection
    (inside assembly and reverse update) and reverse update each run
    under a record_function label."""

    LABELS = {"construction_descent": "build.descent",
              "_assemble_wave_rows": "build.assemble",
              "_reverse_update": "build.reverse",
              "_diverse_select_dev": "build.select"}

    def __init__(self, profile_wave: int):
        from hnsw_tpu_torch.core import build_device
        self.mod, self.profile_wave = build_device, profile_wave
        self.orig = {k: getattr(build_device, k) for k in self.LABELS}
        self.waves, self.prof, self.summary = 0, None, None

    def __enter__(self):
        for name, label in self.LABELS.items():
            setattr(self.mod, name, self._wrap(name, label))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)
        if self.prof is not None:
            self._stop()

    def _wrap(self, name, label):
        fn = self.orig[name]

        def wrapped(*a, **kw):
            if name == "construction_descent":
                self._wave_boundary()
            if self.prof is None:
                return fn(*a, **kw)
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return wrapped

    def _wave_boundary(self):
        if self.prof is not None:
            self._stop()
        self.waves += 1
        if self.waves == self.profile_wave:
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.t0 = time.perf_counter()

    def _stop(self):
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self.t0) * 1e6
        self.prof.stop()
        events = [e for e in self.prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU]

        def n_kernels(e):
            return len(e.kernels) + sum(n_kernels(c) for c in e.cpu_children)

        parts = {}
        for label in self.LABELS.values():
            top = [e for e in events if e.name == label]
            parts[label] = {"calls": len(top),
                            "launches": sum(n_kernels(e) for e in top),
                            "device_ms": sum(e.device_time_total
                                             for e in top) / 1e3}
        dev_us = sum(k.duration for e in events for k in e.kernels)
        self.summary = {
            "wave": self.waves, "wall_ms": wall_us / 1e3,
            "device_ms": dev_us / 1e3,
            "launches": sum(len(e.kernels) for e in events),
            "idle_share": max(0.0, 1.0 - dev_us / wall_us), "parts": parts}
        self.prof = None


def phase_sift_shape_build() -> int:
    """Phase 10: a 1,048,576 x 128 L2 build that Graph.build's "auto"
    routes to the wave builder; returns K1's launches by route (the
    exact-tier oracle)."""
    from hnsw_tpu_torch import ExactIndex
    rng = np.random.default_rng(4)
    base = rng.standard_normal((N_SIFT, DIM), dtype=np.float32)
    queries = rng.standard_normal((BATCH, DIM), dtype=np.float32)
    keys = list(range(N_SIFT))
    print(f"# device build at SIFT1M's shape: {N_SIFT} x {DIM} l2, m=16, "
          f"ef_construction=100, wave={WAVE}, method=auto", flush=True)
    torch.cuda.reset_peak_memory_stats()
    with _NativeInserts() as nat, _WaveProbe(PROFILE_WAVE) as probe:
        g, t_build = _device_build(keys, base, "l2", method="auto")
    check(nat.calls == 0, "auto routed past the native builder (0 calls)")
    check(_all_inserted(g, N_SIFT), "every key inserted")
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = np.bincount(g.host.levels[:N_SIFT]).tolist()
    print(f"  build {t_build:.1f} s, {N_SIFT / t_build:.1f} nodes/s, "
          f"{probe.waves} waves, peak device memory {peak:.2f} GB, nodes "
          f"per level {hist}", flush=True)
    # No self-retrieval bound here: on isotropic Gaussian L2 rows no
    # builder of either package reaches one (distance concentration, and
    # the closest-m reverse update leaves nodes with no in-edge: ROADMAP
    # fault F8). The build is held to its invariants; its quality against
    # the native builder is phase 9's check.
    orphans = _check_structure(g, N_SIFT, "SIFT1M-shape build")
    print(f"  self-retrieval {_self_hits(g, base):.4f} (1024 stored "
          f"vectors, ef=64), {orphans:.4f} of the nodes with no layer-0 "
          f"in-edge", flush=True)

    _reset_launches()
    oracle = ExactIndex(metric="l2", device=DEVICE)
    oracle.host_serve_max_batch = 0
    oracle.batch_add(keys, base)
    _, gt = oracle.batch_search_slots(queries, 10)
    launches = _launches()
    check(launches["wgmma"] >= 1 and launches["fma"] == 0,
          f"the exact-tier oracle launched the wgmma kernel "
          f"{launches['wgmma']} times")
    del oracle
    for ef in (64, 192):
        d, ids = g.batch_search_slots(queries, 10, ef=ef)
        check(ids.shape == (BATCH, 10) and (ids >= 0).all()
              and np.isfinite(d).all(),
              f"ef={ef}: finite [{BATCH}, 10] results, no misses")
        print(f"  ef={ef}: recall@10 {_recall(ids, gt, 10):.4f} vs the exact "
              f"tier, hops per layer (top..0) {g.last_search_hops}",
              flush=True)
    s = probe.summary
    check(s is not None and s["launches"] > 0,
          f"wave {PROFILE_WAVE} profiled")
    print(f"  wave {s['wave']} profile: wall {s['wall_ms']:.1f} ms, device "
          f"{s['device_ms']:.1f} ms, idle share {s['idle_share']:.3f}, "
          f"{s['launches']} launches", flush=True)
    for label, p in s["parts"].items():
        print(f"    {label}: {p['calls']} calls, {p['launches']} launches, "
              f"device {p['device_ms']:.1f} ms", flush=True)
    del g
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    timing = phase_kernel_vs_plain()
    launches = phase_exact_tier()
    launches = _add(launches, phase_exact_tier_glove50())
    graph = phase_graph_tier()
    launches = _add(launches, phase_capacity_ladder())
    launches = _add(launches, phase_auto_ladder())
    phase_graph_modes(graph)
    launches = _add(launches, phase_device_builds(graph))
    del graph
    launches = _add(launches, phase_sift_shape_build())
    check(all(launches[r] > 0 for r in timing),
          f"the main path launched every K1 route: {launches}")
    print(f"# smoke: {time.perf_counter() - t_start:.1f} s, the kernels' "
          f"build included", flush=True)
    print(smi)
    print(json.dumps({"kernels": [dict(timing[r], launches=launches[r])
                                  for r in ("wgmma", "fma")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
