"""Headline benchmark of the port (counterpart of ``bench.py``).

    python3 -m hnsw_tpu_torch.tools.bench [--device cpu]

Configuration (bench.py's): 10,000 x 128 Gaussian float32 rows from seed
0, cosine, k=10, 8,192 queries. Reference anchor: the Go library's
adaptive hybrid engine serves this at 2.51 ms a query, about 398 QPS, at
recall 0.98 (hybrid/README.md:650).

Rows, as in bench.py:

* exact tier: ``ops/exact_screen.exact_scan`` over the graph's device
  table, f32 and fast_math (at 10,000 rows: the plain chunked scan, below
  K1's 32,768-row switch); the f32 scan is the ground truth;
* graph tier: block layout + pivot entry, fast_math, ef 192 / 256 / 384
  on 1,024 queries; hops per layer on ``#`` lines (F4);
* single-query latency: the native graph beam at ef 192 / 384 and the
  exact index's host tier, then the adaptive engine after ``warm(k)``
  and 64 steady queries (needs the native engine).

Every timed call ends in a synchronisation of the card; ``_bench`` keeps
the median of its reps and the spread (max - min) / median. Prints ONE
JSON line with bench.py's keys plus ``package``, ``platform``,
``device`` and ``power_limit_w``. Without ``--device cpu`` it runs on
the CUDA card or exits with an error.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Tuple

import numpy as np
import torch

#: the Go adaptive hybrid engine on this configuration, 398.4 QPS = 2.51
#: ms mean at recall 0.98 (hybrid/README.md:650); the latency anchor is
#: derived from the one constant
BASELINE_QPS = 398.4
BASELINE_MS = 1000.0 / BASELINE_QPS
K = 10


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench(fn, reps: int = 9):
    """(median s, spread, last result) of ``reps`` timed calls after two
    warm calls; ``fn`` synchronises the card before it returns."""
    fn()
    fn()
    times = []
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    ts = sorted(times)
    med = ts[len(ts) // 2]
    spread = (ts[-1] - ts[0]) / med if med > 0 else 0.0
    return med, spread, out


def card_fields(device: torch.device) -> dict:
    """``platform``, ``device`` and ``power_limit_w``: the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit`` prints
    them, or the CPU's "cpu" and None."""
    if device.type != "cuda":
        return {"platform": "cpu", "device": "cpu", "power_limit_w": None}
    name, limit = torch.cuda.get_device_name(device), None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60
        ).stdout.strip().splitlines()[0]
        name, watts = (s.strip() for s in smi.rsplit(",", 1))
        limit = float(watts.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass   # no nvidia-smi: the name from torch, no limit
    return {"platform": "gpu", "device": name, "power_limit_w": limit}


def make_data(n: int, n_q: int, d: int = 128, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """bench.py's rows and queries: one generator, rows first."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((n_q, d)).astype(np.float32)
    return data, queries


def build_graph(data: np.ndarray, device=None):
    from hnsw_tpu_torch import Graph
    g = Graph(m=16, ef_search=20, metric="cosine", seed=0, device=device)
    g.build(list(range(len(data))), data, wave=2048)
    return g


def exact_ids(dev, queries: torch.Tensor, fast_math: bool = False
              ) -> torch.Tensor:
    """The exact tier's top-K slots over the graph's device table."""
    from hnsw_tpu_torch.ops.exact_screen import exact_scan
    _, ii = exact_scan(queries, dev.vectors, dev.sq_norms, dev.alive, k=K,
                       metric="cosine", fast_math=fast_math)
    return ii


def _recall(ids: np.ndarray, gt: np.ndarray) -> float:
    hits = sum(len(set(map(int, ids[q])) & set(map(int, gt[q])))
               for q in range(len(gt)))
    return hits / (len(gt) * K)


def _latency_rungs(g, data: np.ndarray, device):
    """(name, single-query fn) rungs of the host latency tier: the native
    graph beam at two ef points and the exact index's host scan."""
    from hnsw_tpu_torch import ExactIndex
    ex = ExactIndex(metric="cosine", device=device)
    ex.batch_add(list(range(len(data))), data)
    rungs = [(f"hnsw:{ef}", lambda q, _ef=ef: g.search(q, K, ef=_ef))
             for ef in (192, 384)]
    rungs.append(("exact_scan", lambda q: ex.search(q, K)))
    return rungs


def _single(fn1, queries: np.ndarray, gt: np.ndarray):
    """(p50 ms, mean ms, recall@K) of single queries, one at a time."""
    lats, nhits = [], 0
    for qi in range(len(queries)):
        t1 = time.perf_counter()
        res = fn1(queries[qi])
        lats.append(time.perf_counter() - t1)
        nhits += len({kk for kk, _ in res} & set(map(int, gt[qi])))
    n1 = len(queries)
    return (sorted(lats)[n1 // 2] * 1e3, sum(lats) / n1 * 1e3,
            nhits / (n1 * K))


def _latency_fields(g, data, q1k, gt, device) -> dict:
    """The native single-query rungs and the adaptive engine (bench.py's
    ``lat_fields``); {} without the native engine."""
    from hnsw_tpu_torch import AdaptiveHybridIndex, HybridConfig
    from hnsw_tpu_torch import native
    if not native.available():
        return {}
    nq1 = min(256, len(q1k))
    qs, gts = q1k[:nq1], gt[:nq1]
    g.search(q1k[0], K, ef=192)   # warm: engine construction
    rungs = []
    for name, fn1 in _latency_rungs(g, data, device):
        fn1(q1k[0])               # warm: sidecar build, first touch
        p50, mean, rec1 = _single(fn1, qs, gts)
        rungs.append((name, p50, mean, rec1))
        print(f"# native single-query [{name}]: p50 {p50:.3f} ms mean "
              f"{mean:.3f} ms recall@10={rec1:.4f}", file=sys.stderr)
    # the adaptive engine end to end: the counterpart of the reference's
    # 2.51 ms row (its average at recall .98, bandit overhead included)
    eng = AdaptiveHybridIndex(
        hybrid_config=HybridConfig(exact_threshold=500), device=device)
    try:
        eng.batch_add(list(range(len(data))), data)
        eng.warm(K)
        for i in range(64):       # steady state, like the reference table
            eng.search(q1k[i % len(q1k)], K)
        a_p50, a_mean, a_rec = _single(lambda q: eng.search(q, K), qs, gts)
    finally:
        eng.close()
    print(f"# adaptive hybrid engine: p50 {a_p50:.3f} ms mean "
          f"{a_mean:.3f} ms recall@10={a_rec:.4f}", file=sys.stderr)
    rungs.append(("adaptive", a_p50, a_mean, a_rec))
    fields = {"adaptive_engine_mean_ms": round(a_mean, 3),
              "adaptive_engine_p50_ms": round(a_p50, 3),
              "adaptive_engine_recall": round(a_rec, 4)}
    # headline: the fastest rung at the reference's quality point (recall
    # >= 0.98), mean to mean; omitted when no rung reaches it
    band = [r for r in rungs if r[3] >= 0.98]
    if band:
        name, p50, mean, rec1 = min(band, key=lambda r: r[2])
        fields.update({
            "single_query_p50_ms": round(p50, 3),
            "single_query_mean_ms": round(mean, 3),
            "single_query_recall": round(rec1, 4),
            "single_query_tier": name,
            "latency_vs_baseline": round(BASELINE_MS / mean, 1),
        })
    return fields


def run(device=None, n: int = 10_000, n_q: int = 8192,
        reps: int = 9) -> dict:
    """The whole bench on ``device`` (None: the CUDA card, or raise);
    returns the JSON record (also the ``#`` lines on stderr)."""
    from hnsw_tpu_torch.core.state import default_device
    device = torch.device(device) if device is not None \
        else default_device()
    data, queries_np = make_data(n, n_q)

    t0 = time.perf_counter()
    g = build_graph(data, device)
    build_s = time.perf_counter() - t0
    print(f"# graph build: {build_s:.1f}s", file=sys.stderr)
    g.fast_math = True
    dev = g.device_graph()
    queries = torch.from_numpy(queries_np).to(device)
    gt = exact_ids(dev, queries).cpu().numpy()

    def exact_row(fast_math: bool):
        def serve():
            ii = exact_ids(dev, queries, fast_math)
            _sync(device)
            return ii
        dt, spread, ii = _bench(serve, reps)
        return n_q / dt, spread, _recall(ii.cpu().numpy(), gt)

    exact_qps, exact_spread, exact_recall = exact_row(False)
    print(f"# hybrid/exact tier: {exact_qps:.0f} qps recall@10="
          f"{exact_recall:.4f} spread={exact_spread:.2f}", file=sys.stderr)
    fast_qps, fast_spread, fast_recall = exact_row(True)
    print(f"# hybrid/exact fast_math: {fast_qps:.0f} qps recall@10="
          f"{fast_recall:.4f} spread={fast_spread:.2f}", file=sys.stderr)

    # the graph tier's serving configuration: neighbour blocks + pivot
    # entry, bf16 traversal, f32 rerank
    g.block_layout = True
    g.entry_mode = "pivots"
    q1k = queries_np[:1024]
    nb = len(q1k)
    hnsw_points, hnsw_spreads = [], {}
    for ef in (192, 256, 384):
        def serve_hnsw(_ef=ef):
            keys, _ = g.batch_search(q1k, K, ef=_ef)
            _sync(device)
            return keys
        dt, spr, keys = _bench(serve_hnsw, max(1, reps - 2))
        rec = sum(len(set(keys[q]) & set(map(int, gt[q])))
                  for q in range(nb)) / (nb * K)
        hnsw_points.append((ef, nb / dt, rec))
        hnsw_spreads[ef] = spr
        print(f"# hnsw graph ef={ef}: {nb / dt:.0f} qps recall@10="
              f"{rec:.4f} spread={spr:.2f}", file=sys.stderr)
        print(f"# hnsw graph ef={ef}: hops by layer, top first "
              f"{g.last_search_hops}", file=sys.stderr)

    lat_fields = _latency_fields(g, data, q1k, gt, device)

    best95 = max((p for p in hnsw_points if p[2] >= 0.95),
                 key=lambda p: p[1],
                 default=max(hnsw_points, key=lambda p: p[2]))
    best98 = max((p for p in hnsw_points if p[2] >= 0.98),
                 key=lambda p: p[1],
                 default=max(hnsw_points, key=lambda p: p[2]))
    return {
        "metric": "hybrid_engine_qps_10kx128_cosine_recall@10",
        "value": round(exact_qps, 0),
        "unit": "qps",
        "vs_baseline": round(exact_qps / BASELINE_QPS, 1),
        "recall": round(exact_recall, 4),
        "exact_fast_qps": round(fast_qps, 0),
        "exact_fast_recall": round(fast_recall, 4),
        "hnsw_qps_at_recall>=0.95": round(best95[1], 0),
        "hnsw_recall": round(best95[2], 4),
        "hnsw_qps_at_recall>=0.98": round(best98[1], 0),
        "hnsw_recall@0.98_point": round(best98[2], 4),
        "hnsw_vs_baseline_at_0.98": round(best98[1] / BASELINE_QPS, 1),
        "exact_qps_spread": round(exact_spread, 3),
        "exact_fast_qps_spread": round(fast_spread, 3),
        "hnsw_qps_spread": round(max(hnsw_spreads.values()), 3),
        "build_seconds": round(build_s, 1),
        "package": "hnsw_tpu_torch",
        **card_fields(device),
        **lat_fields,
    }


def main(argv=None, n: int = 10_000, n_q: int = 8192,
         reps: int = 9) -> dict:
    """Parse ``argv``, run the bench at the given sizes and print its one
    JSON line; returns the record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    rec = run(args.device, n=n, n_q=n_q, reps=reps)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
