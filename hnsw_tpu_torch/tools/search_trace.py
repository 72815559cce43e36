#!/usr/bin/env python3
"""What one 1,024-query graph batch launches and waits for, on one NVIDIA
GPU.

    python3 -m hnsw_tpu_torch.tools.search_trace [--parent ROOT]
        [--out DIR] [--ef 64 192] [--reps 5]

Serves the smoke's graph tier (100,000 x 128 Gaussian rows, seed 1, m=16,
ef_construction=100, cosine, native builder; 1,024 queries) through
``Graph.batch_search_slots`` in two modes: "default" (f32 rows at HIGHEST,
the upper-layer descent) and "bench" (``bench.py``'s mode: ``fast_math``,
int8 neighbour blocks, ``entry_mode="pivots"``). For each mode and ef it
prints the batch's QPS (median of ``--reps`` host-clock runs, each ending
in a sync), its recall@10 against the exact answer (float64 numpy), and
one traced batch (``utils/profiling.trace_summary`` of this file's
checkout, whichever package a run serves, so that a parent's run counts
the same things): wall and device
ms, the device's idle share, the kernel launches by name, the copies and
sets, and the host's waits for the card (``cudaStreamSynchronize`` calls:
every ``.cpu()`` and ``int()`` of a card tensor).

Each run is a fresh process of the checkout at its root. With ``--parent
ROOT`` (another checkout, e.g. ``git archive <commit> | tar -x -C
.scratch/parent``) it runs parent, change, change, parent, each importing
its own package, and prints them side by side. The graph is built once
and kept in ``--out`` (default build/search_trace) for the later runs.
Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

N_GRAPH, DIM, N_QUERIES = 100_000, 128, 1024
MODES = {"default": {},
         "bench": dict(fast_math=True, block_layout=True,
                       block_dtype="int8", entry_mode="pivots")}
#: where the graph serves (the CPU only to rehearse the tool's plumbing)
DEVICE = "cuda"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' templates and
    arguments: ``beam_search_kernel``, ``elementwise_kernel``, ..."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name, 1)[0]
    return name.rsplit("::", 1)[-1] or name


def _trace_summary():
    """This checkout's ``utils/profiling.trace_summary``, loaded from its
    file: the worker imports the package it measures (a parent's too),
    whose ``trace_summary`` may count less."""
    spec = importlib.util.spec_from_file_location(
        "_search_trace_profiling",
        os.path.join(_ROOT, "hnsw_tpu_torch", "utils", "profiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.trace_summary


def _graph(cache: str):
    """The graph tier's Graph on the card, its queries and the exact top
    10: built with the native builder and saved to ``cache`` on the first
    run, loaded from it on the later ones."""
    from hnsw_tpu_torch import Graph
    from hnsw_tpu_torch.convert import graph_from_host_arrays
    rng = np.random.default_rng(1)
    base = rng.standard_normal((N_GRAPH, DIM), dtype=np.float32)
    queries = rng.standard_normal((N_QUERIES, DIM), dtype=np.float32)
    g = Graph(m=16, ef_construction=100, metric="cosine", seed=0,
              device=DEVICE)
    if not os.path.exists(cache):
        g.build(list(range(N_GRAPH)), base, method="host")
        nb, levels, entry, top = g.host.arrays()
        bn = base / np.linalg.norm(base, axis=1, keepdims=True)
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        sims = qn.astype(np.float64) @ bn.astype(np.float64).T
        truth = np.argsort(-sims, axis=1, kind="stable")[:, :10]
        tmp = f"{cache}.{os.getpid()}.npz"
        np.savez(tmp, n=g.slots.capacity_used, neighbors=nb, levels=levels,
                 entry=entry, top=top, truth=truth)
        os.replace(tmp, cache)
    z = np.load(cache)
    n = int(z["n"])
    g = graph_from_host_arrays(g.cfg, list(range(n)), base[:n],
                               np.ones(n, bool), z["neighbors"],
                               z["levels"], int(z["entry"]), int(z["top"]),
                               device=DEVICE)
    g.native_serve_max_batch = 0
    return g, queries, z["truth"]


def worker(cache: str, efs: List[int], reps: int) -> dict:
    """One checkout's numbers (the package on ``sys.path``)."""
    import torch
    trace_summary = _trace_summary()
    g, queries, truth = _graph(cache)
    out = {"device": torch.cuda.get_device_name(0)}
    try:
        from hnsw_tpu_torch.ops import graph_search as k5
    except ImportError:
        k5 = None
    for mode, attrs in MODES.items():
        saved = {k: getattr(g, k) for k in attrs}
        for k, v in attrs.items():
            setattr(g, k, v)
        for ef in efs:
            def batch():
                return g.batch_search_slots(queries, 10, ef=ef)
            _, ids = batch()
            torch.cuda.synchronize()
            hits = sum(len(set(a.tolist()) & set(b.tolist()))
                       for a, b in zip(ids, truth))
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                batch()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            k5_before = k5.launches if k5 is not None else None
            s = trace_summary(batch)
            if s is None:
                raise RuntimeError("the trace of a graph batch holds no "
                                   "kernel event")
            kernels: Dict[str, int] = {}
            kernel_ms: Dict[str, float] = {}
            for name, n in s["launches_by_name"].items():
                short = short_name(name)
                kernels[short] = kernels.get(short, 0) + n
                kernel_ms[short] = (kernel_ms.get(short, 0.0)
                                    + s["by_name"][name])
            out[f"{mode} ef={ef}"] = dict(
                qps=N_QUERIES / statistics.median(times),
                recall=hits / (10 * len(truth)), wall_ms=s["wall_ms"],
                device_ms=s["device_ms"], idle_share=s["idle_share"],
                launches=s["launches"], kernels=kernels,
                kernel_ms=kernel_ms, copies=s["copies"], syncs=s["syncs"],
                k5_launches=(None if k5 is None
                             else k5.launches - k5_before),
                hops=list(g.last_search_hops))
        for k, v in saved.items():
            setattr(g, k, v)
    return out


def _run(root: str, args) -> dict:
    """``worker`` in a fresh process that imports ``root``'s package."""
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           "--out", args.out, "--reps", str(args.reps),
           "--ef", *map(str, args.ef)]
    res = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=1800)
    if res.returncode != 0:
        raise RuntimeError(f"search_trace worker in {root} failed:\n"
                           f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def report(label: str, r: dict) -> str:
    kernels = ", ".join(f"{k} {n} ({r['kernel_ms'][k]:.3f} ms)"
                        for k, n in sorted(r["kernels"].items(),
                                           key=lambda kv: -kv[1]))
    copies = ", ".join(f"{k} {n}" for k, n in r["copies"].items())
    return (f"  {label}: {r['qps']:.1f} QPS, recall@10 {r['recall']:.4f}; "
            f"traced batch wall {r['wall_ms']:.3f} ms, device "
            f"{r['device_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
            f"{r['launches']} launches ({kernels}); copies and sets: "
            f"{copies}; host syncs {r['syncs']}; K5 launches "
            f"{r['k5_launches']}; hops {r['hops']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout's root, run in turns")
    ap.add_argument("--out", default=os.path.join(_ROOT, "build",
                                                  "search_trace"))
    ap.add_argument("--ef", type=int, nargs="+", default=[64, 192])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)
    cache = os.path.join(args.out, "graph.npz")
    if args.worker:
        print(json.dumps(worker(cache, args.ef, args.reps)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("search_trace needs a CUDA card")
    order = ([("parent", os.path.abspath(args.parent)), ("change", _ROOT),
              ("change", _ROOT), ("parent", os.path.abspath(args.parent))]
             if args.parent else [("change", _ROOT)])
    runs = [(name, _run(root, args)) for name, root in order]
    print(f"# {runs[0][1]['device']}: one {N_QUERIES}-query batch of the "
          f"{N_GRAPH} x {DIM} cosine graph a run (runs in this order: "
          f"{', '.join(n for n, _ in runs)})", flush=True)
    for key in (k for k in runs[0][1] if k != "device"):
        print(f"# {key}", flush=True)
        for i, (name, r) in enumerate(runs):
            print(report(f"{name} (run {i + 1})", r[key]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
