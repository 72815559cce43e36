"""The readings that the limits of the comparison are set from.

    python3 -m portbench.control --workload <cell> [<cell> ...]
        --seeds <n> ... [--control-seeds <n> ...] [--seconds 2]

The cells named share one configuration. For each seed it builds the
configuration's graph once, as a run does, and for each cell runs a short
window of the program as configured and judges it as a run does, against
the cell's own limits (the lower readings). On each of
``--control-seeds`` it then runs, on the same graph, the control (the
program's own lower precision, ``fast_math``: bfloat16 operands in the
search, a float32 rerank of the pool's head) and each fault of the search
(``FAULTS``), planted under the timed path: a search that returns the state
it was given, half of the batch left out (it gets the other half's
answers), one answer altered where it is produced. Then it builds the graph
again with each fault of the build (``BUILD_FAULTS``): lists selected
closest-first without the diversity heuristic, layer-0 lists half as wide,
no reverse edges; and runs and judges each cell on it. One JSON line a
reading on standard output: the numbers compared, ``correct`` under the
cell's limits, and K5's launches. The benchmark's own runs never run this.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from portbench import cells, check, run, stats


def _unchanged(real, g, q, kw):
    return real(g, q, **dict(kw, max_hops=0))


def _half_left_out(real, g, q, kw):
    h = q.shape[0] // 2
    d, i = real(g, q[:h], **kw)
    return torch.cat([d, d]), torch.cat([i, i])


def _answer_altered(real, g, q, kw):
    d, i = real(g, q, **kw)
    i = i.clone()
    i[3, 4] = (i[3, 4] + 1) % g.cap
    return d, i


#: faults of the search, planted on ``index/hnsw.search_graph``
FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@contextlib.contextmanager
def _no_diversify(conf: dict) -> Iterator[dict]:
    yield {"diversify": False}


@contextlib.contextmanager
def _layer0_half(conf: dict) -> Iterator[dict]:
    yield {"m0": int(conf["m0"]) // 2}


@contextlib.contextmanager
def _no_reverse_edges(conf: dict) -> Iterator[dict]:
    import hnsw_tpu_torch.core.build_device as build_device
    real = build_device._reverse_update
    build_device._reverse_update = lambda *a, **kw: None
    try:
        yield {}
    finally:
        build_device._reverse_update = real


#: faults of the build: each, given the configuration, a context that
#: plants it and yields the graph's configuration fields it overrides
BUILD_FAULTS: Dict[str, Callable] = {
    "no_diversify": _no_diversify, "layer0_half": _layer0_half,
    "no_reverse_edges": _no_reverse_edges}


def retarget(s: run.Session, cell: cells.Cell) -> run.Session:
    """``s``'s data and graph with ``cell``'s batches (a cell of the same
    configuration), warmed up as a run's set-up does."""
    idx = stats.cut_batches(cell.traffic, len(s.pool), s.seed)
    t = dataclasses.replace(
        s, cell=cell, batch_idx=idx, walked=None,
        batches=[np.ascontiguousarray(s.pool[ix]) for ix in idx])
    run._search(t, t.batches[0])
    return t


def _read(s: run.Session, graph, seconds: float, build: str,
          variant: str) -> Dict:
    w = run.measure(s, seconds, False)
    numbers, recall, failed, _ = run.judge(s, w, graph, False)
    correct = check.judge(numbers, s.cell.limits)[0]
    return {"cell": s.cell.name, "seed": s.seed, "build": build,
            "variant": variant, "correct": correct, "build_s": s.build_s,
            "calls": len(w.calls), "k5_launches": w.k5_launches,
            "plain": w.plain, "recall_at_10": recall, "failed": failed,
            **numbers}


def readings(names: List[str], seeds: List[int], control_seeds: List[int],
             seconds: float) -> None:
    import hnsw_tpu_torch.index.hnsw as hnsw
    group = [cells.load(n) for n in names]
    if len({json.dumps(c.config, sort_keys=True) for c in group}) != 1:
        raise ValueError("the cells named must share one configuration")
    dev = torch.device("cuda")
    real = hnsw.search_graph
    for seed in seeds:
        builds = ["program"]
        if seed in control_seeds:
            builds += list(BUILD_FAULTS)
        for build in builds:
            fault = (BUILD_FAULTS[build] if build in BUILD_FAULTS
                     else lambda conf: contextlib.nullcontext({}))
            with fault(group[0].config) as graph_kw:
                first = run.set_up(group[0], seed, dev, graph_kw=graph_kw)
            graph = run.graph_arrays(first)
            for cell in group:
                s = first if cell is group[0] else retarget(first, cell)
                variants = ["program"]
                if build == "program" and seed in control_seeds:
                    variants += ["control", *FAULTS]
                for v in variants:
                    s.graph.fast_math = v == "control"
                    if v in FAULTS:
                        hnsw.search_graph = (lambda g, q, _f=FAULTS[v], **kw:
                                             _f(real, g, q, kw))
                    try:
                        r = _read(s, graph, seconds, build, v)
                    finally:
                        hnsw.search_graph = real
                    print(json.dumps(r), flush=True)
            s.graph = first.graph = None
            del s, first
            torch.cuda.empty_cache()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(run.HOST_THREADS)
    readings(args.workload, args.seeds, args.control_seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
