"""One run of one cell of the benchmark of ``hnsw_tpu_torch``.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up makes the configuration's rows and a pool of queries from the seed
on the card, builds the graph with the device wave builder
(``Graph.build(method="device")``, timed for ``build_vps.setup``), cuts
the traffic mix's batches from the pool and warms up with one call. The window
then calls ``Graph.batch_search_slots`` back to back, one client in a
closed loop, for ``--seconds``. Afterwards the plain reference
(``reference``) judges the answers the client kept: each batch's first
call's and a sample of the later calls' drawn from the seed (``check``).
With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` the window runs under ``torch.profiler`` and
they are its per-layer metrics, read from the trace by
``portbench/metrics/<name>.py``.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Without a CUDA card (or with fewer than the cell asks for), with JAX or
the JAX package loaded, where a call did not launch K5 once or a search
ran the plain version on the card, or where a per-layer metric that the
cell lists reads nothing, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Callable, Dict, List, Optional, Tuple  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import (cells, check, datagen, reference,  # noqa: E402
                       roofline, stats)
from portbench import trace as tracing  # noqa: E402

#: pool queries the reference walks at a time
_WALK_CHUNK = 4096
#: the share of the window's calls, besides each batch's first, whose
#: answers the client keeps to be judged, drawn from the seed
SAMPLE_SHARE = 1 / 16
#: calls a window draws the sample for (far more than any window makes)
_MAX_CALLS = 1 << 20
#: the process's intra-op threads (``torch.set_num_threads``)
HOST_THREADS = 1
#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "hnsw_tpu")


class NotRunnable(RuntimeError):
    """The run cannot give a result: no card, or a forbidden module."""


def forbidden_modules() -> List[str]:
    """The loaded modules' top-level names that are in ``FORBIDDEN``,
    compared whole (``hnsw_tpu_torch`` is not ``hnsw_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(x):
    return x if x is None or math.isfinite(x) else None


@dataclasses.dataclass
class Session:
    """What a run's set-up made: the data, the batches cut from the pool,
    the program's graph, and the seconds its build and the set-up took."""
    cell: cells.Cell
    seed: int
    dev: torch.device
    rows: np.ndarray
    pool: np.ndarray
    batch_idx: List[np.ndarray]
    batches: List[np.ndarray]
    graph: object
    build_s: float
    setup_s: float = 0.0
    #: the exact top k and the reference's walk, of every pool query
    truth: Optional[np.ndarray] = None
    walked: Optional[np.ndarray] = None


@dataclasses.dataclass
class Window:
    """What the window gave: (batch index, distances, ids) a call, with
    None for both where the client did not keep the answers, each call's
    latency, the queries answered, the window's seconds, the trace's path,
    and the program's counters of K5's launches and of searches on the
    card that ran its plain version."""
    calls: List
    lat: List[float]
    queries: int
    window_s: float
    trace_path: Optional[str]
    k5_launches: int
    plain: int

    def k5_fault(self) -> Optional[str]:
        """Why K5 did not do the window's work on the card (a search ran
        the plain version, or a call launched K5 other than once), or
        None."""
        if self.plain or self.k5_launches != len(self.calls):
            return (f"K5 launched {self.k5_launches} times for "
                    f"{len(self.calls)} calls, {self.plain} searches ran "
                    f"the plain version on the card")
        return None


def set_up(cell: cells.Cell, seed: int, dev: torch.device,
           prepare: Optional[Callable] = None,
           graph_kw: Optional[dict] = None) -> Session:
    """Rows and the query pool from the seed, the graph built, the batches
    cut, one warm-up call; ``prepare(graph)`` after the build.
    ``graph_kw`` overrides fields of the graph's configuration (a build
    fault of ``control``)."""
    from hnsw_tpu_torch import Graph
    from hnsw_tpu_torch.config import GraphConfig
    conf, traffic = cell.config, cell.traffic
    n, d_, n_pool = int(conf["rows"]), int(conf["dim"]), int(conf["queries"])
    t = time.perf_counter()
    rows_dev, pool_dev = datagen.generate(conf["generator"], n, n_pool, d_,
                                          seed, dev)
    rows, pool = rows_dev.cpu().numpy(), pool_dev.cpu().numpy()
    del rows_dev, pool_dev
    batch_idx = stats.cut_batches(traffic, n_pool, seed)
    batches = [np.ascontiguousarray(pool[ix]) for ix in batch_idx]
    _log(f"setup: data {time.perf_counter() - t:.3f} s")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    search = conf["search"]
    kw = dict(m=int(conf["m"]), m0=int(conf["m0"]), ml=float(conf["ml"]),
              ef_construction=int(conf["ef_construction"]),
              diversify=bool(conf["diversify"]), metric=conf["metric"],
              seed=int(seed) % (1 << 32), max_hops=int(search["max_hops"]),
              search_expand=int(search["expand"]))
    g = Graph(config=GraphConfig(**{**kw, **(graph_kw or {})}), device=dev)
    g.fast_math = bool(conf["fast_math"])
    wave = int(conf["wave"])
    # two waves through a throwaway graph first: the first run in a
    # checkout compiles the builder's kernels there, not in the timed build
    warm, n_warm = Graph(config=g.cfg, device=dev), min(n, 2 * wave)
    warm.build(list(range(n_warm)), rows[:n_warm], method="device",
               wave=wave)
    del warm
    _sync(dev)
    t = time.perf_counter()
    g.build(list(range(n)), rows, method="device", wave=wave)
    _sync(dev)
    build_s = time.perf_counter() - t
    _log(f"setup: build {build_s:.3f} s ({n / build_s:.1f} vectors/s)")
    if prepare is not None:
        prepare(g)
    s = Session(cell, seed, dev, rows, pool, batch_idx, batches, g, build_s)
    t = time.perf_counter()
    _search(s, batches[0])
    _sync(dev)
    _log(f"setup: layout and warm-up {time.perf_counter() - t:.3f} s")
    return s


def _search(s: Session, batch: np.ndarray):
    return s.graph.batch_search_slots(batch, int(s.cell.traffic["k"]),
                                      ef=int(s.cell.traffic["ef"]))


def measure(s: Session, seconds: float, traced: bool) -> Window:
    """Calls back to back, one client in a closed loop, the batches in
    turn, until ``seconds`` have passed; under the profiler if
    ``traced``. The client keeps, to be judged once the window has
    closed, the answers of each batch's first call and of a sample of the
    later calls drawn from the seed (``SAMPLE_SHARE``), and drops the rest
    unread: it does no work of its own between calls, and most calls'
    answers go back to the allocator as a user's would."""
    from hnsw_tpu_torch.ops import graph_search as k5_counters
    launches0 = k5_counters.launches
    plain0 = sum(k5_counters.plain_on_cuda.values())
    calls: List = []
    lat: List[float] = []
    queries = 0
    keep = (np.random.default_rng([int(s.seed) % (1 << 63), 3])
            .random(_MAX_CALLS) < SAMPLE_SHARE)
    keep[:len(s.batches)] = True

    def span(name: str):
        return (torch.profiler.record_function(name) if traced
                else contextlib.nullcontext())

    def loop() -> float:
        nonlocal queries
        t_start = time.perf_counter()
        i = 0
        while True:
            b = i % len(s.batches)
            t0 = time.perf_counter()
            with span(tracing.CALL):
                d, ids = _search(s, s.batches[b])
            lat.append(time.perf_counter() - t0)
            queries += len(ids)
            with span(tracing.CLIENT):
                calls.append((b, d, ids) if i >= _MAX_CALLS or keep[i]
                             else (b, None, None))
                del d, ids
            i += 1
            elapsed = time.perf_counter() - t_start
            if elapsed >= seconds:
                return elapsed

    path = None
    if traced:
        fd, path = tempfile.mkstemp(prefix="portbench_", suffix=".json")
        os.close(fd)
        with tracing.device_trace(path), span(tracing.WINDOW):
            window_s = loop()
    else:
        window_s = loop()
    return Window(calls, lat, queries, window_s, path,
                  k5_counters.launches - launches0,
                  sum(k5_counters.plain_on_cuda.values()) - plain0)


def graph_arrays(s: Session) -> reference.GraphArrays:
    """The built graph's public host arrays, copied onto the run's device
    for the reference."""
    cfg, n = s.graph.cfg, s.rows.shape[0]
    nb, levels, entry, _ = s.graph.host.arrays()
    widths = [cfg.m_base] + [cfg.m] * (nb.shape[0] - 1)
    return reference.GraphArrays(
        [torch.from_numpy(np.array(nb[layer, :n])).to(s.dev)
         for layer in range(nb.shape[0])], widths,
        torch.from_numpy(np.array(levels[:n])).to(s.dev), int(entry))


def judge(s: Session, w: Window, graph: reference.GraphArrays,
          counted: bool) -> Tuple[Dict[str, float], float, int, Dict]:
    """(the numbers compared, recall@10 over the answers the client kept,
    the queries whose answers are invalid, and with ``counted`` the work
    of one batch's search for the K5 roofline: the reference's walk of a
    batch drawn from the seed). The exact top k and the reference's walk
    of every pool query are worked out once a session."""
    conf, traffic = s.cell.config, s.cell.traffic
    metric, k, ef = conf["metric"], int(traffic["k"]), int(traffic["ef"])
    n = s.rows.shape[0]
    rows_t = torch.from_numpy(s.rows).to(s.dev)
    pool_t = torch.from_numpy(s.pool).to(s.dev)
    if s.truth is None:
        s.truth = reference.exact_topk(rows_t, pool_t, k,
                                       metric)[1].cpu().numpy()

    expand = int(conf["search"]["expand"])
    walk = dict(metric=metric, k=k, ef=ef,
                ef_upper=int(conf["search"]["ef_upper"]), expand=expand,
                max_hops=max(int(conf["search"]["max_hops"]),
                             -(-2 * max(ef, k) // expand)))
    rows_p = reference.prepare(rows_t, metric)
    if s.walked is None:
        s.walked = np.concatenate([
            reference.walk(graph, rows_p, pool_t[c0:c0 + _WALK_CHUNK],
                           **walk)[1].cpu().numpy()
            for c0 in range(0, len(s.pool), _WALK_CHUNK)])

    hits = bad_rows = misses = judged = 0
    err = 0.0
    first: Dict[int, tuple] = {}   # batch -> (answers, their readings)
    for b, d, ids in w.calls:
        if d is None:
            continue
        f = first.get(b)
        if f is not None and np.array_equal(f[0][1], ids) \
                and np.array_equal(f[0][0], d):
            h, bad, e, miss = f[1]
        else:
            ix = s.batch_idx[b]
            h = stats.hits(ids, s.truth[ix])
            bad = int(check.invalid_rows(d, ids, n).sum())
            e = check.dist_err(rows_t, pool_t[torch.as_tensor(ix)], d, ids,
                               metric)
            miss = check.walk_misses(ids, s.walked[ix])
            first.setdefault(b, ((d, ids), (h, bad, e, miss)))
        judged += len(ids)
        hits += h
        bad_rows += bad
        err = max(err, e)
        misses += miss
    recall = hits / (judged * k)
    numbers = {"invalid_answers": bad_rows, "dist_err": err,
               "walk_diff": misses / (judged * k),
               "recall_miss": 1.0 - recall,
               "graph_faults": reference.graph_faults(graph)}
    extra = {}
    if counted:
        rng = np.random.default_rng([int(s.seed) % (1 << 63), 2])
        b = int(rng.integers(len(s.batch_idx)))
        ix = torch.as_tensor(s.batch_idx[b])
        counts: Dict = {}
        reference.walk(graph, rows_p, pool_t[ix], counts=counts, **walk)
        d_ = s.rows.shape[1]
        layers = [(wd, nodes, r, sc, 4 * d_, "fp32")
                  for wd, nodes, r, sc in counts["layers"]]
        top = layers[0]
        layers[0] = (top[0], top[1], top[2] + counts["entry_rows"],
                     top[3] + counts["entry_scored"], top[4], top[5])
        bound_s, bound_by = roofline.search_bound_s(len(ix), d_, k, 1,
                                                    layers)
        extra = dict(bound_batch=b, bound_s=bound_s, bound_by=bound_by)
        _log(f"roofline: batch {b}: {bound_s * 1e3:.6f} ms bound by "
             f"{bound_by}; layers top first (width, nodes, rows, scored) "
             f"{counts['layers']}")
    return numbers, recall, bad_rows, extra


def read_per_layer(cell: cells.Cell, ctx: Dict, root: str) -> Dict:
    """The cell's per-layer metrics from the traced window's ``ctx``; a
    metric that the cell lists and whose reader finds nothing is a fault
    of the run (NotRunnable), never a metric left out."""
    metrics = {}
    for m in cell.per_layer:
        v = cells.reader(m["name"], root)(ctx)
        if v is None:
            raise NotRunnable(f"{cell.name} lists the per-layer metric "
                              f"{m['name']}, and its reader found nothing")
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def run(name: str, seed: int, seconds: float, traced: bool, *,
        root: str = cells.ROOT, device: str = "cuda",
        require_card: bool = True,
        prepare: Optional[Callable] = None,
        graph_kw: Optional[dict] = None) -> Dict:
    """One run of the cell ``name``; returns the result's JSON object.
    ``require_card=False`` and ``device`` run it elsewhere (the tests, on
    the CPU); ``prepare(graph)`` is called once the graph is built (the
    tests turn the program's lower precision on there) and ``graph_kw``
    overrides the graph's configuration (the tests' build faults)."""
    cell = cells.load(name, root)
    if require_card and not (torch.cuda.is_available()
                             and torch.cuda.device_count() >= cell.chips):
        raise NotRunnable(
            f"{name} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
    dev = torch.device(device)
    s = set_up(cell, seed, dev, prepare, graph_kw)
    s.setup_s = time.perf_counter() - _T0
    w = measure(s, seconds, traced)
    memory_peak = (int(torch.cuda.max_memory_allocated(dev))
                   if dev.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise NotRunnable(f"forbidden modules loaded: {', '.join(found)}")
    _log(f"window: {len(w.calls)} calls, {w.queries} queries in "
         f"{w.window_s:.3f} s; K5 launches {w.k5_launches}, plain searches "
         f"on the card {w.plain}")
    if dev.type == "cuda" and w.k5_fault():
        raise NotRunnable(f"not the cell's path: {w.k5_fault()}")

    # the program's state goes before the reference runs
    graph = graph_arrays(s)
    s.graph = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, recall, failed, extra = judge(s, w, graph, traced)
    _log(f"reference: {time.perf_counter() - t:.3f} s")
    correct, checks, lines = check.judge(numbers, cell.limits)

    n = s.rows.shape[0]
    e2e = {"qps": stats.qps(w.queries, w.window_s),
           "p95_ms": stats.p95_ms(w.lat), "recall_at_10": recall,
           "setup_s": s.setup_s}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": w.queries, "failed": failed}
    if traced:
        tr = tracing.load(w.trace_path)
        tracing.remove(w.trace_path)
        ctx = dict(trace=tr, calls=len(w.calls), queries=w.queries,
                   call_batches=[c[0] for c in w.calls], rows=n,
                   build_s=s.build_s, **extra)
        metrics = read_per_layer(cell, ctx, root)
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        result.update(metrics=metrics, device=device_info,
                      breakdown={"device_ops": tr.device_ops(),
                                 "idle_gaps": tr.idle_gaps()})
        _log(f"trace: {len(tr.kernels('graph_search_kernel'))} "
             f"graph_search_kernel launches for {len(w.calls)} calls, "
             f"busy {tr.busy_s():.6f} of {tr.window_s:.6f} s")
    else:
        result.update(metrics={m["name"]: {"value": e2e[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell.end_to_end},
                      device=device_info)
    result["checks"] = {n_: {"value": _finite(r["value"]),
                             "limit": r["limit"]}
                        for n_, r in checks.items()}
    for line in lines:
        _log(line)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one host thread for the program's small host-side operations: a
    # pool of threads woken for each of them adds milliseconds of jitter
    torch.set_num_threads(HOST_THREADS)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    except NotRunnable as e:
        _log(f"portbench: {e}")
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
