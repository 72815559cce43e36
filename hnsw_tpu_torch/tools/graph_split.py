#!/usr/bin/env python3
"""Where a launch of K5, the whole-search graph kernel, spends its time,
on one NVIDIA GPU.

    python3 -m hnsw_tpu_torch.tools.graph_split [--out DIR] [--parent ROOT]
        [--reps N] [--runs N] [--rows N] [--cell NAME] [--batch N]
        [--cases LIST] [--resident LIST]

Builds ``csrc/beam_search.cu`` as the port ships it and with
``-DGRAPH_PHASE_CLOCKS``, where thread 0 of each block adds the
``clock64()`` cycles of each phase (``PHASES``: K2's hop phases, with a
layer's set-up in place of K2's empty "same-hop dedup") into one row of
counters a group (``GROUPS``: the entries, the upper layers, layer 0, the
rerank), beside the rows each group scored. Then it serves the smoke's
graph tier (100,000 x 128 Gaussian rows, seed 1, m=16,
ef_construction=100, cosine, native builder; built once into ``--out``)
and captures the ``core/search.search_graph`` call of each case
(``CASES``: the default mode at ef 64 and 192, bench's mode at ef 192:
``fast_math``, int8 neighbour blocks, pivot seeds). For each case it
prints:

* one call through the wrapper (an event pair, as the smoke times it) and
  the launch (``B2B`` calls back to back between two events, divided:
  the host's time between calls hides under the card's), median of
  ``--reps``;
* each group's and phase's cycles in the slowest block (most cycles in
  all) and in the mean block, each group's hops and cycles a hop in the
  slowest block, and the rows each group scores a query;
* the request rate: the bytes of every row scored (no reuse across
  queries) over the launch's time, beside the card's 3.35 TB/s;
* the reuse probe: the same search on a batch of 1,024 queries made of 8
  distinct ones repeated, so that every block does one of 8 walks and
  nearly every row it reads is in L2. The cycles a hop of its slowest
  block against the random batch's: the gap is the time a hop waits on
  device memory.

It prints registers and spills of every K5 instantiation from ptxas's
report and each case's resident blocks an SM, and for the change the
rows a query of 64 queries by layer and the share of layer 0's rows
scored again in the layer (``measure_rescore``). With a parent, it
holds the two checkouts' outputs (distances, ids, hop counts by query
of every case) equal bit for bit (``same_outputs``). With ``--parent ROOT``
(another checkout, e.g. ``git archive <commit> | tar -x -C
.scratch/parent``) it builds that checkout's source too and runs parent,
change, change, parent, each a fresh process that imports its own
package (``--runs`` 3: parent, change, change, parent, parent, change);
a source without ``GRAPH_PHASE_CLOCKS`` gives times and no split.

``--rows N`` serves, in place of phase 5's graph, the graph of the
benchmark's cell ``ROWS_CELL`` with N rows (``rows_graph``: the cell's
own set-up, ``portbench.run.set_up``, draws the SIFT-shaped rows from its
configuration's generator and builds them on the card with the wave
builder; the cell's search: L2, ``search_expand`` 4, ``max_hops`` 128),
once, into ``--out``; at 1M rows layer 0 does not sit in L2. ``--cell
NAME`` serves another cell's graph the same way (its configuration's
generator, width, metric and graph), at its configuration's own rows
unless ``--rows`` gives a count (e.g. ``--cell dbpedia1536-cos.b8192.ef64``:
990,000 x 1,536 cosine rows). ``--batch``
queries a batch (default 1,024; the benchmark's cells take 8,192),
``--cases`` a comma-separated list of cases: ``CASES``' modes, and
"fp16" (``hbm_mode="float16"``: fp16 rows on every layer), at any ef.
``--resident 2,4,6,8`` is the residency probe: each case's launch again
through a build of the source with ``-DGRAPH_RESIDENCY_PAD``, whose
blocks take as much more dynamic shared memory (``graph_search_set_pad``)
as leaves only N blocks an SM (``resident_pad``): µs a query at each N,
and the occupancy API's count (a source without the macro, such as an
older parent, is not probed). Needs nvcc and a CUDA card; raises without
one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

#: the clocked build's macro and its counter groups (csrc/beam_search.cu
#: G_*), in order
CLOCKS = "GRAPH_PHASE_CLOCKS"
#: the residency probe's build: K5 blocks padded by graph_search_set_pad
PAD = "GRAPH_RESIDENCY_PAD"
GROUPS = ("entries", "upper layers", "layer 0", "rerank")
#: the phases of csrc/beam_search.cu PH_*, as K5's clocked build counts
#: them (PH_DEDUP holds a layer's set-up: pool init and hand-off)
PHASES = ("select", "gather + in-pool mask", "set-up", "list", "score",
          "rank", "merge", "compact")
CASES = ("default ef=64", "default ef=192", "bench ef=192")
#: the benchmark cell whose graph --rows serves (at another row count)
ROWS_CELL = "sift1m-l2.b8192.ef64"
BENCH = dict(fast_math=True, block_layout=True, block_dtype="int8",
             entry_mode="pivots")
#: each case's serving attributes by its mode (a case is "<mode> ef=<n>")
MODES = {"default": {}, "bench": BENCH, "fp16": dict(hbm_mode="float16")}
#: distinct queries of the reuse probe's batch
N_DISTINCT = 8
#: calls back to back a timed rep of the launch
B2B = 20
HBM_BYTES_S = 3.35e12
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def reuse_queries(queries: np.ndarray, n_distinct: int = N_DISTINCT
                  ) -> np.ndarray:
    """A batch as long as ``queries`` made of its first ``n_distinct``
    rows repeated in turn."""
    return np.ascontiguousarray(
        queries[np.arange(len(queries)) % n_distinct])


def group_report(clocks: np.ndarray, hops: np.ndarray, n_up: int,
                 clock_khz: Optional[float] = None) -> dict:
    """The split of one clocked launch. ``clocks`` [B, len(GROUPS),
    len(PHASES) + 1]: each block's cycles by group and phase, then the rows
    the group scored; ``hops`` [n_up + 1, B] each layer's hop count (the
    top layer first). Returns the slowest block (most cycles in all), its
    cycles by group and phase, the mean block's, each group's share of the
    slowest block's cycles, the slowest block's hops and cycles a hop by
    group (entries and rerank: none), the mean rows a query by group, and,
    given the SM clock in kHz, the slowest block's µs in all."""
    clocks = np.asarray(clocks, dtype=np.int64)
    hops = np.asarray(hops, dtype=np.int64).reshape(n_up + 1, -1)
    cyc = clocks[:, :, :len(PHASES)]
    rows = clocks[:, :, len(PHASES)]
    total = cyc.sum(axis=(1, 2))
    slow = int(np.argmax(total))
    hop_by_group = {"upper layers": int(hops[:n_up, slow].sum()),
                    "layer 0": int(hops[n_up, slow])}
    rep = {"slowest_block": slow, "slowest_cycles": int(total[slow]),
           "mean_cycles": float(total.mean()), "groups": {}}
    for gi, name in enumerate(GROUPS):
        g_cyc = int(cyc[slow, gi].sum())
        h = hop_by_group.get(name)
        rep["groups"][name] = {
            "slowest": dict(zip(PHASES, cyc[slow, gi].tolist())),
            "mean": dict(zip(PHASES, cyc[:, gi].mean(axis=0).tolist())),
            "cycles": g_cyc,
            "share": g_cyc / max(1, int(total[slow])),
            "mean_cycles": float(cyc[:, gi].sum(axis=1).mean()),
            "hops": h,
            "cycles_per_hop": (g_cyc / h if h else None),
            "rows_per_query": float(rows[:, gi].mean()),
            "rows": int(rows[:, gi].sum())}
    if clock_khz:
        rep["slowest_us"] = int(total[slow]) / clock_khz * 1e3
    return rep


def request_rate(rows_by_group: Dict[str, int],
                 row_bytes_by_group: Dict[str, int], launch_ms: float
                 ) -> dict:
    """The bytes of every row the launch scored (each group's rows times
    its row's bytes, read again for every query that scores it) over its
    time: bytes, bytes/s and that rate's share of the HBM's 3.35 TB/s."""
    nbytes = sum(rows_by_group[g] * row_bytes_by_group[g]
                 for g in rows_by_group)
    rate = nbytes / (launch_ms * 1e-3) if launch_ms > 0 else 0.0
    return {"bytes": int(nbytes), "bytes_s": rate,
            "share_of_hbm": rate / HBM_BYTES_S}


def format_report(label: str, rep: dict) -> List[str]:
    lines = [f"  {label}: slowest block {rep['slowest_block']} "
             f"{rep['slowest_cycles']} cycles"
             + (f" ({rep['slowest_us']:.1f} us)" if "slowest_us" in rep
                else "")
             + f", mean block {rep['mean_cycles']:.0f}"]
    for name, g in rep["groups"].items():
        phases = ", ".join(f"{k} {v}" for k, v in g["slowest"].items() if v)
        mean = ", ".join(f"{k} {v:.0f}" for k, v in g["mean"].items() if v)
        hop = (f"; {g['hops']} hops, {g['cycles_per_hop']:.0f} cycles a hop"
               if g["hops"] else "")
        lines.append(f"    {name}: {g['share']:.3f} of the slowest block "
                     f"({g['cycles']} cycles{hop}); rows a query "
                     f"{g['rows_per_query']:.1f}; slowest: {phases}; mean "
                     f"block: {mean}")
    return lines


def row_bytes(dg, plan: dict, rerank_dtype_bytes: int) -> Dict[str, int]:
    """Bytes of one scored row by group: the row (and its squared norm;
    the int8 rows their scale too), or the neighbour block's row."""
    D = dg.dim

    def of(mode):
        if mode == "blocks":
            return D * dg.nbr_blocks.element_size()
        return {"rows": 4 * D + 4, "qrows": D + 8, "f16rows": 2 * D + 4,
                "bf16rows": 2 * D + 4}[mode]

    return {"entries": of(plan["mode_up"]),
            "upper layers": of(plan["mode_up"]),
            "layer 0": of(plan["mode0"]),
            "rerank": rerank_dtype_bytes * D + 4}


def rows_graph(n: int, seed: int = 1, cell: str = ROWS_CELL):
    """The --rows / --cell graph: the benchmark cell ``cell``'s
    configuration with ``n`` rows (0: the configuration's own), drawn and
    built on the card by the cell's own set-up (``portbench.run.set_up``:
    its generator, graph configuration and wave builder). Returns (the
    Graph, the query pool [n_pool, D] float32, the rows in slot order)."""
    import dataclasses

    import torch
    from portbench import cells, run
    c = cells.load(cell, _ROOT)
    if n:
        c = dataclasses.replace(c, config=dict(c.config, rows=int(n)))
    s = run.set_up(c, seed, torch.device("cuda"))
    return s.graph, s.pool, s.rows


def prepare_rows_graph(path: str, n: int, cell: str = ROWS_CELL) -> None:
    """``rows_graph(n, cell=cell)`` saved with its configuration, rows and
    query pool to ``path`` (npz), for every checkout's worker to serve."""
    import dataclasses
    g, pool, rows = rows_graph(n, cell=cell)
    nb, levels, entry, top = g.host.arrays()
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, n=g.slots.capacity_used, neighbors=nb, levels=levels,
             entry=entry, top=top, rows=rows, queries=pool,
             config=json.dumps(dataclasses.asdict(g.cfg)))
    os.replace(tmp, path)


def load_rows_graph(path: str):
    """The Graph saved by ``prepare_rows_graph`` on the card, and its
    queries."""
    from hnsw_tpu_torch.config import GraphConfig
    from hnsw_tpu_torch.convert import graph_from_host_arrays
    z = np.load(path)
    n = int(z["n"])
    g = graph_from_host_arrays(GraphConfig(**json.loads(str(z["config"]))),
                               list(range(n)), z["rows"][:n],
                               np.ones(n, bool), z["neighbors"],
                               z["levels"], int(z["entry"]), int(z["top"]),
                               device="cuda")
    g.native_serve_max_batch = 0
    return g, z["queries"]


#: an H100 SM as the occupancy API counts it: shared memory (228 KB), the
#: reserve each block takes, the unit it is allocated in, and K5's static
#: shared memory a block (k5_ref)
SM_SMEM, BLOCK_RESERVED_SMEM, SMEM_UNIT, STATIC_SMEM = 233_472, 1_024, 128, 16


def resident_pad(smem: int, blocks: int) -> int:
    """Bytes to add to a block's ``smem`` bytes of dynamic shared memory
    so that just ``blocks`` blocks fit an H100 SM by shared memory (228
    KB, a block's static bytes and reserve, in 128-byte units): the
    residency probe's cap."""
    per_block = (SM_SMEM // blocks) // SMEM_UNIT * SMEM_UNIT
    return max(0, per_block - BLOCK_RESERVED_SMEM - STATIC_SMEM - smem)


def pad_library(path: str):
    """The residency probe's build (``PAD``) at ``path``, bound, with its
    setter typed."""
    import ctypes

    from hnsw_tpu_torch.ops import beam_search as bs
    lib = bs.bind(path)
    lib.graph_search_set_pad.argtypes = [ctypes.c_int]
    lib.graph_search_set_pad.restype = None
    return lib


def clocks_library(build_dir: str, source: Optional[str] = None):
    """The clocked build of ``source`` (default the port's kernel) in
    ``build_dir`` (built if missing), bound, with its counter entry points
    typed."""
    import ctypes

    from hnsw_tpu_torch.ops import beam_search as bs
    lib = bs.bind(bs.build((CLOCKS,), build_dir, source))
    lib.graph_search_set_clocks.argtypes = [ctypes.c_void_p]
    lib.graph_search_set_clocks.restype = None
    lib.graph_search_clock_cols.restype = ctypes.c_int
    return lib


def split_case(lib, clib, c: dict, launch_ms: float) -> dict:
    """One captured search's split through the clocked library ``clib``
    (``group_report``), its request rate at ``launch_ms`` and the most hops
    a query took; ``lib`` gives the SM clock."""
    plan = _plan(c)
    cyc, hops = _clocked(clib, c)
    rep = group_report(cyc, hops, hops.shape[0] - 1,
                       lib.beam_search_clock_khz())
    rep["request"] = request_rate(
        {k: v["rows"] for k, v in rep["groups"].items()},
        row_bytes(c["g"], plan, c["g"].vectors.element_size()), launch_ms)
    rep["max_hops"] = int(hops.sum(axis=0).max())
    return rep


def rescore_share(per_query: Sequence[Sequence[Sequence]]) -> dict:
    """How often a layer scores a row again. ``per_query``: for each query,
    each layer searched (the top first, layer 0 last), the rows each hop
    scored (``search_graph_reference``'s ``touched``). A hop's copies of a
    row count once, as the kernel drops them. Returns the rows a query
    scores in layer 0 and in the upper layers, the distinct rows of each
    layer summed, and the share of layer 0's rows scored earlier in the
    layer."""
    n = max(1, len(per_query))
    rows0 = distinct0 = rows_up = distinct_up = 0
    for layers in per_query:
        for li, hops in enumerate(layers):
            seen, total = set(), 0
            for h in hops:
                hop = {int(x) for x in np.asarray(h).ravel()}
                total += len(hop)
                seen |= hop
            if li == len(layers) - 1:
                rows0 += total
                distinct0 += len(seen)
            else:
                rows_up += total
                distinct_up += len(seen)
    return {"layer0_rows": rows0 / n, "layer0_distinct": distinct0 / n,
            "layer0_rescored": 1.0 - distinct0 / max(1, rows0),
            "upper_rows": rows_up / n, "upper_distinct": distinct_up / n}


def same_outputs(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]
                 ) -> Dict[str, bool]:
    """For each array both runs saved (a case's distances, ids or hop
    counts), whether the two are equal bit for bit (distances compared as
    their bits)."""
    out = {}
    for k in sorted(set(a) & set(b)):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        out[k] = x.shape == y.shape and bool(np.array_equal(x, y))
    return out


def measure_rescore(c: dict, n: int = 64) -> dict:
    """``rescore_share`` of a captured search's first ``n`` queries, one at
    a time through the plain version over K2's twin (its ``touched``)."""
    from hnsw_tpu_torch.core import search
    from hnsw_tpu_torch.ops import graph_search as gs
    kw = dict(c["kw"])
    seeds = kw.pop("seed_ids", None)
    per_query = []
    with gs.plain(twin=True):
        for i in range(min(n, len(c["q"]))):
            touched = []
            search.search_graph_reference(
                c["g"], c["q"][i:i + 1], touched=touched,
                seed_ids=None if seeds is None else seeds[i:i + 1], **kw)
            n_layers = 1 if seeds is not None else c["g"].num_layers
            per_query.append([[r.cpu().numpy() for r in t.get("rows", [])]
                              for t in touched[:n_layers]])
    return rescore_share(per_query)


# ---- one checkout's worker (a fresh process with its package on the path)


def _search_trace():
    """This checkout's ``tools/search_trace`` (its graph cache), loaded
    from its file whichever package the worker imports."""
    spec = importlib.util.spec_from_file_location(
        "_graph_split_trace",
        os.path.join(_ROOT, "hnsw_tpu_torch", "tools", "search_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture(g, queries: np.ndarray, ef: int) -> dict:
    """The ``core/search.search_graph`` call that
    ``g.batch_search_slots(queries, 10, ef=ef)`` makes: {"g", "q", "kw"}
    (the stats argument left out)."""
    from hnsw_tpu_torch.index import hnsw
    seen = {}
    real = hnsw.search_graph

    def spy(dg, q, **kw):
        if not seen:
            seen.update(g=dg, q=q, kw={k: v for k, v in kw.items()
                                       if k != "stats"})
        return real(dg, q, **kw)

    hnsw.search_graph = spy
    try:
        g.batch_search_slots(queries, 10, ef=ef)
    finally:
        hnsw.search_graph = real
    return seen


def capture_cases(g, queries: np.ndarray,
                  labels: Sequence[str] = CASES) -> Dict[str, dict]:
    """Each case's captured search on ``g`` (its serving attributes left as
    they were)."""
    out = {}
    for label in labels:
        mode, ef = label.split(" ef=")
        attrs = MODES[mode]
        saved = {k: getattr(g, k) for k in attrs}
        for k, v in attrs.items():
            setattr(g, k, v)
        try:
            out[label] = capture(g, queries, int(ef))
        finally:
            for k, v in saved.items():
                setattr(g, k, v)
    return out


def _plan(c: dict) -> dict:
    from hnsw_tpu_torch.ops import graph_search as gs
    dg, q, kw = c["g"], c["q"], c["kw"]
    P0 = max(kw["ef"], kw["k"])
    P_up = kw.get("ef_upper", 0) or min(8, P0)
    seeds = kw.get("seed_ids")
    return gs.search_kernel_applies(
        dg, kw.get("metric", "cosine"), q, P0, P_up, kw.get("expand", 1),
        kw.get("merge", "sort"),
        None if seeds is None else int(seeds.shape[1]))


def _times(c: dict, reps: int) -> dict:
    import torch
    from hnsw_tpu_torch.core import search
    dg, q, kw = c["g"], c["q"], c["kw"]

    def call():
        return search.search_graph(dg, q, **kw)

    call()
    torch.cuda.synchronize()
    one, b2b = [], []
    for _ in range(reps):
        for n, out in ((1, one), (B2B, b2b)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                call()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / n)
    return {"call_ms": statistics.median(one),
            "launch_ms": statistics.median(b2b),
            "call_all": one, "launch_all": b2b}


def _clocked(lib, c: dict) -> tuple:
    """One launch through the clocked library: (clocks [B, G, P + 1],
    hops [L, B]) on the host."""
    import torch
    from hnsw_tpu_torch.core import search
    from hnsw_tpu_torch.ops import beam_search as bs
    B = len(c["q"])
    cols = lib.graph_search_clock_cols()
    buf = torch.zeros((B, cols), dtype=torch.int64, device=c["q"].device)
    saved = bs._lib
    bs._lib = lib
    lib.graph_search_set_clocks(buf.data_ptr())
    try:
        st = {}
        search.results_to_host(*search.search_graph(c["g"], c["q"],
                                                    stats=st, **c["kw"]), st)
        torch.cuda.synchronize()
    finally:
        lib.graph_search_set_clocks(None)
        bs._lib = saved
    return (buf.cpu().numpy().reshape(B, len(GROUPS), len(PHASES) + 1),
            np.asarray(st["hops_by_query"]))


def resident_probe(plib, c: dict, s0: int, su: int, blocks: Sequence[int],
                   reps: int) -> List[dict]:
    """The residency probe of one captured search: its launch through the
    padded build ``plib`` (``pad_library``) at each count of ``blocks`` an
    SM (``resident_pad``), with the occupancy API's count beside it, and
    µs a query."""
    from hnsw_tpu_torch.ops import beam_search as bs
    smem = _plan(c)["smem"]
    out = []
    saved = bs._lib
    bs._lib = plib
    try:
        for n in blocks:
            pad = resident_pad(smem, n)
            plib.graph_search_set_pad(pad)
            t = _times(c, reps)
            api = plib.graph_search_blocks_per_sm(s0, su, 1, smem + pad)
            out.append({"blocks": n, "pad": pad, "api_blocks": int(api),
                        "launch_ms": t["launch_ms"],
                        "us_per_query": t["launch_ms"] * 1e3 / len(c["q"])})
    finally:
        plib.graph_search_set_pad(0)
        bs._lib = saved
    return out


def worker(out: str, lib_path: str, clocks_path: Optional[str],
           reps: int, rescore: bool = False, tag: str = "run",
           graph: Optional[str] = None, batch: Optional[int] = None,
           cases: Sequence[str] = CASES, resident: Sequence[int] = (),
           pad_path: Optional[str] = None) -> dict:
    """One checkout's numbers (its package on ``sys.path``, its library
    built at ``lib_path``, its clocked build, if any, at ``clocks_path``;
    with ``rescore`` also ``measure_rescore`` on the random batch). The
    graph: phase 5's, or the --rows graph saved at ``graph``; ``batch``
    queries of it. ``resident``: the residency probe's counts of blocks an
    SM (``resident_probe``, through the padded build at ``pad_path``).
    Each case's outputs (distances, ids, hop counts by query) go to
    ``out/outputs_<tag>.npz``."""
    import torch
    from hnsw_tpu_torch.ops import beam_search as bs
    from hnsw_tpu_torch.ops import graph_search as gs
    bs._lib = bs.bind(lib_path)
    clib = None
    if clocks_path:
        clib = clocks_library(os.path.dirname(clocks_path))
    khz = bs._lib.beam_search_clock_khz()
    plib = pad_library(pad_path) if resident and pad_path else None
    if graph:
        g, queries = load_rows_graph(graph)
    else:
        g, queries, _ = _search_trace()._graph(os.path.join(out,
                                                            "graph.npz"))
    if batch:
        queries = queries[:batch]
    res = {"device": torch.cuda.get_device_name(0), "clock_khz": khz}
    outputs = {}
    for name, qs in (("random", queries), ("reuse", reuse_queries(queries))):
        for label, c in capture_cases(g, qs, cases).items():
            key = f"{name} {label}"
            res[key] = _case(c, reps, clib, key, outputs,
                             rescore and name == "random")
            if plib is not None and name == "random":
                s0, su = res[key]["instantiation"]
                res[key]["resident"] = resident_probe(plib, c, s0, su,
                                                      resident, reps)
            torch.cuda.synchronize()
    np.savez(os.path.join(out, f"outputs_{tag}.npz"), **outputs)
    return res


def _case(c: dict, reps: int, clib, key: str, outputs: dict,
          rescore: bool) -> dict:
    """One captured search's times, outputs (into ``outputs`` under
    ``key``), resident blocks an SM, split and, with ``rescore``, rows
    scored again."""
    from hnsw_tpu_torch.core import search
    from hnsw_tpu_torch.ops import beam_search as bs
    from hnsw_tpu_torch.ops import graph_search as gs
    plan = _plan(c)
    if plan is None:
        raise RuntimeError(f"{key}: K5 does not take the search")
    r = dict(_times(c, reps), plan={k: v for k, v in plan.items()
                                    if isinstance(v, (int, str))})
    st = {}
    d, i = search.results_to_host(
        *search.search_graph(c["g"], c["q"], stats=st, **c["kw"]), st)
    outputs.update({f"{key} dists": d, f"{key} ids": i,
                    f"{key} hops": np.asarray(st["hops_by_query"])})
    lib = gs._load()
    precision = "default" if c["kw"].get("fast_math") else "highest"
    s0 = bs.score_code(c["g"], plan["mode0"], precision)
    su = bs.score_code(c["g"], plan["mode_up"], precision)
    r["blocks_per_sm"] = int(lib.graph_search_blocks_per_sm(s0, su, 1,
                                                            plan["smem"]))
    r["instantiation"] = (s0, su)
    if clib is not None:
        r["split"] = split_case(bs._lib, clib, c, r["launch_ms"])
    if rescore:
        r["rescore"] = measure_rescore(c)
    return r


# ---- the main process ------------------------------------------------------


def build_all(out: str, sources: Dict[str, str],
              pad: bool = False) -> Dict[str, str]:
    """Each source (name -> beam_search.cu) as shipped, with
    ``GRAPH_PHASE_CLOCKS`` where the source has it and, with ``pad``, with
    ``GRAPH_RESIDENCY_PAD`` where it has that, every nvcc at once, into
    ``out/<name>``, ``out/<name>_clocks`` and ``out/<name>_pad``. Returns
    {dir name: library path}."""
    from hnsw_tpu_torch.ops import beam_search as bs
    jobs = {}
    for name, src in sources.items():
        jobs[name] = (src, ())
        with open(src) as f:
            text = f.read()
        if CLOCKS in text:
            jobs[f"{name}_clocks"] = (src, (CLOCKS,))
        if pad and PAD in text:
            jobs[f"{name}_pad"] = (src, (PAD,))
    paths, errors = {}, []

    def one(key):
        src, defines = jobs[key]
        try:
            paths[key] = bs.build(defines, os.path.join(out, key), src)
        except Exception as e:          # raised below, all together
            errors.append(f"{key}: {e}")

    threads = [threading.Thread(target=one, args=(k,)) for k in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("; ".join(errors))
    return paths


def _run(root: str, args, lib: str, clocks: Optional[str],
         rescore: bool = False, tag: str = "run",
         pad: Optional[str] = None) -> dict:
    """``worker`` in a fresh process that imports ``root``'s package."""
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           "--out", args.out, "--reps", str(args.reps), "--lib", lib,
           "--tag", tag, "--cases", args.cases]
    if pad and args.resident:
        cmd += ["--resident", args.resident, "--pad-lib", pad]
    if args.graph:
        cmd += ["--graph", args.graph]
    if args.batch:
        cmd += ["--batch", str(args.batch)]
    if clocks:
        cmd += ["--clocks-lib", clocks]
    if rescore:
        cmd += ["--rescore"]
    res = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=1800)
    if res.returncode != 0:
        raise RuntimeError(f"graph_split worker in {root} failed:\n"
                           f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def print_ptxas(build_dir: str, label: str) -> Dict[str, dict]:
    """Every instantiation's registers and spills (K5's and K2's) in
    ``build_dir``'s ptxas report."""
    from hnsw_tpu_torch.tools.hop_split import parse_ptxas
    with open(os.path.join(build_dir, "beam_search.ptxas.txt")) as f:
        regs = parse_ptxas(f.read())
    print(f"  ptxas, {label}: " + "; ".join(
        f"{k} {v.get('registers')} registers, "
        f"{v.get('spill_stores', 0)}/{v.get('spill_loads', 0)} B spill "
        f"stores/loads" for k, v in sorted(regs.items())), flush=True)
    return regs


def report(runs: List[tuple]) -> None:
    keys = [k for k in runs[0][1] if k not in ("device", "clock_khz")]
    for key in keys:
        print(f"# {key}", flush=True)
        for i, (name, r) in enumerate(runs):
            c = r[key]
            line = (f"  {name} (run {i + 1}): one call {c['call_ms']:.4f} ms"
                    f", launch {c['launch_ms']:.4f} ms (median of "
                    f"{len(c['call_all'])}; calls "
                    f"{', '.join(f'{t:.4f}' for t in c['call_all'])}; "
                    f"launches "
                    f"{', '.join(f'{t:.4f}' for t in c['launch_all'])}), "
                    f"{c['blocks_per_sm']} blocks an SM, plan {c['plan']}")
            print(line, flush=True)
            for x in c.get("resident", ()):
                print(f"    resident {x['blocks']} blocks an SM (pad "
                      f"{x['pad']} B; occupancy API {x['api_blocks']}): "
                      f"launch {x['launch_ms']:.4f} ms, "
                      f"{x['us_per_query']:.4f} us a query", flush=True)
            if "rescore" in c:
                x = c["rescore"]
                print(f"    rows a query (64 queries, the plain version): "
                      f"layer 0 {x['layer0_rows']:.1f} ({x['layer0_distinct']:.1f}"
                      f" distinct, {x['layer0_rescored']:.4f} scored again "
                      f"in the layer), upper layers {x['upper_rows']:.1f} "
                      f"({x['upper_distinct']:.1f} distinct)", flush=True)
            if "split" in c:
                s = c["split"]
                for ln in format_report(f"{name} split", s):
                    print(ln, flush=True)
                q = s["request"]
                print(f"    request rate {q['bytes_s'] / 1e12:.3f} TB/s "
                      f"({q['bytes'] / 1e9:.3f} GB of scored rows, "
                      f"{q['share_of_hbm']:.3f} of 3.35 TB/s; at 3.35 TB/s "
                      f"without reuse {q['bytes'] / HBM_BYTES_S * 1e3:.3f}"
                      f" ms); most hops of a query {s['max_hops']}",
                      flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout's root, run in turns")
    ap.add_argument("--out", default=os.path.join(_ROOT, "build",
                                                  "graph_split"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--runs", type=int, default=2,
                    help="fresh processes of each checkout, in turns")
    ap.add_argument("--rows", type=int, default=0,
                    help="serve the benchmark cell ROWS_CELL's graph at N "
                         "rows, built on the card (0: phase 5's graph)")
    ap.add_argument("--cell", default="",
                    help="serve this benchmark cell's graph (at its "
                         "configuration's rows unless --rows gives N)")
    ap.add_argument("--batch", type=int, default=0,
                    help="queries a batch (0: 1,024)")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated cases, '<mode> ef=<n>' (modes: "
                         "default, bench, fp16)")
    ap.add_argument("--resident", default="",
                    help="residency probe: blocks an SM, e.g. 2,4,6,8")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--prepare", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--graph", default="", help=argparse.SUPPRESS)
    ap.add_argument("--lib", help=argparse.SUPPRESS)
    ap.add_argument("--clocks-lib", help=argparse.SUPPRESS)
    ap.add_argument("--pad-lib", help=argparse.SUPPRESS)
    ap.add_argument("--rescore", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="run", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.out = os.path.abspath(args.out)
    cases = [c for c in args.cases.split(",") if c]
    resident = [int(n) for n in args.resident.split(",") if n]
    cell = args.cell or ROWS_CELL
    if args.prepare:
        prepare_rows_graph(args.graph, args.rows, cell)
        return 0
    if args.worker:
        print(json.dumps(worker(args.out, args.lib, args.clocks_lib,
                                args.reps, args.rescore, args.tag,
                                args.graph or None, args.batch or None,
                                cases, resident, args.pad_lib)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("graph_split needs a CUDA card: the kernel has "
                           "no CPU mode")
    os.makedirs(args.out, exist_ok=True)
    if args.rows or args.cell:
        args.graph = os.path.join(args.out,
                                  f"{cell}_{args.rows or 'all'}.npz")
        if not os.path.exists(args.graph):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--prepare",
                 "--out", args.out, "--graph", args.graph, "--rows",
                 str(args.rows), "--cell", cell],
                cwd=_ROOT, env=dict(os.environ, PYTHONPATH=_ROOT),
                capture_output=True, text=True, timeout=1800)
            if res.returncode != 0:
                raise RuntimeError(f"graph_split --rows / --cell build "
                                   f"failed:\n"
                                   f"{res.stderr[-4000:]}")
    roots = {"change": _ROOT}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    paths = build_all(args.out, {
        n: os.path.join(r, "hnsw_tpu_torch", "csrc", "beam_search.cu")
        for n, r in roots.items()}, pad=bool(args.resident))
    n_rows = args.rows or "its configuration's"
    print(f"# {torch.cuda.get_device_name(0)}; K5 split, "
          + (f"cell {cell}'s graph at {n_rows} rows"
             if args.graph else "phase 5's graph")
          + f", {args.batch or 1024} queries a batch", flush=True)
    for k in paths:
        print_ptxas(os.path.join(args.out, k), k)
    order = ((["parent", "change", "change", "parent"] * args.runs)[
        :2 * args.runs] if args.parent else ["change"] * max(
            1, args.runs // 2))
    runs = [(n, _run(roots[n], args, paths[n], paths.get(f"{n}_clocks"),
                     rescore=n == "change" and order.index(n) == i,
                     tag=f"{n}{i + 1}", pad=paths.get(f"{n}_pad")))
            for i, n in enumerate(order)]
    with open(os.path.join(args.out, "graph_split.json"), "w") as f:
        json.dump(runs, f)
    report(runs)
    if args.parent:
        # the first parent run's outputs against the first change run's
        p, c = (f"{n}{order.index(n) + 1}" for n in ("parent", "change"))
        eq = same_outputs(*(np.load(os.path.join(args.out,
                                                 f"outputs_{t}.npz"))
                            for t in (p, c)))
        print(f"# outputs equal bit for bit ({p} against {c}): "
              f"{sum(eq.values())} of {len(eq)} arrays; differ: "
              f"{[k for k, v in eq.items() if not v]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
