#!/usr/bin/env python3
"""Where a hop of K2, the graph beam-search kernel, spends its time, on
one NVIDIA GPU.

    python3 -m hnsw_tpu_torch.tools.hop_split [--out DIR] [--parent SRC]

Builds ``csrc/beam_search.cu`` twice into ``--out`` (default
build/hop_split): as the port ships it, and with ``-DBEAM_PHASE_CLOCKS``,
where thread 0 of each block adds up the ``clock64()`` cycles of each
phase of a hop (``PHASES``) into a [B, 8] int64 buffer. Then it builds
the default ``Graph`` of the smoke's graph tier (100,000 x 128 Gaussian
rows, seed 1, m=16, ef_construction=100, cosine, native builder) and
captures the layer-0 call of each of K2's smoke cases (``CASES``: 1,024
queries; f32 rows at ef 64 and 192, bench's mode with int8 and fp16
neighbour blocks at ef 192, the wave builder's DEFAULT/sort descent at
ef 100, and the capacity stores: ``hbm_mode="quantized"`` (int8 rows with
per-row scales) and ``hbm_mode="float16"`` with ``fast_math`` at ef 192,
``store_dtype="bfloat16"`` with ``fast_math`` (DEFAULT) at ef 64). For
each case it prints:

* the shipped kernel's ms (median of 5 CUDA-event reps) and its µs a
  hop: ms over the slowest query's hop count (the batch fits one wave,
  so the launch lasts as long as its slowest block);
* each phase's share of the slowest block's cycles (the block with the
  most cycles in all, in the clocked build) and those shares of the µs a
  hop;
* resident blocks an SM at the case's shared memory
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
* the twin's ms (``core/search.beam_search_layer_reference``).

It prints registers and spills of every instantiation from ptxas's
report. With ``--parent SRC`` (another beam_search.cu with the same C
interface and the same counters, e.g. the parent commit's kernel), it
builds that one too and times the two in turns on each case (parent,
change, change, parent), each with its split. Needs nvcc and a CUDA card;
raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import statistics
import sys
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hnsw_tpu_torch.ops import beam_search as bs
from hnsw_tpu_torch.tools.screen_split import cuda_ms

#: the kernel's phase counters, in the order of csrc/beam_search.cu PH_*
PHASES = ("select", "gather + in-pool mask", "same-hop dedup", "list",
          "score", "rank", "merge", "compact")
#: csrc/beam_search.cu S_*: scoring mode code -> name
SCORE_NAMES = {0: "f32", 1: "bf16", 2: "int8", 3: "fp16", 4: "qrows",
               5: "f16rows", 6: "bf16rows"}
#: the capacity stores' cases (the int8 capacity mode, fp16 and bf16 rows)
CAPACITY_CASES = ("int8 rows ef=192 (hbm_mode=quantized)",
                  "float16 rows ef=192 (hbm_mode=float16, fast_math)",
                  "bfloat16 rows ef=64 (store_dtype=bfloat16, fast_math)")
#: the smoke's K2 cases (chip_smoke.phase_beam_kernel) this tool runs
CASES = ("rows ef=64", "rows ef=192", "int8 blocks ef=192 (bench mode)",
         "float16 blocks ef=192 (bench mode)",
         "builder descent DEFAULT/sort ef=100") + CAPACITY_CASES
CLOCKS = "BEAM_PHASE_CLOCKS"
N_GRAPH, DIM, N_QUERIES = 100_000, 128, 1024


def parse_ptxas(text: str) -> Dict[str, dict]:
    """ptxas's ``-v`` report -> {"f32/vec": {"registers", "spill_stores",
    "spill_loads", "stack"}, ...}, one entry a beam_search_kernel
    instantiation (``SCORE_NAMES``, "vec" or "scalar" loads), and "K5
    int8+bf16/vec", ... one a graph_search_kernel instantiation (layer 0's
    mode, then the upper layers')."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            k = re.search(r"beam_search_kernelILi(\d)ELb([01])E", m.group(1))
            k5 = re.search(r"graph_search_kernelILi(\d)ELi(\d)ELb([01])E",
                           m.group(1))
            name = (f"{SCORE_NAMES[int(k.group(1))]}/"
                    f"{'vec' if k.group(2) == '1' else 'scalar'}" if k
                    else f"K5 {SCORE_NAMES[int(k5.group(1))]}+"
                    f"{SCORE_NAMES[int(k5.group(2))]}/"
                    f"{'vec' if k5.group(3) == '1' else 'scalar'}" if k5
                    else None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def phase_report(cycles: np.ndarray, hops: np.ndarray, kernel_ms: float,
                 clock_khz: Optional[float] = None) -> dict:
    """The split of one launch: ``cycles`` [B, len(PHASES)] from the
    clocked build, ``hops`` [B] its per-query hop counts, ``kernel_ms``
    the shipped build's time. Returns the slowest block (most cycles in
    all), its hop count, each phase's share of its cycles, the µs a hop
    (``kernel_ms`` over the largest hop count) and that split by phase,
    and, given the SM clock in kHz, the slowest block's own µs a hop."""
    cycles = np.asarray(cycles, dtype=np.int64)
    hops = np.asarray(hops)
    total = cycles.sum(axis=1)
    slow = int(np.argmax(total))
    shares = cycles[slow] / max(1, int(total[slow]))
    max_hops = int(hops.max()) if hops.size else 0
    us_hop = kernel_ms * 1e3 / max(1, max_hops)
    rep = {"slowest_block": slow, "slowest_hops": int(hops[slow]),
           "max_hops": max_hops, "us_per_hop": us_hop,
           "shares": dict(zip(PHASES, shares.tolist())),
           "us_per_hop_by_phase": dict(zip(PHASES,
                                           (shares * us_hop).tolist()))}
    if clock_khz:
        rep["clocked_us_per_hop"] = (
            int(total[slow]) / max(1, int(hops[slow])) / clock_khz * 1e3)
    return rep


def format_report(label: str, rep: dict) -> str:
    parts = ", ".join(f"{k} {v:.3f}" for k, v in rep["shares"].items())
    line = (f"  {label}: {rep['us_per_hop']:.2f} us a hop ({rep['max_hops']}"
            f" hops); slowest block {rep['slowest_block']} "
            f"({rep['slowest_hops']} hops), shares: {parts}")
    if "clocked_us_per_hop" in rep:
        line += (f"; clocked build {rep['clocked_us_per_hop']:.2f} us a hop "
                 f"in that block")
    return line


def build_variants(out: str, sources: Dict[str, str]) -> Dict[str, str]:
    """Builds each source (name -> beam_search.cu) as shipped and with
    ``BEAM_PHASE_CLOCKS``, every nvcc at once, into ``out/<name>`` and
    ``out/<name>_clocks``. Returns {dir name: library path}."""
    jobs = {}
    for name, src in sources.items():
        jobs[name] = (src, ())
        jobs[f"{name}_clocks"] = (src, (CLOCKS,))
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


def clocks_library(build_dir: str, source: Optional[str] = None):
    """The clocked build of ``source`` (default the port's kernel) in
    ``build_dir`` (built if missing), bound, with its counter entry points
    typed."""
    import ctypes
    lib = bs.bind(bs.build((CLOCKS,), build_dir, source))
    lib.beam_search_set_clocks.argtypes = [ctypes.c_void_p]
    lib.beam_search_set_clocks.restype = None
    lib.beam_search_phase_count.restype = ctypes.c_int
    return lib


@contextmanager
def using(lib):
    """``ops/beam_search.beam_search_cuda`` launches through ``lib`` inside
    the block (the launch counts are left as they were)."""
    saved = (bs._lib, bs.launches, dict(bs.launches_by_mode))
    bs._lib = lib
    try:
        yield
    finally:
        bs._lib, bs.launches = saved[0], saved[1]
        bs.launches_by_mode.update(saved[2])


def case_kwargs(case: dict) -> dict:
    """``beam_search_cuda``'s keywords of a captured layer-0 call (the
    builder leaves beam_search_layer's defaults in place)."""
    return dict(dict(expand=1, merge="sort", store_normalized=False),
                **{k: v for k, v in case["kw"].items() if k != "stats"})


def instantiation(case: dict) -> tuple:
    """(score code, vec) of the kernel instantiation a case launches, as
    ``beam_search_launch`` picks it (rows from a fresh allocation are
    aligned)."""
    g, kw = case["g"], case_kwargs(case)
    E = max(1, min(kw["expand"], kw["pool_size"]))
    mode = bs.layer_mode(g, 0, kw["metric"], kw["pool_size"], E,
                         kw["merge"])
    return bs.score_code(g, mode, kw["precision"]), int(g.dim % 4 == 0)


def case_smem(lib, case: dict) -> int:
    """Dynamic shared memory of one block of ``lib``'s kernel on a case
    (the library's own ``beam_search_smem_bytes``)."""
    g, kw = case["g"], case_kwargs(case)
    E = max(1, min(kw["expand"], kw["pool_size"]))
    if g.nbr_blocks is not None:
        M = min(g.layer_width(0), g.nbr_blocks.shape[1])
    else:
        M = g.layer_width(0)
    return int(lib.beam_search_smem_bytes(g.dim, kw["pool_size"], E, M,
                                          int(kw["merge"] == "sort")))


def launch(case: dict):
    return bs.beam_search_cuda(case["g"], 0, *case["args"],
                               **case_kwargs(case))


def clocked(lib, case: dict):
    """One launch of the clocked build: (cycles [B, 8], hops [B]) on the
    host."""
    B = len(case["args"][0])
    buf = torch.zeros((B, lib.beam_search_phase_count()), dtype=torch.int64,
                      device=case["args"][0].device)
    lib.beam_search_set_clocks(buf.data_ptr())
    try:
        with using(lib):
            _, _, hops, _ = launch(case)
        torch.cuda.synchronize()
    finally:
        lib.beam_search_set_clocks(None)
    return buf.cpu().numpy(), hops.cpu().numpy()


def occupancy(lib, case: dict) -> int:
    """Resident blocks an SM of ``lib``'s kernel on a case."""
    score, vec = instantiation(case)
    return int(lib.beam_search_blocks_per_sm(score, vec,
                                             case_smem(lib, case)))


def split_cases(cases: Dict[str, dict], lib, clock_lib,
                ms: Optional[Dict[str, float]] = None) -> Dict[str, dict]:
    """Each case's split through ``clock_lib`` beside ``lib``'s time (timed
    here unless ``ms`` gives it), with its resident blocks an SM; prints
    one line a case."""
    khz = lib.beam_search_clock_khz()
    out = {}
    for label, case in cases.items():
        if ms is not None and label in ms:
            t = ms[label]
        else:
            with using(lib):
                t = cuda_ms(lambda: launch(case))
        cyc, hops = clocked(clock_lib, case)
        rep = phase_report(cyc, hops, t, khz)
        rep.update(ms=t, blocks_per_sm=occupancy(lib, case),
                   smem_bytes=case_smem(lib, case))
        print(format_report(label, rep) + f"; {rep['blocks_per_sm']} blocks "
              f"an SM at {rep['smem_bytes']} B of shared memory", flush=True)
        out[label] = rep
    return out


def print_ptxas(build_dir: str, label: str) -> Dict[str, dict]:
    path = os.path.join(build_dir, "beam_search.ptxas.txt")
    with open(path) as f:
        regs = parse_ptxas(f.read())
    print(f"  ptxas, {label}: " + "; ".join(
        f"{k} {v.get('registers')} registers, "
        f"{v.get('spill_stores', 0)}/{v.get('spill_loads', 0)} B spill "
        f"stores/loads" for k, v in sorted(regs.items())), flush=True)
    return regs


def layer0_call(run, module) -> dict:
    """The arguments of the first layer-0 ``beam_search_layer`` call that
    ``run()`` makes through ``module`` (core/search for Graph,
    core/build for the builder's descent, core/build_device for its
    refine): {"g", "args", "kw"}, or {} if it made none."""
    seen = {}
    real = module.beam_search_layer

    def spy(dg, layer, *args, **kw):
        if layer == 0 and not seen:
            seen.update(g=dg, args=args, kw=kw)
        return real(dg, layer, *args, **kw)

    module.beam_search_layer = spy
    try:
        run()
    finally:
        module.beam_search_layer = real
    return seen


def capture_cases(g, queries: np.ndarray, base: np.ndarray,
                  labels: Sequence[str] = CASES) -> Dict[str, dict]:
    """The layer-0 call of each case's entry point on ``g`` (the smoke's
    graph tier Graph), as ``layer0_call`` returns it; the Graph's serving
    attributes are left as they were."""
    from hnsw_tpu_torch.core import build, search
    from hnsw_tpu_torch.ops import graph_search

    def graph_case(ef, store_dtype=None, **modes):
        saved = {k: getattr(g, k) for k in modes}
        cfg = g.cfg
        for k, v in modes.items():
            setattr(g, k, v)
        if store_dtype is not None:
            g.cfg = dataclasses.replace(cfg, store_dtype=store_dtype)
            g._dirty = True
        try:
            # the plain search composes one beam_search_layer a layer, so
            # its layer-0 call is the one K5 makes inside its launch
            with graph_search.plain():
                return layer0_call(
                    lambda: g.batch_search_slots(queries, 10, ef=ef), search)
        finally:
            for k, v in saved.items():
                setattr(g, k, v)
            if store_dtype is not None:
                g.cfg = cfg
                g._dirty = True

    bench = dict(fast_math=True, block_layout=True, entry_mode="pivots")
    make = {
        "rows ef=64": lambda: graph_case(64),
        "rows ef=192": lambda: graph_case(192),
        "int8 blocks ef=192 (bench mode)":
            lambda: graph_case(192, block_dtype="int8", **bench),
        "float16 blocks ef=192 (bench mode)":
            lambda: graph_case(192, block_dtype="float16", **bench),
        "builder descent DEFAULT/sort ef=100": lambda: descent(
            g.device_graph()),
        CAPACITY_CASES[0]: lambda: graph_case(192, hbm_mode="quantized"),
        CAPACITY_CASES[1]: lambda: graph_case(192, hbm_mode="float16",
                                              fast_math=True),
        CAPACITY_CASES[2]: lambda: graph_case(64, store_dtype="bfloat16",
                                              fast_math=True)}

    def descent(dg):
        wq = torch.from_numpy(base[:len(queries)]).to(dg.vectors.device)
        return layer0_call(lambda: build.construction_descent(
            dg, wq, ef=100, m_out=32, metric="cosine", max_hops=128), build)

    return {label: make[label]() for label in labels}


def graph_tier(device: str = "cuda"):
    """The smoke's graph tier: (Graph, queries, base)."""
    from hnsw_tpu_torch import Graph
    rng = np.random.default_rng(1)
    base = rng.standard_normal((N_GRAPH, DIM), dtype=np.float32)
    queries = rng.standard_normal((N_QUERIES, DIM), dtype=np.float32)
    g = Graph(m=16, ef_construction=100, metric="cosine", seed=0,
              device=device)
    g.native_serve_max_batch = 0
    g.build(list(range(N_GRAPH)), base, method="host")
    return g, queries, base


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(bs.BUILD_DIR), "hop_split"))
    ap.add_argument("--parent", default=None,
                    help="another beam_search.cu to time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("hop_split needs a CUDA card: the kernel has no "
                           "CPU mode")
    from hnsw_tpu_torch.core import search
    sources = {"change": bs.SOURCE}
    if args.parent:
        sources["parent"] = os.path.abspath(args.parent)
    paths = build_variants(args.out, sources)
    libs = {}
    for name, src in sources.items():
        libs[name] = bs.bind(paths[name])
        libs[f"{name}_clocks"] = clocks_library(
            os.path.join(args.out, f"{name}_clocks"), src)
    print(f"# {torch.cuda.get_device_name(0)}; K2 hop split, one layer-0 "
          f"launch a case, median of 5 CUDA-event reps")
    for k in paths:
        print_ptxas(os.path.join(args.out, k), k)
    g, queries, base = graph_tier()
    cases = capture_cases(g, queries, base)
    names = list(sources)
    for label, case in cases.items():
        times = {n: [] for n in names}
        order = (["parent", "change", "change", "parent"] if args.parent
                 else ["change"])
        for n in order:
            with using(libs[n]):
                times[n].append(cuda_ms(lambda: launch(case)))
        twin_ms = cuda_ms(lambda: search.beam_search_layer_reference(
            case["g"], 0, *case["args"], **case_kwargs(case)))
        print(f"# {label}: " + "; ".join(
            f"{n} {', '.join(f'{t:.3f}' for t in times[n])} ms"
            for n in names) + f"; twin {twin_ms:.3f} ms", flush=True)
        for n in names:
            print(f"  {n}:", end="")
            split_cases({label: case}, libs[n], libs[f"{n}_clocks"],
                        ms={label: statistics.median(times[n])})
    return 0


if __name__ == "__main__":
    sys.exit(main())
