#!/usr/bin/env python3
"""Where a call of K4, the wave builder's neighbour-selection kernel, spends
its time, on one NVIDIA GPU.

    python3 -m hnsw_tpu_torch.tools.select_split [--out DIR] [--parent SRC]
        [--cell NAME [--rows N]]

Builds ``csrc/diverse_select.cu`` twice into ``--out`` (default
build/select_split): as the port ships it, and with
``-DSELECT_PHASE_CLOCKS``, where thread 0 of each block adds up the
``clock64()`` cycles of each phase of a row (``PHASES``) into a [P, 5]
int64 buffer. Then it makes the smoke's phase-8b inputs on the card
(262,144 x 128 rows from a seeded generator, integer-valued (|x| <= 4) and
Gaussian; a wave of the first 2,048: each row's 64 nearest of the others
and 32 nearest of the wave, scored at HIGHEST as the builder scores them)
and runs each case of ``CASES``: the layer-0 call (C 96, deg 32, L2) on
f32 and fp16 stores, without diversify, the reverse update's C 64 both
ways, m = 42's C 252 (P 512, deg 84) and C 1,024 (P 64). For each case it
prints:

* the shipped kernel's ms through its wrapper
  (``ops/diverse_select.diverse_select_cuda``) two ways: one call an
  event pair (``cuda_ms``, median of 5 reps: the smoke's yardstick, the
  wrapper's host time included) and ``back_to_back_ms`` (20 calls back to
  back a rep, over 20: the host's time between calls hides under the
  kernel's where the kernel is the longer), and ``device_ms``, the median
  of 20 launches' own times on the card in a ``torch.profiler`` trace
  (``utils/profiling.device_trace``), whatever the host spends around
  them;
* each phase's share of the slowest block's cycles (the block with the
  most cycles in all, in the clocked build);
* resident blocks an SM of the diversifying kernel, and registers and
  spills from ptxas's report;
* the bound (``utils/roofline.select_bound_s``) over the distinct valid
  rows and the valid candidates' pairs, and over every slot's row and
  pair, with the kernel's share of each.

With ``--parent SRC`` (the ``csrc/diverse_select.cu`` of another checkout,
e.g. ``git archive <commit> | tar -x -C build/parent``), it loads that
checkout's own ``ops/diverse_select.py`` beside it, builds its kernel into
``--out`` and times the two through their own wrappers in turns on each
case (parent, change, change, parent), all three ways.

With ``--cell NAME`` the inputs are a benchmark cell's own: its set-up
(``portbench.run.set_up``: its configuration's generator, width, metric
and wave builder) draws and builds ``--rows`` rows (default ``N_ROWS``),
and the cases (``cell_cases``) are the builder's calls at that width: the
layer-0 call (C 96, deg m0) with and without diversify and the reverse
update's C 64, on the graph's float32 store in the cell's metric. It
also times every K4 launch of that build on the card (CUDA events around
each call, ``timed_selections``) and prints their sum beside the build's
seconds and the launches by layout ("whole" or "slabs"). Needs nvcc and
a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import glob
import importlib.util
import os
import re
import statistics
import sys
import tempfile
import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hnsw_tpu_torch.ops import diverse_select as ds
from hnsw_tpu_torch.tools.screen_split import cuda_ms

#: the kernel's phase counters, in the order of csrc/diverse_select.cu PH_*
PHASES = ("A: load, rank, dedup, norms", "G-stage: row gather",
          "G-product", "G-bits: epilogue, conflict bits",
          "S: scan, backfill, compaction")
CLOCKS = "SELECT_PHASE_CLOCKS"
#: csrc/diverse_select.cu ST_*: store code -> name
STORE_NAMES = {0: "f32", 1: "fp16", 2: "bf16"}
#: the smoke's phase-10 build: its rows and width, and a wave's rows
N_ROWS, DIM, WAVE = 262_144, 128, 2048


@dataclasses.dataclass(frozen=True)
class Case:
    label: str
    kind: str             # "integer" | "gaussian" rows
    dtype: torch.dtype    # the row store
    P: int                # rows of the call (the first P rows: a wave)
    n_cand: int           # nearest of the other rows a slate row holds
    intra_k: int          # nearest of the wave a slate row holds
    C: int                # candidates a row (a prefix of the slate)
    deg: int
    diversify: bool = True


#: phase 8b's cases and the slab path's C 1,024
CASES = (
    Case("integer layer 0", "integer", torch.float32, WAVE, 64, 32, 96, 32),
    Case("gaussian layer 0", "gaussian", torch.float32, WAVE, 64, 32, 96,
         32),
    Case("integer layer 0, fp16 store", "integer", torch.float16, WAVE, 64,
         32, 96, 32),
    Case("gaussian layer 0, fp16 store", "gaussian", torch.float16, WAVE,
         64, 32, 96, 32),
    Case("gaussian layer 0 without diversify", "gaussian", torch.float32,
         WAVE, 64, 32, 96, 32, False),
    Case("integer C 64", "integer", torch.float32, WAVE, 64, 32, 64, 32),
    Case("gaussian C 64", "gaussian", torch.float32, WAVE, 64, 32, 64, 32),
    Case("integer C 64 without diversify", "integer", torch.float32, WAVE,
         64, 32, 64, 32, False),
    Case("gaussian C 64 without diversify", "gaussian", torch.float32, WAVE,
         64, 32, 64, 32, False),
    Case("gaussian C 252 (m = 42)", "gaussian", torch.float32, 512, 168, 84,
         252, 84),
    Case("gaussian C 1,024", "gaussian", torch.float32, 64, 992, 32, 1024,
         64),
)


def slate(vectors: torch.Tensor, sq: torch.Tensor, P: int, n_cand: int,
          intra_k: int, metric: str = "l2"):
    """A wave builder's candidate slate for the first ``P`` rows of
    ``vectors`` (the wave): each one's ``n_cand`` nearest of the other rows
    (the snapshot's candidates) and its ``intra_k`` nearest of the wave,
    scored at HIGHEST by build_device._row_dist_dense, as
    _assemble_wave_rows hands them to the selection. Returns (ci [P,
    n_cand + intra_k] int32, cd float32)."""
    from hnsw_tpu_torch.core import build_device
    wave = vectors[:P].to(torch.float32)
    snap = vectors[P:].to(torch.float32)
    near = torch.cat([torch.topk(torch.cdist(wave[c:c + 256], snap),
                                 n_cand, largest=False).indices + P
                      for c in range(0, P, 256)])
    intra = torch.cdist(wave, wave)
    intra.fill_diagonal_(float("inf"))
    iw = torch.topk(intra, intra_k, largest=False).indices
    ci = torch.cat([near, iw], dim=1).to(torch.int32).contiguous()
    anchors = torch.arange(P, dtype=torch.int32, device=vectors.device)
    cd = build_device._row_dist_dense(vectors, sq, anchors, ci, metric)
    return ci, cd.contiguous()


def rows(kind: str, n: int, dim: int, device, seed: int = 8):
    """[n, dim] float32 rows from a seeded generator on ``device``:
    integer-valued in [-4, 4], or Gaussian."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "integer":
        return torch.randint(-4, 5, (n, dim), generator=gen,
                             device=device).to(torch.float32)
    return torch.randn((n, dim), generator=gen, device=device)


def data_bound(ci: torch.Tensor, cd: torch.Tensor, D: int, deg: int,
               diversify: bool, store_bytes: int = 4) -> dict:
    """The call's bound (``utils/roofline.select_bound_s``) over its data:
    the distinct valid rows and the valid candidates' pairs; and over every
    slot's row and every pair. Returns {"bound_ms", "bound_by",
    "no_reuse_bound_ms", "no_reuse_bound_by", "rows", "pairs"}."""
    from hnsw_tpu_torch.ops.distance import INF_DIST
    from hnsw_tpu_torch.utils import roofline
    P, C = ci.shape
    ok = (ci >= 0) & (cd < INF_DIST)
    n_rows = int(torch.unique(ci[ok]).numel())
    counts = ok.sum(1).to(torch.int64)
    pairs = int((counts * (counts - 1) // 2).sum())
    b, by = roofline.select_bound_s(P, C, D, deg, rows=n_rows, pairs=pairs,
                                    diversify=diversify,
                                    store_bytes=store_bytes)
    f, fby = roofline.select_bound_s(P, C, D, deg, diversify=diversify,
                                     store_bytes=store_bytes)
    return {"bound_ms": b * 1e3, "bound_by": by, "no_reuse_bound_ms": f * 1e3,
            "no_reuse_bound_by": fby, "rows": n_rows, "pairs": pairs}


def parse_ptxas(text: str) -> Dict[str, dict]:
    """ptxas's ``-v`` report -> {"f32/vec": {"registers", "spill_stores",
    "spill_loads", "stack"}, ...}, one entry a diverse_select_kernel
    instantiation: a store of ``STORE_NAMES`` with "vec" or "scalar"
    loads, or "without diversify" for the one that reads no row."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            k = re.search(r"diverse_select_kernelILi(\d)ELb([01])ELb([01])E",
                          m.group(1))
            name = None
            if k and k.group(3) == "0":
                name = "without diversify"
            elif k:
                name = (STORE_NAMES[int(k.group(1))]
                        + ("/vec" if k.group(2) == "1" else "/scalar"))
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


def phase_report(cycles: np.ndarray, kernel_ms: float) -> dict:
    """The split of one launch: ``cycles`` [blocks, len(PHASES)] from the
    clocked build (rows a block never ran are 0), ``kernel_ms`` the shipped
    build's time. Returns the slowest block (most cycles in all), its
    cycles, each phase's share of them, those shares of the kernel's ms,
    and each phase's share of all blocks' cycles."""
    cycles = np.asarray(cycles, dtype=np.int64)
    total = cycles.sum(axis=1)
    slow = int(np.argmax(total))
    shares = cycles[slow] / max(1, int(total[slow]))
    every = cycles.sum(axis=0) / max(1, int(total.sum()))
    return {"slowest_block": slow, "slowest_cycles": int(total[slow]),
            "shares": dict(zip(PHASES, shares.tolist())),
            "all_blocks": dict(zip(PHASES, every.tolist())),
            "ms_by_phase": dict(zip(PHASES, (shares * kernel_ms).tolist()))}


def format_report(rep: dict) -> str:
    def parts(shares):
        return ", ".join(f"{k.split(':')[0]} {v:.3f}"
                         for k, v in shares.items())
    return (f"slowest block {rep['slowest_block']} "
            f"({rep['slowest_cycles']} cycles), shares: "
            f"{parts(rep['shares'])}; all blocks: {parts(rep['all_blocks'])}")


def bind_clocks(path: str):
    """The clocked build at ``path`` (``ops/diverse_select.bind``), with its
    phase counters' entry points typed."""
    lib = ds.bind(path)
    lib.diverse_select_set_clocks.argtypes = [ctypes.c_void_p]
    lib.diverse_select_set_clocks.restype = ctypes.c_int
    lib.diverse_select_phase_count.restype = ctypes.c_int
    return lib


@contextmanager
def using(lib):
    """``ops/diverse_select.diverse_select_cuda`` launches through ``lib``
    inside the block (the launch counts are left as they were)."""
    saved = (ds._lib, ds.launches, dict(ds.launches_by_layout))
    ds._lib = lib
    try:
        yield
    finally:
        ds._lib, ds.launches = saved[:2]
        ds.launches_by_layout.update(saved[2])


def back_to_back_ms(fn: Callable, reps: int = 5, inner: int = 20) -> float:
    """ms of one call of ``fn``: the median over ``reps`` of CUDA-event time
    around ``inner`` calls back to back, over ``inner`` (after one
    warm-up). The host's time between calls hides under the kernel's where
    the kernel is the longer, so this is the device's time there."""
    return cuda_ms(lambda: [fn() for _ in range(inner)], reps) / inner


def device_ms(fn: Callable, calls: int = 20) -> float:
    """The median of the card's own time of each K4 launch (a kernel
    event named diverse_select_kernel) of ``calls`` calls of ``fn``, from
    one ``torch.profiler`` trace (``utils/profiling.device_trace``, padded
    so the records arrive): the kernel alone, with no host time."""
    from hnsw_tpu_torch.utils import profiling
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as td:
        with profiling.device_trace(td):
            for _ in range(calls):
                fn()
        us = [t for path in sorted(glob.glob(os.path.join(td, "*.json")))
              for cat, name, t in profiling.device_events(path)
              if cat == "kernel" and "diverse_select_kernel" in name]
    if len(us) != calls:
        raise RuntimeError(f"device_ms: {len(us)} kernel records of "
                           f"{calls} launches in the trace")
    return statistics.median(us) / 1e3


def clocked(lib, args: tuple, deg: int, diversify: bool,
            metric: str = "l2") -> np.ndarray:
    """One launch of the clocked build ``lib`` (``bind_clocks``) on (ci,
    cd, vectors, sq): cycles [P, len(PHASES)] on the host."""
    P = args[0].shape[0]
    buf = torch.zeros((P, lib.diverse_select_phase_count()),
                      dtype=torch.int64, device=args[0].device)
    if lib.diverse_select_set_clocks(buf.data_ptr()) != 0:
        raise RuntimeError("diverse_select_set_clocks failed")
    try:
        with using(lib):
            ds.diverse_select_cuda(*args, deg=deg, metric=metric,
                                   diversify=diversify)
        torch.cuda.synchronize()
    finally:
        lib.diverse_select_set_clocks(None)
    return buf.cpu().numpy()


def wrapper_of(source: str, build_dir: str):
    """The ``ops/diverse_select.py`` of the checkout whose
    ``csrc/diverse_select.cu`` is ``source``, loaded as a module of its own
    that builds its library into ``build_dir``: another commit's kernel
    through its own wrapper and C interface."""
    source = os.path.abspath(source)
    path = os.path.join(os.path.dirname(os.path.dirname(source)), "ops",
                        "diverse_select.py")
    spec = importlib.util.spec_from_file_location("diverse_select_other",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if os.path.abspath(mod.SOURCE) != source:
        raise ValueError(f"{path} builds {mod.SOURCE}, not {source}")
    mod.BUILD_DIR = build_dir
    return mod


def build_all(jobs: Dict[str, Callable]) -> None:
    """Runs every build of ``jobs`` (name -> a call that builds and loads
    one library) at once, one nvcc each; raises their errors together."""
    errors = []

    def one(name):
        try:
            jobs[name]()
        except Exception as e:          # raised below, all together
            errors.append(f"{name}: {e}")

    threads = [threading.Thread(target=one, args=(k,)) for k in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("; ".join(errors))


def print_ptxas(build_dir: str, label: str) -> Dict[str, dict]:
    with open(os.path.join(build_dir, "diverse_select.ptxas.txt")) as f:
        regs = parse_ptxas(f.read())
    print(f"  ptxas, {label}: " + "; ".join(
        f"{k} {v.get('registers')} registers, "
        f"{v.get('spill_stores', 0)}/{v.get('spill_loads', 0)} B spill "
        f"stores/loads" for k, v in sorted(regs.items())), flush=True)
    return regs


def make_inputs(cases=CASES, device: str = "cuda", n: int = N_ROWS,
                dim: int = DIM,
                given: Optional[Dict[str, torch.Tensor]] = None,
                metric: str = "l2") -> Dict[str, tuple]:
    """label -> (ci, cd, vectors, sq) of each case: the rows of its kind
    (float32, cast to its store; ``given`` holds the rows of a kind made
    elsewhere, such as a cell's store), the slate of its (P, n_cand,
    intra_k) scored in ``metric``, cut to its first C columns; norms of
    the stored values."""
    out, slates = {}, {}
    given = given or {}
    for kind in dict.fromkeys(c.kind for c in cases):
        v32 = given[kind] if kind in given else rows(kind, n, dim, device)
        sq32 = (v32 * v32).sum(-1)
        for c in (c for c in cases if c.kind == kind):
            key = (c.P, c.n_cand, c.intra_k)
            if key not in slates:
                slates[key] = slate(v32, sq32, *key, metric=metric)
            ci, cd = slates[key]
            v = v32.to(c.dtype)
            sq = sq32 if c.dtype == torch.float32 else (
                v.to(torch.float32) ** 2).sum(-1)
            out[c.label] = (ci[:, :c.C].contiguous(),
                            cd[:, :c.C].contiguous(), v, sq)
        slates.clear()
        del v32, sq32
    return out


def cell_cases(conf: dict) -> tuple:
    """The builder's calls at a cell's configuration ``conf``: the
    layer-0 call (a wave of ``wave`` rows, 64 of the others and 32 of the
    wave a row, C 96, deg m0) with and without diversify, and the reverse
    update's C 64, on the cell's rows (kind "cell")."""
    wave, m0 = int(conf["wave"]), int(conf["m0"])
    return (Case("cell layer 0", "cell", torch.float32, wave, 64, 32, 96, m0),
            Case("cell layer 0 without diversify", "cell", torch.float32,
                 wave, 64, 32, 96, m0, False),
            Case("cell C 64", "cell", torch.float32, wave, 64, 32, 64, m0))


@contextmanager
def timed_selections():
    """Inside the block every ``ops/diverse_select.diverse_select_cuda``
    call is timed on the card by a CUDA event pair on its stream (no host
    sync); yields a dict whose "ms" holds, once the block has ended, the
    sum of those times, and "calls" their number."""
    real, pairs, out = ds.diverse_select_cuda, [], {}

    def timed(*a, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        r = real(*a, **kw)
        e1.record()
        pairs.append((e0, e1))
        return r

    ds.diverse_select_cuda = timed
    try:
        yield out
    finally:
        ds.diverse_select_cuda = real
        torch.cuda.synchronize()
        out.update(calls=len(pairs),
                   ms=sum(a.elapsed_time(b) for a, b in pairs))


def cell_inputs(name: str, n: int):
    """(the cases, their inputs, the metric) of ``--cell``: the cell's
    set-up at ``n`` rows, whose build's K4 launches are timed
    (``timed_selections``) and printed beside the build's seconds."""
    from portbench import cells, run
    c = cells.load(name)
    c = dataclasses.replace(c, config=dict(c.config, rows=int(n)))
    before = dict(ds.launches_by_layout)
    with timed_selections() as sel:
        s = run.set_up(c, 1, torch.device("cuda"))
    layouts = {k: v - before[k] for k, v in ds.launches_by_layout.items()}
    metric = c.config["metric"]
    print(f"# cell {name}: {n} x {c.config['dim']} {metric} rows; the "
          f"build {s.build_s:.3f} s; K4 in it and in the two-wave warm-up "
          f"before it: {sel['calls']} launches ({layouts}), "
          f"{sel['ms'] / 1e3:.3f} s on the card, "
          f"{sel['ms'] / 1e3 / s.build_s:.4f} of the build's seconds",
          flush=True)
    dg = s.graph.device_graph()
    vectors = dg.vectors[:n].to(torch.float32).contiguous()
    cases = cell_cases(c.config)
    inputs = make_inputs(cases, given={"cell": vectors}, metric=metric)
    return cases, inputs, metric


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(ds.BUILD_DIR), "select_split"))
    ap.add_argument("--parent", default=None,
                    help="another checkout's csrc/diverse_select.cu to time "
                         "in turns, through its own wrapper")
    ap.add_argument("--cell", default="",
                    help="a benchmark cell whose set-up makes the rows and "
                         "whose configuration sets the cases")
    ap.add_argument("--rows", type=int, default=N_ROWS,
                    help="rows of the --cell set-up")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("select_split needs a CUDA card: the kernel has "
                           "no CPU mode")
    from hnsw_tpu_torch.core import build
    wrappers = {"change": ds}
    clocks_dir = os.path.join(args.out, "change_clocks")
    jobs = {"change": ds._load,
            "change_clocks": lambda: ds.build((CLOCKS,), clocks_dir)}
    if args.parent:
        wrappers["parent"] = wrapper_of(args.parent,
                                        os.path.join(args.out, "parent"))
        jobs["parent"] = wrappers["parent"]._load
    build_all(jobs)
    clk = bind_clocks(os.path.join(clocks_dir, "libdiverse_select.so"))
    print(f"# {torch.cuda.get_device_name(0)}; K4 split, ms of one call "
          f"through each wrapper (median of 5 CUDA-event reps of one call; "
          f"back to back: of 20 calls, over 20; device: the median launch "
          f"of 20 in a torch.profiler trace)", flush=True)
    print_ptxas(ds.BUILD_DIR, "change")
    print_ptxas(clocks_dir, "change, clocked")
    if args.cell:
        cases, inputs, metric = cell_inputs(args.cell, args.rows)
    else:
        cases, inputs, metric = CASES, make_inputs(), "l2"
    order = (["parent", "change", "change", "parent"] if args.parent
             else ["change"])
    for c in cases:
        a = inputs[c.label]
        D = a[2].shape[1]
        want = build._diverse_select_reference(
            *a, deg=c.deg, metric=metric,
            diversify=c.diversify).cpu().numpy()
        calls = {n: (lambda m=m: m.diverse_select_cuda(
            *a, deg=c.deg, metric=metric, diversify=c.diversify))
            for n, m in wrappers.items()}
        times = {n: [] for n in wrappers}
        for n in order:
            times[n].append((cuda_ms(calls[n]), back_to_back_ms(calls[n])))
        dev = {n: device_ms(calls[n]) for n in wrappers}
        bound = data_bound(a[0], a[1], D, c.deg, c.diversify,
                           a[2].element_size())
        print(f"# {c.label} (P {c.P}, C {c.C}, deg {c.deg}, D {D}, "
              f"{STORE_NAMES[ds.STORES[c.dtype]]} store, diversify "
              f"{c.diversify}): " + "; ".join(
                  f"{n} {', '.join(f'{t:.4f}' for t, _ in times[n])} ms, "
                  f"back to back {', '.join(f'{b:.4f}' for _, b in times[n])}"
                  f", device {dev[n]:.4f}" for n in wrappers)
              + f"; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
              f"{bound['rows']} distinct rows, {bound['pairs']} valid pairs),"
              f" every slot {bound['no_reuse_bound_ms']:.4f} ms "
              f"({bound['no_reuse_bound_by']})", flush=True)
        for n in wrappers:
            ms = statistics.median(t for t, _ in times[n])
            b2b = statistics.median(b for _, b in times[n])
            got = calls[n]().cpu().numpy()
            equal = float(np.mean((got == want).all(axis=1)))
            line = (f"  {n}: {ms:.4f} ms, back to back {b2b:.4f}, device "
                    f"{dev[n]:.4f}; {bound['bound_ms'] / ms:.4f} of the "
                    f"bound ({bound['bound_ms'] / dev[n]:.4f} of the device"
                    f" time; every slot's "
                    f"{bound['no_reuse_bound_ms'] / dev[n]:.4f}); rows "
                    f"equal to the twin's {equal:.5f}")
            if n == "change":
                if c.diversify:
                    per_sm = ds._load().diverse_select_blocks_per_sm(
                        c.C, D, ds.STORES[c.dtype])
                    line += f"; {per_sm} blocks an SM"
                rep = phase_report(clocked(clk, a, c.deg, c.diversify,
                                           metric), dev[n])
                line += "; " + format_report(rep)
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
