#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (hnsw_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path once at a size users of an ANN library
call real, and fails (non-zero exit, no result line) on any failed check:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles the CUDA kernels from the sources in the checkout,
   one nvcc each, started together (csrc/exact_screen.cu: K1's TF32
   wgmma screen, fed by TMA, route "wgmma", or by cp.async, route
   "wgmma_cp"; csrc/beam_search.cu: K2, one graph layer's beam search a
   launch, and K5, a whole search a launch, and the same source with
   -DBEAM_PHASE_CLOCKS (K2 alone) and with -DGRAPH_PHASE_CLOCKS for phase
   5b's splits of K2's hop and K5's launch; csrc/diverse_select.cu: K4, one call of the wave builder's
   neighbour selection a launch), and the native host engine;
3. kernel vs plain: exact_topk_fused through each K1 route against the
   same wrapper with the plain torch screen in its place, on the card;
   (the exact tier's shapes, and the adaptive engine's: a 131,072-row
   table, batches of 1,024 and single queries padded to 8 rows; the
   widths TMA cannot take: glove-50's and glove-25's 1,183,514 rows,
   lastfm-64's 292,385 x 65, a D=128 view off 16-byte alignment and a
   D=7 table); then the screen alone timed per route and mode at the
   exact tier's shape (Q=1024, N=1,048,576, D=128, k_sel=18, l2; both
   producers) and, for the cp.async producer, at glove-50's, each beside
   its bound, with the plain version and torch.topk(torch.cdist) as a
   yardstick the port never calls; then the capacity screen
   (ops/exact_screen.capacity_scan: int8 and bf16 tables on its own
   warp-specialised bf16 kernel, route "bf16_ws", where it fits; fp16,
   the larger kk and the other pitches on K1's kernel with the table's
   store) against its plain version (ops/topk.quantized_topk_candidates)
   for each store at the exact tier's shape (int8 with per-row scales
   kk=26, bf16 and fp16 kk=14, L2, TMA, with the library yardstick
   torch.topk(torch.cdist(q, table.float() * scales)); int8 and bf16
   also at kk 150, k=100's pool on the int8 rung, and 256, the screen's
   limit), below K1's 32,768-row switch (every store at N 1,000 / 8,192
   / 32,767, Q 1,024 and 8), and int8 and bf16 at glove-50's (cosine,
   rows of 50 and 100 bytes: the ordinary-load producer), held to id
   overlap >= 0.999 and matched distances within 1e-5 relative, each
   timed beside its bound and the plain version, and where "bf16_ws"
   runs, K1's kernel on the same table held and timed beside it;
4. exact tier at SIFT1M's shape (1,000,000 x 128 f32, L2, k=10; synthetic
   data from a seed): recall@10 against the numpy oracle and QPS, with
   K1's launches by route from this phase; then the exact tier at
   glove-50-angular's shape (1,183,514 x 50, cosine), which D % 4 != 0
   sends down the wgmma_cp route;
5. graph tier: the default Graph (m=16, ef_construction=100, cosine,
   descent entry, bitonic merge, f32 store) built on 100,000 x 128 by the
   native builder and served on the card at ef 64 and 192, each batch one
   K5 launch (checked: one, and no K2 launch); in the default mode and in
   bench.py's (fast_math, neighbour blocks, pivot seeds) the same batches
   through the parent's path (core/search.search_graph_reference with one
   K2 launch a layer: recall within 0.005 and hops a layer equal) and, in
   the default mode, through the plain twin; QPS each way and one traced
   batch each way (launches, idle share);
5b. K2 against its twin on that graph: one layer-0 launch beside the twin
   on the inputs the entry points give it (Graph at ef 64 and 192 on f32
   rows, bench.py's mode at ef 192 on int8 and on fp16 neighbour blocks,
   the wave builder's DEFAULT/sort descent at ef 100, the local-repair
   refine that batch_delete(refine=True) runs, on a copy of the graph,
   and the capacity stores: hbm_mode="quantized" (int8 rows with per-row
   scales) and hbm_mode="float16" + fast_math at ef 192, the bf16 store
   at DEFAULT at ef 64, held to id overlap >= 0.999 and equal hops):
   id overlap, error, hop counts, the kernel's ms and µs a hop of the
   slowest query beside its bound (utils/roofline.hop_bound_s over the
   distinct nodes and rows the batch reads, and without reuse across
   queries), its resident blocks an SM and registers, and the twin's ms;
   then k2-capacity-8m: one layer-0 launch of K2 on int8 rows and on fp16
   rows at 8,388,608 x 128 (made on the card from a seed, a random
   32-out table, no build; larger than L2) beside the twin, held the
   same way; then where a hop's time goes at rows ef 64 and 192 and on
   the int8 rows (tools/hop_split.py: each phase's share of the slowest
   block's cycles); then K5 against its plain version
   (core/search.search_graph_reference over K2's twin) on the searches
   Graph makes (default mode ef 64 / 192, bench's mode ef 192): one
   launch each, id overlap >= 0.999, distances within 1e-5 x max(1, |d|)
   (1e-3 on int8 blocks), hops a layer equal; its ms beside its bound
   (utils/roofline.search_bound_s over the distinct node ids and rows,
   and without reuse across queries), the plain version's and the
   parent's path's ms, its registers and spills, its resident blocks an
   SM (checked: 8), and where a launch's cycles go by layer group
   and hop phase (tools/graph_split.py, the build with
   -DGRAPH_PHASE_CLOCKS made in phase 2);
6. exact capacity ladder at BIGANN-10M's shape (10,000,000 x 128, L2,
   k=10; synthetic rows from a seed): the float32 rung through the kernel,
   checked against a chunked numpy scan, then hbm_dtype int8, bf16 and
   fp16 with recall@10 against the float32 rung, QPS, and
   batch_search_stream against sequential search; each reduced rung
   launches the capacity screen once a batch (the warm-up, 8 sequential
   and 8 streamed batches) and K1 never, and one batch through the plain
   scan gives its QPS beside the kernel's; int8 also serves one batch at
   k=100 (pool 150), held to recall@100 >= 0.99 against the float32
   rung; no phase lets a capacity scan of a card table run the plain
   version (ops/exact_screen.capacity_plain_on_cuda stays 0);
7. hbm_dtype="auto" on 1,000,000 x 128 tight clusters (two widths): the
   rung it resolves to, and K1's launches when that is float32, the
   capacity screen's when it is a reduced rung;
8. the graph tier's serving modes on the same 100k graph: bench.py's
   configuration (fast_math, block_layout, entry_mode="pivots") at ef 192
   and 384 (and at ef 192 through the plain twin: QPS, recall within
   0.005), hbm_mode float16 and quantized at ef 192 (K2 on fp16 rows and
   on int8 rows with per-row scales, then the host rerank; each also
   through the twin, recall within 0.005, and one batch traced each way
   with the host rerank's share), the bf16 store at ef 64 (and through
   the twin), and compact upper layers at ef 64 (ids equal to the dense
   layout's);
8b. K4 against its twin (core/build._diverse_select_reference) on the
   card at a layer-0 call of phase 10's build (a wave of 2,048 of
   262,144 x 128 L2 rows, C = 96 candidates: 64 of the other rows, 32 of
   the wave; deg 32): rows equal on integer-valued rows, >= 0.999 of
   them on Gaussian rows, equal without diversify, the same with an fp16
   store, at the reverse update's C = 64, at m = 42's C = 252 and at
   C = 1,024 (D staged in slabs); the kernel's ms beside its bound
   (utils/roofline.select_bound_s) and the twin's, and the layer-0 call's
   split from the clocked build (tools/select_split.py);
9. the device wave builder on the first 50,000 of the same vectors (wave
   2048): a build held to the recall of the native build of the same
   50,000 (phase 5's graph, measured when it held only them) and
   served on the card and the CPU, the same build through K2's plain twin
   and through K4's (nodes/s, recall within 0.005) and one more wave
   traced each way (launches, wall and device ms, idle share), the
   int8-block fp16
   descent (its upper layers on K2's fp16 rows, layer 0 on its int8
   blocks), batch_delete of every 10th key with refine=True, and a build
   aborted at its deadline, served as its inserted prefix and finished by
   Graph.resume_build; the recall oracle is the exact tier (the kernel)
   on the card;
10. a device build of 262,144 x 128 L2 rows (synthetic, from a seed) by
   method="device", after a check that "auto" sends 1,048,576 rows to
   the wave builder: build time, peak memory, levels, recall@10 against
   the exact tier at ef 64 and 192 with the f32 store and in hbm_mode
   "quantized" and "float16" (K2 on their rows, then the host rerank;
   within 0.05 of the f32 store's), and a profile of one mid-build wave
   split into descent, row assembly (diversity selection) and reverse
   update (its padding is taken out of the build time);
11. IVFIndex on 1,000,000 x 128 cosine rows of a 1,024-centre Gaussian
   mixture, 1,024 partitions: training, assignment, commit and block
   table times, then nprobe 1, 4, 16, 64 and "auto": recall@10 against
   the exact tier on the card and QPS of 1,024-query batches, with the
   host's share of a batch;
12. AdaptiveHybridIndex (exact_threshold=500, one int8 capacity arm, a
   StreamingExactIndex attached as the stream arm) on the 100,000 x 128
   cosine rows of phase 5: warm(), 16 batches of 1,024 queries and 1,024
   single queries, recall@10 against the exact tier, the arms that
   served, K1's launches by the exact arm and the recall probes,
   fallback_errors == 0, the int8 arm alone (one capacity screen launch,
   recall@10 >= 0.99; the phase launches the screen on int8 only);
   two batches served by the stream arm (measured
   recall >= 0.99, K1 on its one 100,000-row chunk); and the LSH arm's
   recall and candidate-set sizes;
13. bench.py's configuration (10,000 x 128 cosine, k=10): HybridIndex with
   target_recall 0.95 and 1.0 and without a target, batch_delete of
   every 10th key, and AdaptiveHybridIndex over 1,024 single queries;
14. StreamingExactIndex at BIGANN-10M's shape: phase 6's 10,000,000 x 128
   L2 rows in a memory-mapped row file (a temporary directory with twice
   the file free, removed after), streamed in 131,072-row chunks through
   K1: ids equal to phase 6's float32 rung on its first batch (or a
   tie-aware recall of 1.0), QPS cold, warm (every chunk pinned on the
   card) and with a 2 GB budget, a warm batch beside the plain scan per
   chunk, and one cold batch of each reduced rung (recall@10 >= 0.99;
   one capacity screen launch a chunk);
15. DiskGraph on phase 5's graph (npz tables): persist without a rebuild,
   reopen with keys and distances equal to phase 5's at ef 64, 200 adds
   and 100 deletes through the WAL and an incremental reopen, then the
   same directory with vectors on disk and the int8 store on the card
   (recall@10 at ef 64 and 192);
16. facets, metadata and the analyzer on phase 5's graph: the masked exact
   scan (K1) under a 1% equality and a 10% range filter at recall 1.0,
   the over-fetch search beside it, payloads attached, the analyzer's
   height, topography and connectivity.
17. the parallel package on default_mesh(8), eight shards on the one card:
   phase 6's 10M rows row-sharded (sharded_exact_topk: K1 on every
   1.25M-row shard, ids equal to phase 6's float32 rung; int8 shards
   with per-row scales + host rerank, recall@10 >= 0.99, one capacity
   screen launch a shard a batch), phase 5's graph
   query-sharded (f32 and fp16 stores, overlap >= 0.99 with one search of
   the batch) and row-sharded (f32 and fp16 rows, overlap >= 0.9 with the
   pivot-seeded single-device search), a PartitionedGraph of 8 partitions
   over its rows (recall >= 0.9 x phase 5's), phase 11's block table
   block-sharded (overlap >= 0.999 with IVFIndex at nprobe 16, the exact
   tier's slots at 1,024), a 2-slice MultiHostIndex over TCP with 500,000
   rows of phase 11 on the card a slice (K1 a slice, recall 1.0), and the
   port's dryrun_multichip(8);
18. the drivers: python3 -m hnsw_tpu_torch.tools.bench's run at full size
   (its JSON line; exact recall@10 1.0, fast_math >= 0.999), every
   configuration of tools/sweep at full size with the --big ladder (K1 at
   1,048,576 and 8,388,608 rows x 128, 8,192 queries; each row's mfu
   <= 1 against utils/roofline's peak, all queries held to the plain
   scan: f32 ids equal but for f32 ties at 1M and 8M, recall >= 0.999),
   tools/entry.entry() against the same call on the CPU (overlap >=
   0.99), and utils/profiling.device_trace around one bench exact batch
   (CUDA kernel events and the annotated name).

Phases 5, 8, 9, 10, 17 and 18 each check that K5 launched while they
served (by layer 0's mode) and that no search K5 covers went to its
plain version (ops/graph_search.plain_on_cuda "size" and "other");
phases 9 and 10 also that K2 launched for the wave builder's descent and
refine, and no layer of a mode K2 covers went to its twin
(ops/beam_search.twin_layers_on_cuda); phases 5, 8, 9 and 10 drive only
covered modes and check that nothing went to either plain version, and
the main path as a whole launched K5 in each of its five modes (f32
rows, blocks, int8 rows, fp16 rows, bf16 rows) and K2 in each of the
builder's (f32 rows, blocks, fp16 rows).
Phases 6, 7, 12, 14 and 17 each check the capacity screen's launches by
store and by route (ops/exact_screen.capacity_launches_by_store,
capacity_launches_by_route: int8 and bf16 on "bf16_ws" but int8 at
k = 100, fp16 on "wgmma"), and the main path as a whole launched it on
all three stores and through both its kernels. Phases 9 and 10 each
check that K4 launched and that no selection went to its twin
(ops/diverse_select.plain_on_cuda; the build that forces the twin is
left out of the count).
The last two lines are the kernel table (one entry a K1 route, one for
K2, one for K5, two for the capacity screen: K1's kernel with the
table's store and the warp-specialised bf16 kernel, and one for K4, each
with its launches on the main path) and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one CUDA card and no network; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_EXACT, N_GRAPH, DIM = 1_000_000, 100_000, 128
#: ANN-benchmarks' glove-50-angular: a width that takes K1's cp.async
#: producer
N_GLOVE, D_GLOVE = 1_183_514, 50
N_CAPACITY, N_CLUSTER = 10_000_000, 1_000_000
BATCH, N_BATCHES = 1024, 8
#: phase 9: the wave builder's modes, on the first rows of phase 5's set
N_DEVICE_BUILD = 50_000
#: phase 10: one long device build (128 waves), and the row count whose
#: "auto" routing it checks (hnsw_tpu_torch/index/hnsw.py _route)
N_SIFT, N_AUTO_DEVICE, WAVE = 262_144, 1_048_576, 2048
#: the mid-build wave phase 10 profiles
PROFILE_WAVE = 64
#: phase 11: rows, mixture centres (= partitions) and the nprobe ladder
N_IVF, IVF_PARTS, IVF_NPROBES = 1_000_000, 1024, (1, 4, 16, 64)
#: phase 12: served batches and single queries of the adaptive engine
N_ADAPT_BATCHES, N_SINGLE = 16, 1024
#: phase 12: queries also held against the numpy oracle
N_NUMPY = 32
#: phase 13: bench.py's rows
N_BENCH = 10_000
#: where the index phases serve; the smoke itself refuses to run off CUDA
DEVICE = "cuda"
KERNEL = {"route": "cuda",
          "source": "hnsw_tpu_torch/csrc/exact_screen.cu",
          "replaces": "hnsw_tpu/ops/pallas_exact.py:175"}
#: the capacity screen (K3's port): the same kernel source over the
#: capacity modes' int8 (with per-row scales), bf16 and fp16 tables, one
#: launch a capacity scan (ops/exact_screen.capacity_scan)
CAPACITY_KERNEL = {"route": "cuda",
                   "source": "hnsw_tpu_torch/csrc/exact_screen.cu",
                   "replaces": "hnsw_tpu/ops/topk.py:249"}
#: the capacity screen's launches on the main path, by store and by route
#: (ops/exact_screen.CAPACITY_ROUTES), summed over the phases that drive a
#: capacity scan (6, 7, 12, 14, 17; each resets the counts before it and
#: reads them after)
CAPACITY_LAUNCHES = dict.fromkeys(("int8", "bf16", "fp16"), 0)
CAPACITY_ROUTE_LAUNCHES = dict.fromkeys(("wgmma", "wgmma_ld", "bf16_ws"), 0)
#: the capacity screen's warp-specialised bf16 kernel (route "bf16_ws":
#: int8 and bf16 tables where its block fits), its own entry of the
#: kernels line; "capacity_screen" is K1's kernel with the table's store
CAPACITY_WS_KERNEL = {"route": "cuda",
                      "source": "hnsw_tpu_torch/csrc/exact_screen.cu",
                      "replaces": "hnsw_tpu/ops/topk.py:249"}
#: phase 3: the capacity screen's pool at k = 10 by store (ExactIndex's
#: margins: k + 16 for int8, k + 4 for bf16 and fp16)
CAPACITY_KK = {"int8": 26, "bf16": 14, "fp16": 14}
#: K2, the beam-search kernel: one launch a graph layer searched
BEAM_KERNEL = {"route": "cuda",
               "source": "hnsw_tpu_torch/csrc/beam_search.cu",
               "replaces": "hnsw_tpu/core/search.py:240"}
#: K5, the whole-search kernel: one launch a graph search (entries, every
#: upper layer, layer 0, the f32 rerank; ops/graph_search), built from K2's
#: device code in the same source
GRAPH_KERNEL = {"route": "cuda",
                "source": "hnsw_tpu_torch/csrc/beam_search.cu",
                "replaces": "hnsw_tpu/core/search.py:368"}
#: K5's launches on the main path, by layer 0's mode, summed over the
#: phases that serve a graph (each resets the counts before it and reads
#: them after)
GRAPH_LAUNCHES = dict.fromkeys(("rows", "blocks", "qrows", "f16rows",
                                "bf16rows"), 0)
#: where phase 5b builds K2 with its phase counters (tools/hop_split.py)
HOP_SPLIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "hop_split_clocks")
#: where phase 5b builds K5 with its phase counters (tools/graph_split.py)
GRAPH_SPLIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "graph_split_clocks")
#: where phase 8b builds K4 with its phase counters (tools/select_split.py)
SELECT_SPLIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "build", "select_split_clocks")
#: K2's launches on the main path, by scoring mode (ops/beam_search.MODES),
#: summed over the phases that drive a graph path (each resets the counts
#: before it and reads them after)
BEAM_LAUNCHES = dict.fromkeys(("rows", "blocks", "qrows", "f16rows",
                               "bf16rows"), 0)
#: the k2-capacity-8m probe: rows of its int8 and fp16 stores, their width
#: and the out-degree of its random layer-0 table
N_PROBE, PROBE_M = 8_388_608, 32
#: K4, the wave builder's neighbour selection: one launch a call of
#: core/build._diverse_select_dev
SELECT_KERNEL = {"route": "cuda",
                 "source": "hnsw_tpu_torch/csrc/diverse_select.cu",
                 "replaces": "hnsw_tpu/core/build.py:113"}
#: K4's launches on the main path, summed over phases 9 and 10 (each resets
#: the count before it and reads it after)
SELECT_LAUNCHES = {"diverse_select": 0}
#: phase 8b: a layer-0 call of phase 10's build (P = WAVE rows, C = n_cand
#: 64 + intra_k 32 candidates, deg = 2 m = 32), and the reverse update's
#: width (C = Wd 32 + deg 32)
SELECT_C, SELECT_DEG, SELECT_C_REVERSE = 96, 32, 64


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
    """Builds the three CUDA libraries and K2's and K4's clocked variants
    (one nvcc each, started together) and the native host engine."""
    import threading

    from hnsw_tpu_torch import native
    from hnsw_tpu_torch.ops import beam_search, diverse_select, exact_screen
    from hnsw_tpu_torch.tools import graph_split, hop_split, select_split
    took, errors = {}, []

    def load(name, fn):
        t = time.perf_counter()
        try:
            fn()
        except Exception as e:       # reported by the check below
            errors.append(f"{name}: {e}")
        took[name] = time.perf_counter() - t

    t0 = time.perf_counter()
    threads = [threading.Thread(target=load, args=a) for a in
               (("exact_screen.cu", exact_screen._load),
                ("beam_search.cu", beam_search._load),
                ("diverse_select.cu", diverse_select._load),
                ("beam_search.cu -DBEAM_PHASE_CLOCKS",
                 lambda: hop_split.clocks_library(HOP_SPLIT_DIR)),
                ("beam_search.cu -DGRAPH_PHASE_CLOCKS",
                 lambda: graph_split.clocks_library(GRAPH_SPLIT_DIR)),
                ("diverse_select.cu -DSELECT_PHASE_CLOCKS",
                 lambda: diverse_select.build((select_split.CLOCKS,),
                                              SELECT_SPLIT_DIR)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t1 = time.perf_counter()
    check(not errors, f"the CUDA libraries build and load {errors}")
    check(native.available(), "native host engine builds and loads")
    t2 = time.perf_counter()
    print("# build: " + ", ".join(f"{k} {v:.1f} s" for k, v in took.items())
          + f" (together {t1 - t0:.1f} s), native engine {t2 - t1:.1f} s",
          flush=True)


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
    exact_screen.launches_by_route.update(wgmma=0, wgmma_cp=0)


def _launches() -> dict:
    """K1's launches by route since the last _reset_launches()."""
    from hnsw_tpu_torch.ops import exact_screen
    return dict(exact_screen.launches_by_route)


def _cap_reset() -> None:
    from hnsw_tpu_torch.ops import exact_screen
    exact_screen.capacity_launches = exact_screen.capacity_plain_on_cuda = 0
    exact_screen.capacity_launches_by_store.update(int8=0, bf16=0, fp16=0)
    exact_screen.capacity_launches_by_route.update(wgmma=0, wgmma_ld=0,
                                                   bf16_ws=0)


def _cap_read(label: str, want: dict, routes: dict = None) -> dict:
    """The capacity screen's launches by store and by route since the
    last _cap_reset(), added to CAPACITY_LAUNCHES and
    CAPACITY_ROUTE_LAUNCHES. On the card, a failed check unless they
    equal ``want`` (the stores it leaves out: 0) and ``routes`` (by
    default the D = 128 tables' at a k = 10 pool: int8 and bf16 on
    "bf16_ws", fp16 on "wgmma"), and no capacity scan of a card table ran
    the plain version."""
    from hnsw_tpu_torch.ops import exact_screen
    by = dict(exact_screen.capacity_launches_by_store)
    by_route = dict(exact_screen.capacity_launches_by_route)
    for st, n in by.items():
        CAPACITY_LAUNCHES[st] += n
    for r, n in by_route.items():
        CAPACITY_ROUTE_LAUNCHES[r] += n
    if DEVICE == "cuda":
        full = {st: want.get(st, 0) for st in by}
        if routes is None:
            routes = {"bf16_ws": full["int8"] + full["bf16"],
                      "wgmma": full["fp16"]}
        full_routes = {r: routes.get(r, 0) for r in by_route}
        plain = exact_screen.capacity_plain_on_cuda
        check(by == full and by_route == full_routes and plain == 0,
              f"{label} launched the capacity screen {by} (want {full}), "
              f"by route {by_route} (want {full_routes}); plain scans of a "
              f"card table {plain} (want 0)")
    return by


def _beam_reset() -> None:
    from hnsw_tpu_torch.ops import beam_search, graph_search
    beam_search.launches = 0
    beam_search.launches_by_mode.update(dict.fromkeys(beam_search.MODES, 0))
    beam_search.twin_layers_on_cuda.update(mode=0, size=0, other=0)
    graph_search.launches = 0
    graph_search.launches_by_mode.update(dict.fromkeys(beam_search.MODES, 0))
    graph_search.plain_on_cuda.update(mode=0, size=0, other=0)


def _beam_read(label: str, need=(), need5=(), covered_only=False) -> dict:
    """K2's and K5's launches by mode since the last _beam_reset(), added
    to BEAM_LAUNCHES and GRAPH_LAUNCHES. On the card, a failed check unless
    K2 launched in every mode of ``need`` (the builder's layers), K5 in
    every mode of ``need5`` (the searches, by layer 0's mode), no layer of
    a mode K2 covers went to its twin (ops/beam_search.twin_layers_on_cuda
    "size" and "other") and no search K5 covers to its plain version
    (ops/graph_search.plain_on_cuda "size" and "other"); with
    ``covered_only`` (a phase that drives only modes both cover), nothing
    went to either at all."""
    from hnsw_tpu_torch.ops import beam_search, graph_search
    by = dict(beam_search.launches_by_mode)
    twin = dict(beam_search.twin_layers_on_cuda)
    by5 = dict(graph_search.launches_by_mode)
    plain = dict(graph_search.plain_on_cuda)
    for m, n in by.items():
        BEAM_LAUNCHES[m] += n
    for m, n in by5.items():
        GRAPH_LAUNCHES[m] += n
    if DEVICE == "cuda":
        check(all(by[m] > 0 for m in need) and all(by5[m] > 0 for m in need5)
              and twin["size"] == twin["other"] == 0
              and plain["size"] == plain["other"] == 0
              and ((twin["mode"] == 0 and plain["mode"] == 0)
                   or not covered_only),
              f"{label} launched K2 {by} (need {list(need)}) and K5 {by5} "
              f"(need {list(need5)}); layers K2's twin ran on the card "
              f"{twin}, searches the plain version ran {plain} (none of a "
              f"covered mode" + (", none at all)" if covered_only else
                                 "; by mode, those the kernels lack)"))
    return by


def _twin():
    """Inside the block every graph layer runs the plain twin
    (core/search.beam_search_layer_reference) and every search the plain
    composition of layers (core/search.search_graph_reference):
    ops/graph_search.plain(twin=True), which patches K2's and K5's
    predicates to say no and leaves what they so send to the plain
    versions out of twin_layers_on_cuda and plain_on_cuda."""
    from hnsw_tpu_torch.ops import graph_search
    return graph_search.plain(twin=True)


def _select_reset() -> None:
    from hnsw_tpu_torch.ops import diverse_select
    diverse_select.launches = 0
    diverse_select.plain_on_cuda.update(mode=0, size=0, other=0)


def _select_read(label: str) -> int:
    """K4's launches since the last _select_reset(), added to
    SELECT_LAUNCHES. On the card, a failed check unless it launched and no
    call went to the twin (every call of phases 9 and 10 is one K4
    covers: ops/diverse_select.plain_on_cuda all 0; the build that forces
    the twin restores the counts, _select_twin)."""
    from hnsw_tpu_torch.ops import diverse_select
    n = diverse_select.launches
    plain = dict(diverse_select.plain_on_cuda)
    SELECT_LAUNCHES["diverse_select"] += n
    if DEVICE == "cuda":
        check(n > 0 and not any(plain.values()),
              f"{label} launched the selection kernel {n} times; calls the "
              f"twin ran on the card {plain} (want none)")
    return n


@contextlib.contextmanager
def _select_twin():
    """Inside the block every neighbour selection runs the plain twin
    (core/build._diverse_select_reference): ops/diverse_select's predicate
    is patched to say no, and the calls it so sends to the twin are left
    out of plain_on_cuda."""
    from hnsw_tpu_torch.ops import diverse_select
    real = diverse_select.select_kernel_applies
    counts = dict(diverse_select.plain_on_cuda)
    diverse_select.select_kernel_applies = lambda *a, **kw: False
    try:
        yield
    finally:
        diverse_select.select_kernel_applies = real
        diverse_select.plain_on_cuda.update(counts)


def _add(a: dict, b: dict) -> dict:
    return {r: a.get(r, 0) + b.get(r, 0) for r in set(a) | set(b)}


def _time_screen(label, q, v, sq, valid, k_sel, metric, routes) -> dict:
    """The screen alone at one shape: each (route, fast_math) kernel
    through the private launcher, the plain version and the library
    yardstick (torch.cdist + torch.topk, l2 only; the port never calls
    it). Each time is printed beside its bound (utils/roofline.
    screen_bound_s) and share of the bound.
    Returns {"<route>[_fast]": (ms, bound_ms, bound_by, max_abs_err)}
    plus "plain" and "library" ms."""
    from hnsw_tpu_torch.ops import exact_screen as es
    from hnsw_tpu_torch.utils import roofline
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
        bound_s, by, peak = roofline.screen_bound_s(nq, n, d, k_sel, fast)
        bound = bound_s * 1e3
        passes, _, how = roofline.SCREEN_PRODUCT[fast]
        key = route + ("_fast" if fast else "")
        out[key] = (ms, bound, by, err)
        print(f"  {route} fast_math={fast}: {ms:.3f} ms, bound {bound:.3f} "
              f"ms ({by}: {how}, {passes} pass(es) at {peak / 1e12:g} "
              f"TFLOP/s), {bound / ms:.3f} of the bound", flush=True)
    lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "n/a"
    print(f"  plain (exact_screen_reference) {plain_ms:.3f} ms; library "
          f"yardstick torch.topk(torch.cdist) {lib}", flush=True)
    return out


def _cap_tables(v: torch.Tensor) -> dict:
    """The capacity modes' tables of the f32 rows ``v``, made on the card
    as ExactIndex makes them: {store: (table, scales or None)}."""
    amax = v.abs().amax(dim=1)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return {"int8": (torch.clamp(torch.round(v / s[:, None]), -127,
                                 127).to(torch.int8), s),
            "bf16": (v.to(torch.bfloat16), None),
            "fp16": (v.to(torch.float16), None)}


def _time_capacity(label, q, v, sq, valid, metric, stores,
                   kk_by_store=CAPACITY_KK, library=False) -> dict:
    """The capacity screen against its plain version at one shape: for
    each store, capacity_scan (the kernel of the route capacity_route
    picks: capacity_applies holds) beside ops/topk.
    quantized_topk_candidates on the same tensors, held to id overlap >=
    0.999 and matched distances within 1e-5 relative; where that route is
    "bf16_ws", K1's kernel with the table's store ("wgmma", the route
    before it) is held and timed beside it. Each timed (median of 5
    CUDA-event reps) beside its bound (utils/roofline.screen_bound_s by
    store). ``kk_by_store``: the pool a store's scan keeps (the k = 10
    pools by default). ``library``: also time the yardstick
    torch.topk(torch.cdist(q, table.float() (* scales))), which the port
    never calls. Returns {store: {"route", "ms", "bound_ms", "bound_by",
    "err", "plain_ms", "old_ms" (or None), "old_err", "library_ms"}}."""
    from hnsw_tpu_torch.ops import exact_screen as es
    from hnsw_tpu_torch.ops.topk import quantized_topk_candidates
    from hnsw_tpu_torch.utils import roofline
    nq, d = q.shape
    n = v.shape[0]
    tables = _cap_tables(v)
    out = {}
    print(f"# capacity screen, {label}: Q={nq} N={n} D={d} {metric} "
          f"({int(valid.sum())} valid rows; median of 5 CUDA-event reps)",
          flush=True)
    for store in stores:
        t, s = tables[store]
        kk = min(kk_by_store[store], n)
        route = es.capacity_route(q, t, kk)
        check(es.capacity_applies(n, kk, metric, t, s),
              f"{store}: capacity_applies at N={n}, kk={kk}")

        def kern():
            return es.capacity_scan(q, t, s, sq, valid, kk=kk, metric=metric)

        def old():
            return es._capacity_cuda(q, t, s, sq, valid, kk, metric, "wgmma")

        def plain():
            return quantized_topk_candidates(q, t, s, sq, valid, kk=kk,
                                             metric=metric)
        dp, ip = (x.cpu().numpy() for x in plain())

        def hold(run, name):
            _cap_reset()
            dk, ik = (x.cpu().numpy() for x in run())
            check(es.capacity_launches_by_store[store] == 1
                  and es.capacity_launches_by_route[name] == 1,
                  f"{store}: one launch of the capacity screen ({name})")
            ov = _overlap(ik, ip)
            err = _matched_err(dk, ik, dp, ip)
            same = (ik == ip) & (ik >= 0)
            rel = float(np.max(np.abs(dk[same] - dp[same])
                               / np.maximum(np.abs(dp[same]), 1e-30)))
            check(ik.shape == (nq, kk) and np.isfinite(dk).all()
                  and ov >= 0.999 and rel <= 1e-5,
                  f"{store} capacity screen ({name}) vs plain: finite "
                  f"[{nq}, {kk}], id overlap {ov:.5f} >= 0.999, matched "
                  f"dists within 1e-5 relative ({rel:.2e}; {err:.2e} "
                  f"absolute)")
            return err
        err = hold(kern, route)
        ms = cuda_ms(kern)
        old_ms = old_err = None
        if route == "bf16_ws":
            old_err = hold(old, "wgmma")
            old_ms = cuda_ms(old)
        plain_ms = cuda_ms(plain)
        lib_ms = None
        if library:
            vf = t.float() * (s[:, None] if s is not None else 1.0)
            lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(q, vf), kk,
                                                largest=False))
            del vf
        bound_s, by, peak = roofline.screen_bound_s(nq, n, d, kk,
                                                    store=store)
        bound = bound_s * 1e3
        passes, _, how = roofline.CAPACITY_PRODUCT[store]
        out[store] = dict(route=route, ms=ms, bound_ms=bound, bound_by=by,
                          err=err, plain_ms=plain_ms, old_ms=old_ms,
                          old_err=old_err, library_ms=lib_ms)
        was = (f"; K1's kernel (wgmma) {old_ms:.3f} ms"
               if old_ms is not None else "")
        lib = (f"; library torch.topk(torch.cdist) {lib_ms:.3f} ms"
               if lib_ms is not None else "")
        print(f"  {store} ({route}, kk={kk}): {ms:.3f} ms, bound "
              f"{bound:.3f} ms ({by}: {how}, {passes} pass(es) at "
              f"{peak / 1e12:g} TFLOP/s), {bound / ms:.3f} of the bound{was};"
              f" plain (quantized_topk_candidates) {plain_ms:.3f} ms{lib}",
              flush=True)
    return out


def phase_kernel_vs_plain() -> dict:
    """exact_topk_fused through each K1 route against the plain screen in
    its place, both reranked in f32 on the card; then the screen alone
    timed per route."""
    from hnsw_tpu_torch.index.exact import _pad_queries
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
    # the other widths that TMA cannot take: glove-25-angular, lastfm-64-
    # dot (65 columns, scored as cosine by ANN-benchmarks), a D=128 view 4
    # bytes past 16-byte alignment (4-byte copies) and a small D=7 table
    for label, n, d, metric in ((f"GloVe-25 shape N={N_GLOVE}", N_GLOVE,
                                 25, "cosine"),
                                ("lastfm-64 shape N=292385", 292_385, 65,
                                 "cosine"),
                                ("D=7 table N=40000", 40_000, 7, "l2")):
        tab = table(n, n, d)
        q_t = torch.randn((1000, d), generator=gen, device="cuda")
        cases += [(f"{label} D={d} Q=1000 {metric} fast={f}", q_t, tab,
                   10, metric, f) for f in (False, True)]
    v_off = torch.randn(300_000 * DIM + 1, generator=gen,
                        device="cuda")[1:].view(300_000, DIM)
    cases += [(f"D=128 view 4 bytes past 16-byte alignment N=300000 "
               f"Q=1000 l2 fast={f}", q_big,
               (v_off, (v_off * v_off).sum(-1),
                torch.ones(300_000, dtype=torch.bool, device="cuda")), 10,
               "l2", f) for f in (False, True)]
    # the adaptive engine's exact arm and recall probes (phase 12):
    # N_GRAPH rows in a table padded to a power of two, cosine, batches
    # of BATCH and single queries (below)
    n_adp = 1 << (N_GRAPH - 1).bit_length()
    adp = table(n_adp, N_GRAPH)
    q_adp = torch.randn((BATCH, DIM), generator=gen, device="cuda")
    cases += [(f"adaptive exact arm N={n_adp} ({N_GRAPH} valid) Q={BATCH} "
               f"cosine fast={f}", q_adp, adp, 10, "cosine", f)
              for f in (False, True)]

    max_err = {"wgmma": 0.0, "wgmma_cp": 0.0}
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
        tma = (q.shape[1] % 4 == 0 and q.data_ptr() % 16 == 0
               and v.data_ptr() % 16 == 0)
        check(route == ("wgmma" if tma else "wgmma_cp"),
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

    # single queries as the exact tier hands them to the kernel: padded
    # with zero rows to 8, one launch a query; row 0 is compared
    v, sq, valid = adp
    singles = [torch.from_numpy(_pad_queries(
        q_adp[i:i + 1].cpu().numpy())).cuda() for i in range(32)]
    for fast in (False, True):
        label = (f"adaptive exact arm N={n_adp} single queries "
                 f"(Q=1 padded to {singles[0].shape[0]}) cosine fast={fast}")
        _reset_launches()
        got = [exact_topk_fused(q, v, sq, valid, k=10, metric="cosine",
                                fast_math=fast) for q in singles]
        check(_launches() == {"wgmma": len(singles), "wgmma_cp": 0},
              f"{label}: one launch of the wgmma kernel a query")
        dk, ik = (torch.cat([g[j][:1] for g in got]).cpu().numpy()
                  for j in (0, 1))
        want = []
        for q in singles:
            _, ids = exact_screen_reference(q, v, sq, valid, k_sel=18,
                                            metric="cosine", fast_math=fast)
            want.append(rerank_pool(q, v, sq, ids, k=10, metric="cosine"))
        dp, ip = (torch.cat([w[j][:1] for w in want]).cpu().numpy()
                  for j in (0, 1))
        err = _matched_err(dk, ik, dp, ip)
        max_err["wgmma"] = max(max_err["wgmma"], err)
        if fast:
            ov = _overlap(ik, ip)
            check(ov >= 0.99 and err <= 1e-5,
                  f"{label}: id overlap {ov:.5f} >= 0.99 over "
                  f"{len(singles)} queries, matched dists within 1e-5 "
                  f"({err:.2e})")
        else:
            check(np.array_equal(ik, ip) and np.isfinite(dk).all()
                  and err <= 1e-5,
                  f"{label}: ids equal over {len(singles)} queries, dists "
                  f"within 1e-5 ({err:.2e})")
        q = singles[0]
        t_k = cuda_ms(lambda: exact_topk_fused(
            q, v, sq, valid, k=10, metric="cosine", fast_math=fast))
        print(f"  {label}: kernel (wgmma) {t_k:.3f} ms a query", flush=True)
    del adp, singles, got, want

    del cases, tab, v_off
    # the screen alone at the exact tier's shapes (Q padded to 1024): the
    # TMA producer, and the cp.async producer at the same shape
    q = torch.randn((1024, DIM), generator=gen, device="cuda")
    v, sq, valid = big
    sift = _time_screen("SIFT1M shape", q, v, sq, valid, 18, "l2",
                        [("wgmma", False), ("wgmma", True),
                         ("wgmma_cp", False), ("wgmma_cp", True)])
    # the capacity screen at the same shape: each store's table of the
    # same rows (TMA; int8 and bf16 on "bf16_ws", K1's kernel beside it),
    # with the library yardstick; then kk 150 (int8 at k = 100: pool k + k
    # // 2) and 256 (the screen's limit), past "bf16_ws"'s block
    cap = _time_capacity("SIFT1M shape", q, v, sq, valid, "l2",
                         ("int8", "bf16", "fp16"), library=True)
    cap150 = _time_capacity("SIFT1M shape, kk 150", q, v, sq, valid, "l2",
                            ("int8", "bf16"), {"int8": 150, "bf16": 150})
    cap256 = _time_capacity("SIFT1M shape, kk 256", q, v, sq, valid, "l2",
                            ("int8", "bf16"), {"int8": 256, "bf16": 256})
    # below K1's 32,768-row switch, which the capacity screen does not
    # have: a streaming chunk's tail, a small shard, a small index; a
    # full batch and a batch of 8 queries
    small = {}
    for n_small in (1_000, 8_192, 32_767):
        for nq_small in (1024, 8):
            small[(n_small, nq_small)] = _time_capacity(
                f"below the row switch, N={n_small}, Q={nq_small}",
                q[:nq_small], v[:n_small], sq[:n_small], valid[:n_small],
                "l2", ("int8", "bf16", "fp16"))
    del big, v, sq, valid
    torch.cuda.empty_cache()
    # the cp.async producer where the main path sends it: GloVe-50's D = 50
    v, sq, valid = glove
    q = torch.randn((1024, D_GLOVE), generator=gen, device="cuda")
    glv = _time_screen("GloVe-50 shape", q, v, sq, valid, 18, "l2",
                       [("wgmma_cp", False), ("wgmma_cp", True)])
    # int8 rows of 50 bytes and bf16 rows of 100: no TMA, so K1's kernel
    # on ordinary loads ("bf16_ws" needs TMA's 16-byte pitch)
    cap_glv = _time_capacity("GloVe-50 shape", q, v, sq, valid, "cosine",
                             ("int8", "bf16"))
    del glove, v, sq, valid
    torch.cuda.empty_cache()

    every = (cap, cap150, cap256, cap_glv, *small.values())

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
                          cp_same_shape_ms=sift["wgmma_cp"][0]),
            "wgmma_cp": dict(entry("exact_screen_wgmma_cp", glv, "wgmma_cp",
                                   max_err["wgmma_cp"]),
                             fast_math_ms=glv["wgmma_cp_fast"][0]),
            # K1's kernel with the table's store: the fp16 rung's screen
            # at the SIFT1M shape stands for the entry (int8 and bf16 at
            # k = 10 moved to "bf16_ws"; their times on this kernel beside)
            "capacity": dict(
                CAPACITY_KERNEL, name="capacity_screen", store="fp16",
                max_abs_err=max(t["old_err"] if t["route"] == "bf16_ws"
                                else t["err"] for c in every for t in
                                c.values()),
                ms=cap["fp16"]["ms"], plain_ms=cap["fp16"]["plain_ms"],
                bound_ms=cap["fp16"]["bound_ms"],
                bound_by=cap["fp16"]["bound_by"],
                library_ms=cap["fp16"]["library_ms"],
                ms_by_store={st: t["old_ms"] or t["ms"]
                             for st, t in cap.items()},
                kk150_ms={st: t["ms"] for st, t in cap150.items()},
                kk256_ms={st: t["ms"] for st, t in cap256.items()},
                glove50_ms_by_store={st: t["ms"]
                                     for st, t in cap_glv.items()},
                small_ms={f"{st} N={n_} Q={q_}": [t["old_ms"] or t["ms"],
                                                  t["plain_ms"]]
                          for (n_, q_), c in small.items()
                          for st, t in c.items()}),
            # the warp-specialised bf16 kernel: the int8 rung's screen at
            # the SIFT1M shape (kk 26) stands for the entry
            "capacity_ws": dict(
                CAPACITY_WS_KERNEL, name="capacity_screen_ws", store="int8",
                max_abs_err=max(t["err"] for c in every for t in c.values()
                                if t["route"] == "bf16_ws"),
                ms=cap["int8"]["ms"], plain_ms=cap["int8"]["plain_ms"],
                bound_ms=cap["int8"]["bound_ms"],
                bound_by=cap["int8"]["bound_by"],
                library_ms=cap["int8"]["library_ms"],
                ms_by_store={st: cap[st]["ms"] for st in ("int8", "bf16")},
                old_route_ms_by_store={st: cap[st]["old_ms"]
                                       for st in ("int8", "bf16")},
                bound_ms_by_store={st: cap[st]["bound_ms"]
                                   for st in ("int8", "bf16")},
                plain_ms_by_store={st: cap[st]["plain_ms"]
                                   for st in ("int8", "bf16")},
                library_ms_by_store={st: cap[st]["library_ms"]
                                     for st in ("int8", "bf16")},
                small_ms={f"{st} N={n_} Q={q_}": [t["ms"], t["old_ms"],
                                                  t["plain_ms"]]
                          for (n_, q_), c in small.items()
                          for st, t in c.items()
                          if t["route"] == "bf16_ws"})}


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


def _profile(label: str, fn, need: str = "screen_wgmma_kernel"):
    """One call of ``fn`` (after a warm-up) in a padded device trace
    (utils/profiling.trace_summary): its wall time, the device time of its
    kernels and copies, its kernel launches, the three largest by name,
    and the device's idle share of the wall. Returns that as a dict, or
    None (with a note) when the trace holds no event whose name contains
    ``need`` (K1's kernel by default): a trace that lost events would give
    a false split."""
    from hnsw_tpu_torch.utils.profiling import trace_summary
    fn()
    torch.cuda.synchronize()
    out = trace_summary(fn)
    if out is None or not any(need in n for n in out["by_name"]):
        print(f"  profile, {label}: the trace holds no {need} event; "
              f"device split not measured", flush=True)
        return None
    top = sorted(out["by_name"].items(), key=lambda kv: -kv[1])[:3]
    print(f"  profile, {label}: wall {out['wall_ms']:.3f} ms, device "
          f"{out['device_ms']:.3f} ms, {out['launches']} kernel launches, "
          f"idle share {out['idle_share']:.3f}; "
          + "; ".join(f"{n[:60]} {ms:.3f} ms" for n, ms in top),
          flush=True)
    return out


def _device_work(fn) -> tuple:
    """(kernel launches, device ms) of one call of ``fn`` in a padded
    device trace (utils/profiling.trace_summary; (0, 0.0) when it held no
    kernel); (None, 0.0) off CUDA."""
    from hnsw_tpu_torch.utils.profiling import trace_summary
    if DEVICE != "cuda":
        fn()
        return None, 0.0
    out = trace_summary(fn)
    return (0, 0.0) if out is None else (out["launches"], out["device_ms"])


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
        check(by == {"wgmma": 10, "wgmma_cp": 0},
              f"fast_math={fast}: 10 batches launched the wgmma kernel "
              f"{by['wgmma']} times, the wgmma_cp route {by['wgmma_cp']} times")
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
    sends K1 down its cp.async producer. Returns K1's launches by route."""
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
    check(by == {"wgmma": 0, "wgmma_cp": 10}, f"glove-50 shape: 10 "
          f"batches launched the wgmma_cp route {by['wgmma_cp']} times, the "
          f"wgmma route {by['wgmma']} times")
    d0, i0 = out[0]
    rec = _recall(i0, gt, 10)
    check(np.isfinite(d0).all() and i0.shape == (1000, 10) and rec == 1.0,
          f"glove-50 shape: finite [1000, 10] results, recall@10 "
          f"{rec:.4f} == 1 against the numpy oracle (1000 queries)")
    qps = _qps(serve, len(queries))
    print(f"  exact tier at glove-50's shape ({N_GLOVE} x {D_GLOVE} cosine, "
          f"wgmma_cp route): {qps:.1f} QPS (10,000 queries in batches of "
          f"1000, "
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
    g.native_serve_max_batch = 0
    oracle = ExactIndex(metric="cosine", device=DEVICE)
    oracle.host_serve_max_batch = 0
    # the native builder inserts in key order, so the build pauses at
    # phase 9's prefix: the recall of that prefix graph is the floor of
    # phase 9's wave builds of the same rows
    n_pre = N_DEVICE_BUILD
    t0 = time.perf_counter()
    g.build(list(range(n_pre)), base[:n_pre], method="host")
    t_build = time.perf_counter() - t0
    oracle.batch_add(list(range(n_pre)), base[:n_pre])
    _, gt_pre = oracle.batch_search_slots(queries, 10)
    prefix_recall = _graph_recalls(g, queries, gt_pre,
                                   f"native build of the first {n_pre}")
    t0 = time.perf_counter()
    g.build(list(range(n_pre, N_GRAPH)), base[n_pre:], method="host")
    t_build += time.perf_counter() - t0
    print(f"# graph tier: native build of {N_GRAPH} x {DIM} cosine "
          f"{t_build:.1f} s, {g.num_layers} layers (at its first {n_pre} "
          f"rows: recall@10 {prefix_recall[64]:.4f} / "
          f"{prefix_recall[192]:.4f} at ef 64 / 192)", flush=True)
    oracle.batch_add(list(range(n_pre, N_GRAPH)), base[n_pre:])
    _, gt = oracle.batch_search_slots(queries, 10)

    cpu = graph_from_host_arrays(
        g.cfg, g.slots.slot_to_key, g.store.vectors[:g.slots.capacity_used],
        g.store.alive[:g.slots.capacity_used], *g.host.arrays(),
        device="cpu")
    cpu.native_serve_max_batch = 0
    recall, qps_by_ef = {}, {}
    _beam_reset()
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
        qps_by_ef[ef] = qps
        print(f"  graph tier ef={ef}: {qps:.1f} QPS (1024-query batch, "
              f"median of 3), recall@10 {recall[ef]:.4f} vs the "
              f"exact tier, hops per layer (top..0) {hops}", flush=True)
        if ef == 64:
            dense_ids = ids
    _beam_read("phase 5 (the graph tier)", need5=("rows",),
               covered_only=True)
    from hnsw_tpu_torch.ops import beam_search, graph_search
    _beam_reset()
    g.batch_search_slots(queries, 10, ef=64)
    n5, n2 = graph_search.launches, beam_search.launches
    check(n5 == 1 and n2 == 0, f"one 1024-query batch: K5 launched {n5} "
          f"time(s) (want 1), K2 {n2} (want 0)")
    _beam_read("phase 5 (one batch)", need5=("rows",), covered_only=True)
    # the same graph and batch through the parent's path (the plain
    # composition: one K2 launch a layer, graph_search.plain()) and, in the
    # default mode, through the plain twin; one traced batch each way:
    # launches and the device's idle share; default and bench's mode
    twin, parent = {}, {}
    bench = dict(fast_math=True, block_layout=True, entry_mode="pivots")
    for mode, attrs in (("default", {}), ("bench", bench)):
        saved = {k: getattr(g, k) for k in attrs}
        for k, v in attrs.items():
            setattr(g, k, v)
        for ef in (64, 192):
            batch = (lambda: g.batch_search_slots(queries, 10, ef=ef))
            _, ids_k = batch()
            hops_k = list(g.last_search_hops)
            qps_k = _qps(batch, 1024)
            rec_k = _recall(ids_k, gt, 10)
            with graph_search.plain():
                _, ids_p = batch()
                hops_p = list(g.last_search_hops)
                qps_p = _qps(batch, 1024)
            rec_p = _recall(ids_p, gt, 10)
            parent[mode, ef] = {"recall": rec_p, "qps": qps_p}
            check(abs(rec_k - rec_p) <= 0.005 and hops_k == hops_p,
                  f"{mode} ef={ef}: recall@10 through K5 {rec_k:.4f} "
                  f"within 0.005 of the plain version's (K2 a layer) "
                  f"{rec_p:.4f}, hops a layer {hops_k} == {hops_p}")
            line = (f"  graph tier {mode} ef={ef}: K5 {qps_k:.1f} QPS, "
                    f"recall@10 {rec_k:.4f}; the parent's path (K2 a layer, "
                    f"graph_search.plain()) {qps_p:.1f} QPS "
                    f"({qps_k / qps_p:.2f}x), recall@10 {rec_p:.4f}")
            if mode == "default":
                with _twin():
                    _, ids_t = batch()
                    hops_t = list(g.last_search_hops)
                    qps_t = _qps(batch, 1024)
                rec_t = _recall(ids_t, gt, 10)
                twin[ef] = {"recall": rec_t, "qps": qps_t}
                check(abs(rec_k - rec_t) <= 0.005 and hops_k == hops_t,
                      f"ef={ef}: recall@10 through K5 {rec_k:.4f} within "
                      f"0.005 of the twin's {rec_t:.4f} on the same graph, "
                      f"hops a layer {hops_k} == {hops_t}")
                line += (f"; the plain twin (search_graph_reference over "
                         f"beam_search_layer_reference) {qps_t:.1f} QPS, "
                         f"recall@10 {rec_t:.4f}")
            print(line + f"; hops per layer (top..0) {hops_k}", flush=True)
            if DEVICE == "cuda":
                _profile(f"one 1024-query graph batch, {mode} ef={ef}, K5",
                         batch, need="graph_search_kernel")
                with graph_search.plain():
                    _profile(f"one 1024-query graph batch, {mode} ef={ef}, "
                             f"the parent's path (K2 a layer)", batch,
                             need="beam_search_kernel")
                if mode == "default" and ef == 64:
                    with _twin():
                        _profile(f"one 1024-query graph batch, {mode} "
                                 f"ef={ef}, twin", batch, need="")
        for k, v in saved.items():
            setattr(g, k, v)
    # what ran to compare with the plain versions is not the main path
    _beam_reset()
    del oracle
    torch.cuda.empty_cache()
    return {"g": g, "cpu": cpu, "base": base, "queries": queries, "gt": gt,
            "dense_ids_ef64": dense_ids, "prefix_recall": prefix_recall,
            "recall": recall, "qps": qps_by_ef, "twin": twin,
            "parent": parent}


#: bytes a scored row reads in each of K2's row modes at width D (the row
#: and its squared norm; the int8 rows also their scale)
ROW_BYTES = {"rows": lambda D: 4 * D + 4, "qrows": lambda D: D + 4 + 4,
             "f16rows": lambda D: 2 * D + 4, "bf16rows": lambda D: 2 * D + 4}


def _beam_case(label: str, c: dict) -> dict:
    """One captured layer-0 call (tools/hop_split.layer0_call) through K2
    (ops/beam_search.beam_search_cuda) and through its twin
    (core/search.beam_search_layer_reference) on the same inputs: a failed
    check unless the ids overlap >= 0.999, the hop counts are equal and
    the distances of shared ids agree within 1e-5 (every product is exact
    in f32 or rounded once on both sides, so only the order of f32 sums
    differs), or 1e-3 on int8 blocks (their squared norms are f32 sums
    rounded to bf16, where one ulp of the sum may flip a rounding). Times
    both (median of 5 CUDA-event reps) and puts the kernel beside two bounds
    (utils/roofline.hop_bound_s, each mode's bytes a row): the distinct
    nodes and rows the batch reads (from the twin's ``touched`` ids), and
    the same work without reuse across queries (the kernel's own counts of
    nodes expanded and rows scored)."""
    from hnsw_tpu_torch.core import search
    from hnsw_tpu_torch.ops import beam_search
    from hnsw_tpu_torch.tools import hop_split
    from hnsw_tpu_torch.utils import roofline
    cg, args = c["g"], c["args"]
    kw = hop_split.case_kwargs(c)
    E = max(1, min(kw["expand"], kw["pool_size"]))
    mode = beam_search.layer_mode(cg, 0, kw["metric"], kw["pool_size"], E,
                                  kw["merge"])
    check(mode is not None, f"{label}: the kernel takes layer 0 ({mode})")

    def kern():
        return beam_search.beam_search_cuda(cg, 0, *args, **kw)

    def twin():
        return search.beam_search_layer_reference(cg, 0, *args, **kw)

    kd, ki, khops, work = kern()
    ts, touched = {}, {}
    td, ti = search.beam_search_layer_reference(cg, 0, *args, stats=ts,
                                                touched=touched, **kw)
    kd, ki, td, ti = (t.cpu().numpy() for t in (kd, ki, td, ti))
    ov = _overlap(ki, ti)
    err = _matched_err(kd, ki, td, ti)
    store = (cg.nbr_blocks if mode == "blocks" else cg.qvec
             if mode == "qrows" else cg.vectors)
    int8 = store.dtype == torch.int8
    tol = 1e-3 if int8 and mode == "blocks" else 1e-5
    start_ids = args[2]
    S = start_ids.shape[1] if start_ids.ndim == 2 else 1
    hops = int(khops.max())
    check(np.isfinite(kd).all() and ov >= 0.999 and err <= tol
          and hops == ts["hops"][0],
          f"{label} ({mode}, {kw['merge']}, P={kw['pool_size']}, E={E}, "
          f"S={S}, {kw['precision']}): id overlap {ov:.5f} >= 0.999, "
          f"matched dists within {tol:g} ({err:.2e}), hops {hops} == the "
          f"twin's {ts['hops'][0]}")
    ms, twin_ms = cuda_ms(kern), cuda_ms(twin)
    w = work.sum(0).tolist()
    nodes = torch.cat(touched.get("nodes", [torch.empty(0)]))
    rows = torch.cat(touched.get("rows", [torch.empty(0)]))
    n_nodes, n_rows = (int(torch.unique(t).numel()) for t in (nodes, rows))
    D = cg.dim
    # the operands' type: int8 elements, else bf16 where the query is
    # rounded (f32 rows then are too), else f32
    kind = ("int8" if int8 else "bf16" if beam_search.rounds_operands(
        beam_search.score_code(cg, mode, kw["precision"]), kw["precision"])
        else "fp32")
    if mode == "blocks":
        row_bytes = D * cg.nbr_blocks.element_size()
        M = min(cg.layer_width(0), cg.nbr_blocks.shape[1])
    else:
        row_bytes = ROW_BYTES[mode](D)
        M = cg.layer_width(0)
    B, P = len(args[0]), kw["pool_size"]
    bound_s, by = roofline.hop_bound_s(B, D, P, S, M, n_nodes, n_rows, w[1],
                                       row_bytes, kind)
    flat_s, _ = roofline.hop_bound_s(B, D, P, S, M, w[0], w[1], w[1],
                                     row_bytes, kind)
    bound, flat = bound_s * 1e3, flat_s * 1e3
    us_hop = ms * 1e3 / max(1, hops)
    lib = beam_search._load()
    per_sm = hop_split.occupancy(lib, c)
    score, vec = hop_split.instantiation(c)
    inst = (f"{hop_split.SCORE_NAMES[score]}/"
            f"{'vec' if vec else 'scalar'}")
    with open(os.path.join(beam_search.BUILD_DIR,
                           "beam_search.ptxas.txt")) as f:
        regs = hop_split.parse_ptxas(f.read()).get(inst, {})
    print(f"  {label}: overlap {ov:.5f}, max |d| err {err:.2e}; hops "
          f"kernel {hops} (mean {khops.float().mean():.1f}) "
          f"twin {ts['hops'][0]}; kernel counts {w[0]} nodes expanded, "
          f"{w[1]} rows scored (twin {nodes.numel()}, {rows.numel()}), of "
          f"them distinct {n_nodes} nodes, {n_rows} rows; kernel {ms:.3f} "
          f"ms ({us_hop:.2f} us a hop of the slowest query; {inst}: "
          f"{per_sm} blocks an SM, {regs.get('registers')} registers, "
          f"{regs.get('spill_stores')} B spill stores), bound {bound:.4f} "
          f"ms ({by}), {bound / ms:.4f} of the bound (without reuse across "
          f"queries {flat:.4f} ms, {flat / ms:.4f}); twin {twin_ms:.3f} ms",
          flush=True)
    return {"mode": mode, "ms": ms, "plain_ms": twin_ms, "bound_ms": bound,
            "bound_by": by, "no_reuse_bound_ms": flat, "max_abs_err": err,
            "overlap": ov, "hops": hops, "twin_hops": ts["hops"][0],
            "us_per_hop": us_hop,
            "blocks_per_sm": per_sm, "registers": regs.get("registers"),
            "spill_stores": regs.get("spill_stores"),
            "expanded": w[0], "scored": w[1], "distinct_nodes": n_nodes,
            "distinct_rows": n_rows}


def _capture_search(g, queries: np.ndarray, ef: int) -> dict:
    """The arguments of the core/search.search_graph call that
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


def _graph_case(label: str, c: dict) -> dict:
    """One captured search (``_capture_search``) through K5
    (core/search.search_graph: one launch of
    ops/graph_search.graph_search_cuda, its q_sq included), through its
    plain version in plain PyTorch (core/search.search_graph_reference with
    K2's twin a layer) and through the parent's path (the same composition
    with one K2 launch a layer and a host sync a layer) on the same inputs:
    a failed check unless the ids overlap >= 0.999, the distances of shared
    ids agree within 1e-5 x max(1, |d|) (1e-3 on int8 blocks that no f32
    rerank rescored, as K2) and
    the hop counts a layer are equal. Times the three (median of 5
    CUDA-event reps, one call each) and puts K5 beside
    utils/roofline.search_bound_s: each layer's distinct node ids and rows
    (the twin's ``touched`` ids) and the rerank's distinct rows."""
    from hnsw_tpu_torch.core import search
    from hnsw_tpu_torch.ops import beam_search, graph_search
    from hnsw_tpu_torch.tools import hop_split
    from hnsw_tpu_torch.utils import roofline
    dg, q, kw = c["g"], c["q"], c["kw"]
    metric = kw["metric"]
    ks, ts, touched = {}, {}, []
    _beam_reset()
    kd, ki = search.results_to_host(*search.search_graph(dg, q, stats=ks,
                                                         **kw), ks)
    check(graph_search.launches == 1 and beam_search.launches == 0,
          f"{label}: one K5 launch ({graph_search.launches}), no K2 launch "
          f"({beam_search.launches})")
    _beam_reset()
    with _twin():
        td, ti = search.results_to_host(*search.search_graph_reference(
            dg, q, stats=ts, touched=touched, **kw), ts)
    ov = _overlap(ki, ti)
    err = abs_err = 0.0
    for rk, rki, rt, rti in zip(kd, ki, td, ti):
        pos = {int(x): j for j, x in enumerate(rki) if x >= 0}
        for j, x in enumerate(rti):
            if x >= 0 and int(x) in pos:
                a, b = float(rk[pos[int(x)]]), float(rt[j])
                abs_err = max(abs_err, abs(a - b))
                err = max(err, abs(a - b) / max(1.0, abs(b)))
    P0 = max(kw["ef"], kw["k"])
    mode0 = beam_search.layer_mode(dg, 0, metric, P0, kw.get("expand", 1),
                                   kw.get("merge", "sort"))
    blocks_int8 = mode0 == "blocks" and dg.nbr_blocks.dtype == torch.int8
    # the f32 rerank reports full f32 distances; 1e-3 only for int8 block
    # distances that reach the output as layer 0 scored them
    rerank = (kw.get("device_rerank", True)
              and (kw.get("fast_math", False) or dg.qvec is not None)
              and dg.vectors.shape[0] > 1)
    tol = 1e-3 if blocks_int8 and not rerank else 1e-5
    check(np.isfinite(kd).all() and ov >= 0.999 and err <= tol
          and ks["hops"] == ts["hops"],
          f"{label} (layer 0 {mode0}): K5 against the plain version: id "
          f"overlap {ov:.5f} >= 0.999, matched dists within {tol:g} x "
          f"max(1, |d|) ({err:.2e}), hops a layer {ks['hops']} == "
          f"{ts['hops']}")
    ms = cuda_ms(lambda: search.search_graph(dg, q, **kw))
    with graph_search.plain():
        parent_ms = cuda_ms(lambda: search.search_graph(dg, q, **kw))
    with _twin():
        plain_ms = cuda_ms(lambda: search.search_graph_reference(dg, q,
                                                                 **kw))
    _beam_reset()
    # the bound: each layer searched (top first) at its pool and width
    seeded = kw.get("seed_ids") is not None
    layer_ids = [0] if seeded else list(range(dg.num_layers - 1, -1, -1))
    P_up = kw.get("ef_upper", 0) or min(8, P0)
    precision = "default" if kw.get("fast_math") else "highest"
    layers, every_read = [], []
    for layer, t in zip(layer_ids, touched):
        P = P0 if layer == 0 else P_up
        E = max(1, min(kw.get("expand", 1), P))
        mode = beam_search.layer_mode(dg, layer, metric, P, E,
                                      kw.get("merge", "sort"))
        score = beam_search.score_code(dg, mode, precision)
        int8 = (mode == "qrows" or (mode == "blocks"
                                    and dg.nbr_blocks.dtype == torch.int8))
        kind = ("int8" if int8 else "bf16" if beam_search.rounds_operands(
            score, precision) else "fp32")
        if mode == "blocks":
            width = min(dg.layer_width(0), dg.nbr_blocks.shape[1])
            row_bytes = dg.dim * dg.nbr_blocks.element_size()
        else:
            width = dg.layer_width(layer)
            row_bytes = ROW_BYTES[mode](dg.dim)
        nodes = torch.cat(t.get("nodes", [torch.empty(0)]))
        rows = torch.cat(t.get("rows", [torch.empty(0)]))
        layers.append((width, int(torch.unique(nodes).numel()),
                       int(torch.unique(rows).numel()), int(rows.numel()),
                       row_bytes, kind))
        # without reuse across queries: every node and row read again
        every_read.append((width, int(nodes.numel()), int(rows.numel()),
                           int(rows.numel()), row_bytes, kind))
    rr_rows = rr_scored = 0
    if len(touched) > len(layer_ids):
        rr = touched[-1]["rows"][0]
        rr_rows, rr_scored = int(torch.unique(rr).numel()), int(rr.numel())
    rr_bytes = dg.dim * dg.vectors.element_size() + 4
    S = kw["seed_ids"].shape[1] if seeded else 1
    bound_s, by = roofline.search_bound_s(len(q), dg.dim, kw["k"], S, layers,
                                          rr_rows, rr_bytes, rr_scored)
    bound = bound_s * 1e3
    no_reuse = roofline.search_bound_s(len(q), dg.dim, kw["k"], S,
                                       every_read, rr_scored, rr_bytes,
                                       rr_scored)[0] * 1e3
    lib = graph_search._load()
    plan = graph_search.search_kernel_applies(
        dg, metric, q, P0, P_up, kw.get("expand", 1), kw.get("merge", "sort"),
        S if seeded else None)
    nbytes = plan["smem"]
    up = graph_search.row_mode(dg)
    s0 = beam_search.score_code(dg, mode0, precision)
    su = beam_search.score_code(dg, up, precision)
    per_sm = lib.graph_search_blocks_per_sm(s0, su, 1, nbytes)
    with open(os.path.join(beam_search.BUILD_DIR,
                           "beam_search.ptxas.txt")) as f:
        inst = (f"K5 {hop_split.SCORE_NAMES[s0]}+{hop_split.SCORE_NAMES[su]}"
                f"/vec")
        regs = hop_split.parse_ptxas(f.read()).get(inst, {})
    check(per_sm == 8, f"{label}: {inst} keeps 8 blocks an SM ({per_sm}) "
          f"at {nbytes} B ({regs.get('registers')} registers, "
          f"{regs.get('spill_stores')} B spill stores)")
    split = None
    if DEVICE == "cuda":
        from hnsw_tpu_torch.tools import graph_split
        split = graph_split.split_case(
            lib, graph_split.clocks_library(GRAPH_SPLIT_DIR), c,
            cuda_ms(lambda: search.search_graph(dg, q, **kw)))
        for line in graph_split.format_report(f"{label} split", split):
            print(line, flush=True)
    print(f"  {label}: K5 {ms:.3f} ms (one call, the wrapper's q_sq "
          f"included; {inst}: {per_sm} blocks an SM at {nbytes} B, "
          f"{regs.get('registers')} registers, "
          f"{regs.get('spill_stores')} B spill stores), bound "
          f"{bound:.4f} ms ({by}), {bound / ms:.4f} of it, without reuse "
          f"across queries {no_reuse:.4f} ms ({no_reuse / ms:.4f}); the "
          f"parent's "
          f"path (K2 a layer, a sync a layer) {parent_ms:.3f} ms; plain "
          f"version {plain_ms:.3f} ms; overlap {ov:.5f}, max rel err "
          f"{err:.2e}, hops a layer {ks['hops']}", flush=True)
    return {"mode": mode0, "ms": ms, "plain_ms": plain_ms,
            "split": None if split is None else {
                g: {"share": v["share"], "cycles_per_hop":
                    v["cycles_per_hop"], "rows_per_query":
                    v["rows_per_query"]}
                for g, v in split["groups"].items()},
            "parent_ms": parent_ms, "bound_ms": bound, "bound_by": by,
            "no_reuse_bound_ms": no_reuse,
            "max_abs_err": abs_err, "max_rel_err": err, "overlap": ov,
            "hops": ks["hops"], "blocks_per_sm": per_sm,
            "registers": regs.get("registers"),
            "spill_stores": regs.get("spill_stores")}


def phase_graph_kernel(st: dict, smi: str) -> dict:
    """K5 against its plain version on the card at the graph tier's shape
    (phase 5's 100,000 x 128 cosine graph, its 1,024 queries), on the
    searches Graph.batch_search_slots makes: the default mode at ef 64 and
    192 (f32 rows, the descent through every layer) and bench's mode at
    ef 192 (fast_math, int8 neighbour blocks, pivot seeds, the f32
    rerank) (_graph_case). Returns the kernels-line entry (the default
    mode at ef 64 is the headline)."""
    g, queries = st["g"], st["queries"]
    print(f"# K5 graph search vs its plain version, one launch a batch, "
          f"{N_GRAPH} x {DIM} cosine (median of 5 CUDA-event reps; {smi})",
          flush=True)
    cases = {f"default ef={ef}": _capture_search(g, queries, ef)
             for ef in (64, 192)}
    saved = {k: getattr(g, k) for k in ("fast_math", "block_layout",
                                        "entry_mode")}
    g.fast_math, g.block_layout, g.entry_mode = True, True, "pivots"
    cases["bench ef=192"] = _capture_search(g, queries, 192)
    out = {label: _graph_case(label, c) for label, c in cases.items()}
    for k, v in saved.items():
        setattr(g, k, v)
    del cases
    torch.cuda.empty_cache()
    head = out["default ef=64"]
    return dict(GRAPH_KERNEL, name="graph_search",
                max_abs_err=max(v["max_abs_err"] for v in out.values()),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=None, parent_ms=head["parent_ms"],
                blocks_per_sm=head["blocks_per_sm"],
                cases={k: {kk: v[kk] for kk in (
                    "mode", "ms", "plain_ms", "parent_ms",
                    "bound_ms", "no_reuse_bound_ms", "bound_by",
                    "blocks_per_sm", "registers",
                    "spill_stores", "hops", "max_abs_err", "split")}
                       for k, v in out.items()})


def phase_beam_kernel(st: dict, smi: str) -> dict:
    """K2 against its twin on the card at the graph tier's shape (phase
    5's 100,000 x 128 cosine graph, its 1,024 queries): one layer-0
    launch of ops/beam_search.beam_search_cuda beside
    core/search.beam_search_layer_reference on the same inputs (_beam_case),
    captured from the entry points: Graph at ef 64 and 192 (f32 rows),
    bench.py's mode at ef 192 with int8 and with fp16 neighbour blocks, the
    wave builder's construction descent (DEFAULT precision, sort merge, ef
    100) with 1,024 stored rows as its queries, and the local-repair
    refine's first wave as batch_delete(refine=True) runs it on a copy of
    the graph (DEFAULT, sort, S = M0 + 1 seeds with the node itself at INF,
    E = 4); and the capacity stores (hop_split.CAPACITY_CASES: the int8
    rows of hbm_mode="quantized" and the fp16 rows of hbm_mode="float16"
    with fast_math at ef 192, the bf16 store with fast_math at ef 64),
    every case held to ids overlap >= 0.999 and equal hops. Then the
    k2-capacity-8m probe (_capacity_probe) and the hop split of rows ef
    64 / 192 and the int8 rows. Returns the kernels-line entry (the rows
    case at ef 64 is the headline)."""
    from hnsw_tpu_torch.convert import graph_from_host_arrays
    from hnsw_tpu_torch.core import build_device
    from hnsw_tpu_torch.ops import beam_search
    from hnsw_tpu_torch.tools import hop_split
    g, queries, base = st["g"], st["queries"], st["base"]
    print(f"# K2 beam search vs its twin, one layer-0 launch, {N_GRAPH} x "
          f"{DIM} cosine (median of 5 CUDA-event reps; {smi})", flush=True)
    cases = list(hop_split.capture_cases(g, queries, base).items())
    n_used = g.slots.capacity_used
    gc = graph_from_host_arrays(
        g.cfg, g.slots.slot_to_key, g.store.vectors[:n_used],
        g.store.alive[:n_used], *g.host.arrays(), device=DEVICE)
    gc.native_serve_max_batch = 0
    refine = hop_split.layer0_call(lambda: gc.batch_delete(
        list(range(0, N_GRAPH, 100)), refine=True), build_device)
    check(bool(refine), "batch_delete(refine=True) made a layer-0 call")
    cases.append((f"refine (batch_delete) DEFAULT/sort "
                  f"ef={refine['kw']['pool_size']}, "
                  f"{len(refine['args'][0])} nodes", refine))
    out = {label: _beam_case(label, c) for label, c in cases}
    # where a hop's time goes: the kernel built with its phase counters
    # (tools/hop_split.py) on the two f32 row cases and the int8 rows
    print("# K2 hop split (BEAM_PHASE_CLOCKS build; shares of the slowest "
          "block's cycles, us a hop from the timings above)", flush=True)
    split_labels = ("rows ef=64", "rows ef=192", hop_split.CAPACITY_CASES[0])
    split = hop_split.split_cases(
        {k: c for k, c in cases if k in split_labels},
        beam_search._load(), hop_split.clocks_library(HOP_SPLIT_DIR),
        ms={k: v["ms"] for k, v in out.items()})
    del gc, refine, cases
    torch.cuda.empty_cache()
    out.update(_capacity_probe({v["mode"]: v["us_per_hop"] for k, v in
                                out.items()
                                if k in hop_split.CAPACITY_CASES}))
    head = out["rows ef=64"]
    return dict(BEAM_KERNEL, name="beam_search",
                max_abs_err=max(v["max_abs_err"] for v in out.values()),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                no_reuse_bound_ms=head["no_reuse_bound_ms"], library_ms=None,
                us_per_hop=head["us_per_hop"],
                blocks_per_sm=head["blocks_per_sm"],
                cases={k: {kk: v[kk] for kk in (
                    "mode", "ms", "plain_ms", "bound_ms", "no_reuse_bound_ms",
                    "us_per_hop", "blocks_per_sm", "registers", "hops",
                    "max_abs_err")}
                       for k, v in out.items()},
                hop_split={k: {"shares": v["shares"],
                               "us_per_hop": v["us_per_hop"]}
                           for k, v in split.items()})


def _capacity_probe(us_hop_100k: dict) -> dict:
    """k2-capacity-8m: one layer-0 launch of K2 on a table at capacity size,
    which no L2 holds: N_PROBE x 128 int8 rows with per-row scales (the
    capacity mode's store, quantized as core/state.quantize_rows does) and
    an fp16 copy of the same rows, made on the card from a seeded
    torch.Generator, under a seeded random PROBE_M-out layer-0 table (no
    build). 1,024 queries at ef 192 (E = 4, bitonic, l2) from one random
    start each, through K2 (qrows, then f16rows) beside the twin, held as
    the phase-5b cases are (_beam_case). Returns the two
    cases; prints each one's µs a hop over its mode's at 100k rows
    (``us_hop_100k``: mode -> µs a hop)."""
    from hnsw_tpu_torch.core import search
    from hnsw_tpu_torch.core.state import DeviceGraph
    from hnsw_tpu_torch.ops.distance import DEFAULT
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(13)
    n, d = N_PROBE, DIM
    t0 = time.perf_counter()
    qvec = torch.empty((n, d), dtype=torch.int8, device=dev)
    qscale = torch.empty((n,), dtype=torch.float32, device=dev)
    f16 = torch.empty((n, d), dtype=torch.float16, device=dev)
    sq = torch.empty((n,), dtype=torch.float32, device=dev)
    step = 1 << 20
    for lo in range(0, n, step):
        x = torch.randn((min(step, n - lo), d), generator=gen, device=dev)
        s = torch.clamp(x.abs().amax(dim=1) / 127.0, min=1e-30)
        qvec[lo:lo + len(x)] = torch.clamp(torch.round(x / s[:, None]),
                                           -127, 127).to(torch.int8)
        qscale[lo:lo + len(x)] = s
        f16[lo:lo + len(x)] = x.to(torch.float16)
        sq[lo:lo + len(x)] = torch.sum(x * x, dim=1)
    nbrs = torch.randint(0, n, (1, n, PROBE_M), generator=gen, device=dev,
                         dtype=torch.int32)
    queries = torch.randn((BATCH, d), generator=gen, device=dev)
    q_sq = torch.sum(queries * queries, dim=1)
    starts = torch.randint(0, n, (BATCH, 1), generator=gen, device=dev,
                           dtype=torch.int32)
    _sync_device()
    common = dict(sq_norms=sq, neighbors=nbrs,
                  levels=torch.zeros((n,), dtype=torch.int32, device=dev),
                  alive=torch.ones((n,), dtype=torch.bool, device=dev),
                  entry=torch.zeros((), dtype=torch.int32, device=dev))
    graphs = {
        "qrows": DeviceGraph(vectors=torch.zeros((1, d), device=dev),
                             qvec=qvec, qscale=qscale, **common),
        "f16rows": DeviceGraph(vectors=f16, **common)}
    print(f"# k2-capacity-8m: {n} x {d} int8 rows + scales "
          f"({(qvec.numel() + 4 * n) / 1e9:.2f} GB) and fp16 rows "
          f"({f16.numel() * 2 / 1e9:.2f} GB), a random {PROBE_M}-out "
          f"layer-0 table ({nbrs.numel() * 4 / 1e9:.2f} GB), made on the "
          f"card in {time.perf_counter() - t0:.1f} s; {BATCH} queries, ef "
          f"192, l2", flush=True)
    kw = dict(pool_size=192, max_hops=128, metric="l2", precision=DEFAULT,
              expand=4, merge="bitonic", store_normalized=False)
    out = {}
    for mode, g in graphs.items():
        start_d = search._score_hop(g, queries, q_sq, starts, "l2", DEFAULT)
        label = f"k2-capacity-8m {mode} ef=192"
        out[label] = _beam_case(label, {"g": g, "args": (
            queries, q_sq, starts, start_d), "kw": dict(kw)})
        us = out[label]["us_per_hop"]
        print(f"  {label}: {us:.2f} us a hop ({out[label]['hops']} hops) "
              f"at {n} rows, {us / us_hop_100k[mode]:.3f}x its us a hop "
              f"at {N_GRAPH} rows (phase 5b)", flush=True)
    del graphs, common, qvec, qscale, f16, sq, nbrs
    torch.cuda.empty_cache()
    return out


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


def phase_capacity_ladder() -> tuple:
    """BIGANN-10M's shape through the hbm_dtype ladder; returns K1's
    launches by route (the float32 rung) and what phase 14 streams and
    holds itself to: the host rows, the first batch and the float32
    rung's (dists, ids) for it."""
    from hnsw_tpu_torch import ExactIndex
    from hnsw_tpu_torch.index import exact as exact_mod
    from hnsw_tpu_torch.ops import exact_screen
    from hnsw_tpu_torch.ops.topk import quantized_topk_candidates
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
    kept = {"rows": idx.store.vectors[:N_CAPACITY],
            "sq": idx.store.sq_norms[:N_CAPACITY], "queries": batches[0],
            "dists": truth[0][0], "ids": truth[0][1]}
    truth = np.concatenate([i for _, i in truth])
    # k = 100 (K1 takes k <= 120): what the int8 rung is held to at k = 100
    truth100 = idx.batch_search_slots(batches[0], 100)[1]
    launches = _launches()
    check(launches == {"wgmma": N_BATCHES + 1, "wgmma_cp": 0},
          f"float32: {N_BATCHES} batches at k = 10 and one at k = 100 "
          f"launched the wgmma kernel {launches['wgmma']} times, the "
          f"wgmma_cp route {launches['wgmma_cp']}")
    d_np, i_np = _np_scan_topk(batches[0][:20],
                               idx.store.vectors[:N_CAPACITY],
                               idx.store.sq_norms[:N_CAPACITY], 10, "l2")
    d_k, i_k = idx.batch_search_slots(batches[0], 10)
    rec = _recall_ties(d_k[:20], d_np, 1e-4)
    err = _matched_err(d_k[:20], i_k[:20], d_np, i_np)
    check(rec == 1.0 and err <= 1e-4, f"float32 (kernel): recall@10 "
          f"{rec:.4f} == 1 against a chunked numpy scan of 20 queries "
          f"(ties within 1e-4), matched dists within 1e-4 ({err:.2e})")
    kept["qps"] = n_q / wall
    print(f"  capacity float32 (kernel): {n_q / wall:.1f} QPS ({n_q} "
          f"queries, one pass), upload {t_sync:.1f} s", flush=True)

    for rung in ("int8", "bf16", "fp16"):
        idx.hbm_dtype = rung
        t0 = time.perf_counter()
        idx._sync()
        t_sync = time.perf_counter() - t0
        _check_table(idx, rung, N_CAPACITY)
        _cap_reset()
        idx.batch_search_slots(batches[0], 10)             # warm-up
        _reset_launches()
        seq, t_seq = timed(serve)
        streamed, t_stream = timed(
            lambda: list(idx.batch_search_stream(iter(batches), 10)))
        check(exact_screen.launches == 0,
              f"{rung}: the capacity scan runs without the float32 kernel")
        _cap_read(f"{rung}: the warm-up, {N_BATCHES} sequential and "
                  f"{N_BATCHES} streamed batches",
                  {rung: 1 + 2 * N_BATCHES})
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
        # one batch with the plain scan in the kernel's place
        real = exact_mod.capacity_scan
        exact_mod.capacity_scan = (
            lambda q, t, s, sq, ok, kk, metric: quantized_topk_candidates(
                q, t, s, sq, ok, kk=kk, metric=metric))
        try:
            _cap_reset()
            (dp, ip), t_plain = timed(
                lambda: idx.batch_search_slots(batches[0], 10))
            plain_launches = exact_screen.capacity_launches
        finally:
            exact_mod.capacity_scan = real
        agree = float(np.mean(ip == seq[0][1]))
        check(plain_launches == 0 and agree >= 0.999,
              f"{rung}: one batch through the plain scan (no launch): ids "
              f"equal the kernel's at {agree:.5f} of the positions")
        print(f"  capacity {rung}: {n_q / t_seq:.1f} QPS, recall@10 "
              f"{rec:.4f} vs float32; {N_BATCHES} batches sequential "
              f"{t_seq:.3f} s, stream {t_stream:.3f} s; upload "
              f"{t_sync:.1f} s; one batch through the plain scan "
              f"{BATCH / t_plain:.1f} QPS ({t_plain:.3f} s)", flush=True)
        if rung == "int8":
            # k = 100: the pool is k + k // 2 = 150, past K1's 128
            _cap_reset()
            (d100, i100), t100 = timed(
                lambda: idx.batch_search_slots(batches[0], 100))
            _cap_read("int8 at k = 100 (pool 150): one batch",
                      {"int8": 1}, {"wgmma": 1})
            rec100 = _recall(i100, truth100, 100)
            check(i100.shape == (BATCH, 100) and np.isfinite(d100).all()
                  and rec100 >= 0.99,
                  f"int8 at k = 100: finite [{BATCH}, 100], recall@100 "
                  f"{rec100:.4f} >= 0.99 against the float32 rung")
            print(f"  capacity int8, k = 100 (pool 150): one batch "
                  f"{t100:.3f} s = {BATCH / t100:.1f} QPS, recall@100 "
                  f"{rec100:.4f} vs float32", flush=True)
        if DEVICE == "cuda":
            # where a batch's time goes: the scan (queued, its candidates
            # copied back) against the host rerank, then a device trace
            qp = exact_mod._pad_queries(batches[1])
            t0 = time.perf_counter()
            scan = idx._dispatch_capacity_scan(qp, 10)
            scan[2].synchronize()
            t1 = time.perf_counter()
            idx._finish_capacity_scan(qp, BATCH, 10, *scan)
            t2 = time.perf_counter()
            print(f"  capacity {rung}, one batch: scan + candidates back "
                  f"{(t1 - t0) * 1e3:.3f} ms, host rerank "
                  f"{(t2 - t1) * 1e3:.3f} ms ({(t2 - t1) / (t2 - t0):.3f} "
                  f"of the batch)", flush=True)
            _profile(f"capacity {rung}, one {BATCH}-query batch",
                     lambda: idx.batch_search_slots(batches[1], 10),
                     need="screen_")
    idx.close()
    del idx
    torch.cuda.empty_cache()
    return launches, kept


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
        _cap_reset()
        t0 = time.perf_counter()
        d, i = idx.batch_search_slots(q, 10)
        _sync_device()
        t_first = time.perf_counter() - t0
        rung = idx._resolved_hbm
        n_k = _launches()
        qps = _qps(lambda: idx.batch_search_slots(q, 10), BATCH)
        # a reduced rung: the first batch and the 3 timed ones
        _cap_read(f"auto -> {rung}: 4 batches",
                  {} if rung == "float32" else {rung: 4})
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
            check(n_k == {"wgmma": 1, "wgmma_cp": 0}, f"auto -> float32: one "
                  f"batch launched the wgmma kernel {n_k['wgmma']} times, "
                  f"the wgmma_cp route {n_k['wgmma_cp']}")
        else:
            check(n_k == {"wgmma": 0, "wgmma_cp": 0},
                  f"auto -> {rung}: K1 was not launched")
        launches = _add(launches, _launches())
        print(f"  auto, {N_CLUSTER} x {DIM} cosine in 40 clusters of width "
              f"{noise}: resolves to {rung}; {qps:.1f} QPS (1024-query "
              f"batch, median of 3); first batch with the fit checks and "
              f"upload {t_first:.1f} s", flush=True)
        idx.close()
        del idx
        torch.cuda.empty_cache()
    return launches


def _profile_rerank(label: str, g, fn, need: str):
    """_profile of ``fn`` with ``g._host_rerank`` timed on the host clock
    inside the traced call: returns (the summary or None, rerank ms)."""
    sw = _Stopwatch()

    def traced():
        sw.seconds.clear()
        sw.wrap(g, "_host_rerank", "rerank")
        try:
            return fn()
        finally:
            sw.restore()
    out = _profile(label, traced, need=need)
    ms = sw.seconds.get("rerank", 0.0) * 1e3
    if out is not None:
        print(f"    host rerank (Graph._host_rerank) {ms:.3f} ms, "
              f"{ms / out['wall_ms']:.3f} of the wall", flush=True)
    return out, ms


def phase_graph_modes(st: dict) -> None:
    """bench.py's serving configuration, the capacity modes (hbm_mode
    "float16" and "quantized": K2 on fp16 rows and on int8 rows with
    per-row scales, then the host rerank) and the bf16 store on the 100k
    graph of phase_graph_tier (no second build). Each capacity mode and
    the bf16 store also run through the plain twin (recall@10 within
    0.005 of the kernel's) and the capacity modes trace one batch each
    way (the host rerank's share)."""
    import dataclasses
    g, cpu, base, queries, gt = (st[k] for k in
                                 ("g", "cpu", "base", "queries", "gt"))
    served = {}

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
        served[label, ef] = qps
        print(f"  {label} ef={ef}: {qps:.1f} QPS (1024-query batch, median "
              f"of 3), recall@10 {_recall(ids, gt, 10):.4f} vs the exact "
              f"tier, hops per layer (top..0) {hops}", flush=True)
        return ids

    def against_twin(label, ef, ids):
        """The same batch through the plain twin: QPS, and recall@10
        within 0.005 of the kernel's."""
        with _twin():
            _, ids_t = g.batch_search_slots(queries, 10, ef=ef)
            qps_t = _qps(lambda: g.batch_search_slots(queries, 10, ef=ef),
                         1024)
        rec_k, rec_t = _recall(ids, gt, 10), _recall(ids_t, gt, 10)
        check(abs(rec_k - rec_t) <= 0.005,
              f"{label} ef={ef}: recall@10 through the kernel {rec_k:.4f} "
              f"within 0.005 of the twin's {rec_t:.4f}")
        print(f"  {label} ef={ef}, the plain twin "
              f"(beam_search_layer_reference): {qps_t:.1f} QPS, recall@10 "
              f"{rec_t:.4f} (the kernel's {served[label, ef]:.1f} QPS, "
              f"{served[label, ef] / qps_t:.1f}x)", flush=True)

    def bench_config(x):
        x.fast_math = True
        x.block_layout = True
        x.entry_mode = "pivots"

    print("# graph tier serving modes (the 100k graph above)", flush=True)
    _beam_reset()
    bench_ids = {ef: serve("fast_math + block_layout + pivots", ef,
                           bench_config) for ef in (192, 384)}
    # bench.py's graph row through the plain twin, on the same batch
    against_twin("fast_math + block_layout + pivots", 192, bench_ids[192])
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
        label = f"hbm_mode={mode} + fast_math + pivots"
        ids = serve(label, 192, capacity)
        dev = g.device_graph()
        if mode == "float16":
            check(dev.vectors.dtype == torch.float16 and dev.qvec is None,
                  "hbm_mode=float16: an fp16 store on the card")
        else:
            check(tuple(dev.vectors.shape) == (1, DIM)
                  and dev.qvec.dtype == torch.int8
                  and dev.qvec.device.type == DEVICE,
                  "hbm_mode=quantized: only the int8 store on the card")
        against_twin(label, 192, ids)
        if DEVICE == "cuda":
            batch = (lambda: g.batch_search_slots(queries, 10, ef=192))
            _profile_rerank(f"one 1024-query batch, {label} ef=192, K5",
                            g, batch, need="graph_search_kernel")
            with _twin():
                _profile_rerank(f"one 1024-query batch, {label} ef=192, "
                                f"twin", g, batch, need="")

    def bf16_store(x):
        x.hbm_mode = "full"
        x.cfg = dataclasses.replace(x.cfg, store_dtype="bfloat16")
        x._dirty = True

    ids = serve("store_dtype=bfloat16 + fast_math + pivots", 64, bf16_store)
    check(g.device_graph().vectors.dtype == torch.bfloat16,
          "store_dtype=bfloat16: a bf16 store on the card")
    against_twin("store_dtype=bfloat16 + fast_math + pivots", 64, ids)

    def compact(x):
        x.cfg = dataclasses.replace(x.cfg, store_dtype="float32")
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
    _beam_read("phase 8 (bench.py's blocks, the capacity modes' int8 and "
               "fp16 rows, the bf16 store, compact uppers)",
               need5=tuple(GRAPH_LAUNCHES), covered_only=True)


def _select_case(label: str, ci, cd, vectors, sq, deg: int, metric: str,
                 diversify: bool, need_equal: float, timed: bool = False):
    """One call of K4 (ops/diverse_select.diverse_select_cuda) and of its
    twin (core/build._diverse_select_reference) on the same tensors: a
    failed check unless at least ``need_equal`` of the rows are equal.
    Its error is the largest difference, slot by slot, of the distances of
    the ids the two keep (0 where the rows are equal). ``timed``: both
    timed, one call an event pair through the wrapper (median of 5
    CUDA-event reps, as every kernel here is timed), the kernel also 20
    calls back to back a rep (tools/select_split.back_to_back_ms: the
    host's time between calls hidden under the kernel's) and beside its
    bound (utils/roofline.select_bound_s over the distinct valid rows and
    the valid candidates' pairs; and every slot's row, every pair)."""
    from hnsw_tpu_torch.core import build
    from hnsw_tpu_torch.ops import diverse_select
    from hnsw_tpu_torch.tools import select_split
    kw = dict(deg=deg, metric=metric, diversify=diversify)

    def kern():
        return diverse_select.diverse_select_cuda(ci, cd, vectors, sq, **kw)

    def twin():
        return build._diverse_select_reference(ci, cd, vectors, sq, **kw)

    n0 = diverse_select.launches
    got = kern()
    torch.cuda.synchronize()
    check(diverse_select.launches == n0 + 1, f"{label}: one launch")
    got, want = got.cpu().numpy(), twin().cpu().numpy()
    equal = (got == want).all(axis=1)
    ci_h, cd_h = ci.cpu().numpy(), cd.cpu().numpy()

    def dist_of(rows):
        out = np.full(rows.shape, np.nan)
        for p in np.flatnonzero(~equal):
            where = {int(i): float(d) for i, d in zip(ci_h[p], cd_h[p])
                     if i >= 0}
            out[p] = [where.get(int(i), np.nan) for i in rows[p]]
        return out

    diff = np.abs(dist_of(got) - dist_of(want))
    err = float(np.nanmax(diff)) if np.isfinite(diff).any() else 0.0
    share = float(equal.mean())
    P, C = ci_h.shape
    check(got.shape == want.shape == (P, min(C, deg)) and share >= need_equal,
          f"{label} (P={P}, C={C}, deg={deg}, D={vectors.shape[1]}, "
          f"{metric}, diversify={diversify}): {int(equal.sum())} of {P} "
          f"rows equal the twin's ({share:.5f} >= {need_equal}), max "
          f"|d| difference of the kept {err:.3g}")
    out = {"equal": share, "max_abs_err": err}
    if not timed:
        return out
    ms, twin_ms = cuda_ms(kern), cuda_ms(twin)
    b2b = select_split.back_to_back_ms(kern)
    D = vectors.shape[1]
    b = select_split.data_bound(ci, cd, D, deg, diversify,
                                vectors.element_size())
    bound, flat = b["bound_ms"], b["no_reuse_bound_ms"]
    per_sm = diverse_select._load().diverse_select_blocks_per_sm(
        C, D, diverse_select.STORES[vectors.dtype]) if diversify else None
    occ = f" ({per_sm} blocks an SM)" if diversify else ""
    print(f"    kernel {ms:.4f} ms (back to back {b2b:.4f}){occ}, bound "
          f"{bound:.4f} ms ({b['bound_by']}; {b['rows']} distinct rows, "
          f"{b['pairs']} valid pairs), {bound / ms:.4f} of the bound "
          f"({bound / b2b:.4f} back to back; every slot's row and pair: "
          f"{flat:.4f} ms, {b['no_reuse_bound_by']}, {flat / ms:.4f}); twin "
          f"{twin_ms:.3f} ms ({twin_ms / ms:.1f}x)", flush=True)
    out.update(ms=ms, back_to_back_ms=b2b, plain_ms=twin_ms, bound_ms=bound,
               bound_by=b["bound_by"], no_reuse_bound_ms=flat,
               blocks_per_sm=per_sm)
    return out


def phase_select_kernel(smi: str) -> dict:
    """Phase 8b: K4 against its twin on the card at the shape of a layer-0
    call of phase 10's build (a wave of P = 2,048 rows, C = 96 candidates:
    each row's 64 nearest of 260,096 other rows and 32 nearest of the
    wave, deg 32, D = 128, L2), on integer-valued rows (|x| <= 4: every
    operand, product and sum exact, rows equal) and Gaussian rows (the
    kernel's f32 sums run in another order than the twin's matmul: >=
    0.999 of the rows equal); without diversify (equal); with an fp16
    store; at the reverse update's C = 64 both ways; at m = 42's C = 252
    (6 m); and at C = 1,024 (P 64), where D is staged in slabs. The inputs
    are tools/select_split.py's, and the layer-0 call's split is read from
    the clocked build of phase_build. Returns the kernels-line entry (the
    Gaussian layer-0 call is the headline)."""
    from hnsw_tpu_torch.ops import diverse_select
    from hnsw_tpu_torch.tools import select_split
    n, P = N_SIFT, WAVE
    print(f"# K4 neighbour selection vs its twin, one launch, a wave of {P} "
          f"of {n} x {DIM} rows, C={SELECT_C}, deg={SELECT_DEG}, l2 "
          f"(median of 5 CUDA-event reps; {smi})", flush=True)
    out = {}
    for kind in ("integer", "gaussian"):
        vectors = select_split.rows(kind, n, DIM, DEVICE)
        sq = (vectors * vectors).sum(-1)
        need = 1.0 if kind == "integer" else 0.999
        ci, cd = select_split.slate(vectors, sq, P, SELECT_C - 32, 32)
        print(f"  {kind} rows, layer 0:", flush=True)
        out[kind] = _select_case(f"{kind} layer 0", ci, cd, vectors, sq,
                                 SELECT_DEG, "l2", True, need, timed=True)
        out[kind, "plain"] = _select_case(
            f"{kind} layer 0", ci, cd, vectors, sq, SELECT_DEG, "l2",
            False, 1.0)
        v16 = vectors.to(torch.float16)
        sq16 = (v16.to(torch.float32) ** 2).sum(-1)
        print(f"  {kind} rows, layer 0, fp16 store:", flush=True)
        out[kind, "fp16"] = _select_case(
            f"{kind} layer 0, fp16 store", ci, cd, v16, sq16, SELECT_DEG,
            "l2", True, need, timed=True)
        del v16, sq16
        ci64, cd64 = ci[:, :SELECT_C_REVERSE].contiguous(), \
            cd[:, :SELECT_C_REVERSE].contiguous()
        for diversify in (True, False):
            print(f"  {kind} rows, C={SELECT_C_REVERSE}, diversify="
                  f"{diversify}:", flush=True)
            out[kind, SELECT_C_REVERSE, diversify] = _select_case(
                f"{kind} reverse width", ci64, cd64, vectors, sq,
                SELECT_DEG, "l2", diversify,
                need if diversify else 1.0, timed=True)
        if kind == "gaussian":
            ci_w, cd_w = select_split.slate(vectors, sq, 512, 168, 84)
            print("  gaussian rows, m = 42's width C=252, deg 84:",
                  flush=True)
            out["wide"] = _select_case("C=252", ci_w, cd_w, vectors, sq, 84,
                                       "l2", True, 0.999, timed=True)
            ci_s, cd_s = select_split.slate(vectors, sq, 64, 992, 32)
            check(diverse_select.layout(1024, DIM)["n_slabs"] > 1,
                  "C=1,024 at D=128 stages D in slabs")
            print("  gaussian rows, C=1,024, deg 64 (D in slabs):",
                  flush=True)
            out["slabs"] = _select_case("C=1,024", ci_s, cd_s, vectors, sq,
                                        64, "l2", True, 0.999, timed=True)
            if DEVICE == "cuda":
                lib = select_split.bind_clocks(os.path.join(
                    SELECT_SPLIT_DIR, "libdiverse_select.so"))
                rep = select_split.phase_report(select_split.clocked(
                    lib, (ci, cd, vectors, sq), SELECT_DEG, True),
                    out[kind]["back_to_back_ms"])
                print(f"  split of the gaussian layer-0 call (clocked build,"
                      f" tools/select_split.py): "
                      f"{select_split.format_report(rep)}", flush=True)
        del vectors, sq, ci, cd
        torch.cuda.empty_cache()
    with open(os.path.join(diverse_select.BUILD_DIR,
                           "diverse_select.ptxas.txt")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    head = out["gaussian"]
    return dict(SELECT_KERNEL, name="diverse_select",
                max_abs_err=max(v["max_abs_err"] for v in out.values()),
                ms=head["ms"], back_to_back_ms=head["back_to_back_ms"],
                plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                no_reuse_bound_ms=head["no_reuse_bound_ms"], library_ms=None,
                blocks_per_sm=head["blocks_per_sm"],
                rows_equal={str(k): v["equal"] for k, v in out.items()},
                cases={str(k): {kk: v[kk] for kk in (
                    "ms", "back_to_back_ms", "plain_ms", "bound_ms",
                    "no_reuse_bound_ms")}
                       for k, v in out.items() if "ms" in v})


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
    """Phase 9: every mode of the wave builder on the first
    N_DEVICE_BUILD cosine vectors of phase_graph_tier; returns K1's
    launches by route (the exact-tier oracle over those rows, and over
    the survivors of the delete). The recall floor is that of the native
    build of the same rows (phase_graph_tier's graph when it held only
    them), less 0.05."""
    import tempfile

    from hnsw_tpu_torch import ExactIndex, Graph
    from hnsw_tpu_torch.convert import graph_from_host_arrays
    from hnsw_tpu_torch.core.build_device import BuildDeadlineExceeded
    n = N_DEVICE_BUILD
    base, queries = st["base"][:n], st["queries"]
    keys = list(range(n))
    _reset_launches()
    oracle = ExactIndex(metric="cosine", device=DEVICE)
    oracle.host_serve_max_batch = 0
    oracle.batch_add(keys, base)
    _, gt = oracle.batch_search_slots(queries, 10)
    print(f"# device builds: {n} x {DIM} cosine, m=16, ef_construction=100,"
          f" wave={WAVE}", flush=True)
    host_rec = st["prefix_recall"]

    _beam_reset()
    _select_reset()
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
              f"build's on the same rows {host_rec[ef]:.4f} - 0.05")
    del cpu
    print(f"  device build: {t_build:.1f} s ({n / t_build:.1f} nodes/s), "
          f"{gd.num_layers} layers, {orphans:.4f} of the nodes with no "
          f"layer-0 in-edge, recall@10 {rec[64]:.4f} / "
          f"{rec[192]:.4f} at ef 64 / 192 (native build of the same rows "
          f"{host_rec[64]:.4f} / {host_rec[192]:.4f})", flush=True)

    # the same build through the plain twin: nodes/s and recall beside the
    # kernel's, and one more wave of WAVE rows traced (the kernel's is
    # traced on the resumed build below)
    with _twin():
        gt_, t_twin = _device_build(keys, base, "cosine", method="device")
        rec_t = _graph_recalls(gt_, queries, gt, "twin device build")
        wave_t = _wave_trace(gt_, st["base"], n, "the twin's build")
    del gt_
    check(all(abs(rec[ef] - rec_t[ef]) <= 0.005 for ef in rec),
          f"device build: recall@10 through the kernel {rec} within 0.005 "
          f"of the twin's build {rec_t}")
    print(f"  the same build through the twin: {t_twin:.1f} s "
          f"({n / t_twin:.1f} nodes/s; the kernel's {n / t_build:.1f}, "
          f"{t_twin / t_build:.2f}x)", flush=True)
    # and with K4's twin forced (K2 stays on): the selection's share of
    # the build, its recall beside the kernel's, one more wave traced
    with _select_twin():
        gs, t_sel = _device_build(keys, base, "cosine", method="device")
        rec_s = _graph_recalls(gs, queries, gt, "K4-twin device build")
        wave_s = _wave_trace(gs, st["base"], n, "the K4 twin's build")
    del gs
    check(all(abs(rec[ef] - rec_s[ef]) <= 0.005 for ef in rec),
          f"device build: recall@10 through K4 {rec} within 0.005 of the "
          f"build through K4's twin {rec_s}")
    print(f"  the same build through K4's twin: {t_sel:.1f} s "
          f"({n / t_sel:.1f} nodes/s; through K4 {n / t_build:.1f}, "
          f"{t_sel / t_build:.2f}x)", flush=True)

    from hnsw_tpu_torch.ops import beam_search
    by0 = dict(beam_search.launches_by_mode)
    twin0 = dict(beam_search.twin_layers_on_cuda)
    gq, t_q = _device_build(keys, base, "cosine", method="device",
                            quant_descent=True, descent_dtype="float16")
    check(_all_inserted(gq, n), "int8-block fp16 descent: every key "
          "inserted")
    by_q = {m: beam_search.launches_by_mode[m] - by0[m] for m in by0}
    if DEVICE == "cuda":
        check(by_q["f16rows"] > 0 and by_q["blocks"] > 0
              and beam_search.twin_layers_on_cuda == twin0,
              f"int8-block fp16 descent: upper layers on K2's fp16 rows, "
              f"layer 0 on its int8 blocks ({by_q}), no layer on the twin")
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
    wave_k = _wave_trace(gr, st["base"], n, "the resumed build")
    for label, other in (("twin", wave_t), ("K4 twin", wave_s)):
        if wave_k and other:
            print(f"  one more wave, kernels / {label}: {wave_k['launches']} "
                  f"/ {other['launches']} launches, wall "
                  f"{wave_k['wall_ms']:.1f} / {other['wall_ms']:.1f} ms, "
                  f"device {wave_k['device_ms']:.3f} / "
                  f"{other['device_ms']:.3f} ms, idle share "
                  f"{wave_k['idle_share']:.3f} / {other['idle_share']:.3f}",
                  flush=True)
    del gr
    torch.cuda.empty_cache()
    _beam_read("phase 9 (wave builds, refine, serving)",
               need=("rows", "blocks", "f16rows"), need5=("rows",),
               covered_only=True)
    _select_read("phase 9 (wave builds, the fp16 descent, refine, resume)")
    launches = _launches()
    check(launches["wgmma"] >= 2 and launches["wgmma_cp"] == 0,
          f"the exact-tier oracle launched the wgmma kernel "
          f"{launches['wgmma']} times")
    return launches


def _wave_trace(g, rows: np.ndarray, n: int, label: str):
    """One more wave of the device builder on ``g`` (keys and rows n to
    n + WAVE of ``rows``) in a padded device trace
    (utils/profiling.trace_summary); prints and returns its split, or None
    when the trace lost its kernel events."""
    from hnsw_tpu_torch.utils.profiling import trace_summary
    out = trace_summary(lambda: g.build(
        list(range(n, n + WAVE)), rows[n:n + WAVE], method="device",
        wave=WAVE))
    print(f"  one more wave of {WAVE} rows on {label}: " + (
        "the trace lost its kernel events" if out is None else
        f"wall {out['wall_ms']:.1f} ms, device {out['device_ms']:.3f} ms, "
        f"{out['launches']} launches, idle share {out['idle_share']:.3f}"),
        flush=True)
    return out


class _WaveProbe:
    """Counts the device builder's waves and profiles one of them with
    torch.profiler: the wave's descent, row assembly, diversity selection
    (inside assembly and reverse update) and reverse update each run
    under a record_function label.

    The hand kernels (K2's beam_search_kernel, K4's diverse_select_kernel)
    are launched through ctypes, so the profiler ties none of them to a
    label. Each wrapped call records the hand launches it made (the
    wrappers' counters) with the labels open at the time, and the n-th
    such launch is matched to the n-th device event of that kernel in the
    trace (one stream: trace order is launch order). The wave's totals
    count every device event of the trace."""

    LABELS = {"construction_descent": "build.descent",
              "_assemble_wave_rows": "build.assemble",
              "_reverse_update": "build.reverse",
              "_diverse_select_dev": "build.select"}
    #: hand kernels: (name in the trace, module whose ``launches`` counts
    #: them)
    HAND = (("beam_search_kernel", "beam_search"),
            ("diverse_select_kernel", "diverse_select"))

    def __init__(self, profile_wave: int):
        from hnsw_tpu_torch.core import build_device
        from hnsw_tpu_torch.ops import beam_search, diverse_select
        self.mods = {"beam_search": beam_search,
                     "diverse_select": diverse_select}
        self.mod, self.profile_wave = build_device, profile_wave
        self.orig = {k: getattr(build_device, k) for k in self.LABELS}
        self.waves, self.prof, self.summary = 0, None, None
        #: seconds the padding slept (inside the build's wall time)
        self.paused_s = 0.0
        #: labels of the wrapped calls in progress; hand launches recorded
        #: so far in the profiled wave, by kernel: a list of label tuples
        self.stack, self.hand = [], {}

    def __enter__(self):
        for name, label in self.LABELS.items():
            setattr(self.mod, name, self._wrap(name, label))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)
        if self.prof is not None:
            self._stop()

    def _counts(self) -> dict:
        return {k: self.mods[m].launches for k, m in self.HAND}

    def _wrap(self, name, label):
        fn = self.orig[name]

        def wrapped(*a, **kw):
            if name == "construction_descent":
                self._wave_boundary()
            if self.prof is None:
                return fn(*a, **kw)
            self.stack.append(label)
            try:
                with torch.profiler.record_function(label):
                    return fn(*a, **kw)
            finally:
                labels = tuple(self.stack)
                self.stack.pop()
                for k, n in self._counts().items():
                    mine = self.hand.setdefault(k, [])
                    # launches since the wave began that no inner call
                    # recorded are this call's own
                    mine += [labels] * (n - self.base[k] - len(mine))
        return wrapped

    def _wave_boundary(self):
        if self.prof is not None:
            self._stop()
        self.waves += 1
        if self.waves == self.profile_wave:
            from hnsw_tpu_torch.utils.profiling import PAD_S
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            # padded as utils/profiling.device_trace pads its window: a
            # short session loses its kernel records
            time.sleep(PAD_S)
            self.paused_s += PAD_S
            self.base, self.hand = self._counts(), {}
            self.t0 = time.perf_counter()

    def _stop(self):
        import tempfile

        from hnsw_tpu_torch.utils.profiling import PAD_S, device_events
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self.t0) * 1e6
        time.sleep(PAD_S)
        self.paused_s += PAD_S
        self.prof.stop()
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "wave.json")
            self.prof.export_chrome_trace(path)
            device = device_events(path)
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
        matched = {}
        for k, _ in self.HAND:
            us = [t for cat, name, t in device
                  if cat == "kernel" and k in name]
            recs = self.hand.get(k, [])
            matched[k] = (len(recs), len(us))
            for labels, t in zip(recs, us):
                for label in set(labels):
                    parts[label]["launches"] += 1
                    parts[label]["device_ms"] += t / 1e3
        dev_us = sum(t for _, _, t in device)
        self.summary = {
            "wave": self.waves, "wall_ms": wall_us / 1e3,
            "device_ms": dev_us / 1e3,
            "launches": sum(cat == "kernel" for cat, _, _ in device),
            "idle_share": max(0.0, 1.0 - dev_us / wall_us), "parts": parts,
            "hand": matched}
        self.prof = None


def phase_sift_shape_build() -> int:
    """Phase 10: an N_SIFT x 128 L2 build by the wave builder (named
    explicitly: "auto" takes it from N_AUTO_DEVICE rows, which is
    checked); returns K1's launches by route (the exact-tier oracle)."""
    from hnsw_tpu_torch import ExactIndex
    from hnsw_tpu_torch.index.hnsw import _route
    rng = np.random.default_rng(4)
    base = rng.standard_normal((N_SIFT, DIM), dtype=np.float32)
    queries = rng.standard_normal((BATCH, DIM), dtype=np.float32)
    keys = list(range(N_SIFT))
    print(f"# device build: {N_SIFT} x {DIM} l2 (SIFT's width), m=16, "
          f"ef_construction=100, wave={WAVE}, method=device", flush=True)
    check(_route("auto", N_AUTO_DEVICE) == "device"
          and _route("auto", N_SIFT) == "host",
          f'"auto" routes {N_AUTO_DEVICE} rows to the wave builder and '
          f"{N_SIFT} to the native one")
    torch.cuda.reset_peak_memory_stats()
    _beam_reset()
    _select_reset()
    with _NativeInserts() as nat, _WaveProbe(PROFILE_WAVE) as probe:
        g, t_build = _device_build(keys, base, "l2", method="device")
    # the probe's padding sleeps inside the build: not build time
    t_build -= probe.paused_s
    check(nat.calls == 0, "the native builder saw 0 calls")
    check(_all_inserted(g, N_SIFT), "every key inserted")
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = np.bincount(g.host.levels[:N_SIFT]).tolist()
    print(f"  build {t_build:.1f} s (less the profiled wave's "
          f"{probe.paused_s:.1f} s of padding), {N_SIFT / t_build:.1f} "
          f"nodes/s, {probe.waves} waves, peak device memory {peak:.2f} GB, nodes "
          f"per level {hist}", flush=True)
    # No self-retrieval bound here: on isotropic Gaussian L2 rows no
    # builder of either package reaches one (distance concentration, and
    # the closest-m reverse update leaves nodes with no in-edge: ROADMAP
    # fault F8). The build is held to its invariants; its quality against
    # the native builder is phase 9's check.
    orphans = _check_structure(g, N_SIFT, "SIFT-width build")
    print(f"  self-retrieval {_self_hits(g, base):.4f} (1024 stored "
          f"vectors, ef=64), {orphans:.4f} of the nodes with no layer-0 "
          f"in-edge", flush=True)

    _reset_launches()
    oracle = ExactIndex(metric="l2", device=DEVICE)
    oracle.host_serve_max_batch = 0
    oracle.batch_add(keys, base)
    _, gt = oracle.batch_search_slots(queries, 10)
    launches = _launches()
    check(launches["wgmma"] >= 1 and launches["wgmma_cp"] == 0,
          f"the exact-tier oracle launched the wgmma kernel "
          f"{launches['wgmma']} times")
    del oracle
    rec = {}
    for mode in ("full", "quantized", "float16"):
        # the capacity modes: K2 on int8 rows with per-row scales / fp16
        # rows, then the host rerank
        g.hbm_mode = mode
        for ef in (64, 192):
            d, ids = g.batch_search_slots(queries, 10, ef=ef)
            check(ids.shape == (BATCH, 10) and (ids >= 0).all()
                  and np.isfinite(d).all(),
                  f"hbm_mode={mode} ef={ef}: finite [{BATCH}, 10] results, "
                  f"no misses")
            rec[mode, ef] = _recall(ids, gt, 10)
            print(f"  hbm_mode={mode} ef={ef}: recall@10 "
                  f"{rec[mode, ef]:.4f} vs the exact tier, hops per layer "
                  f"(top..0) {g.last_search_hops}", flush=True)
            if mode != "full":
                check(rec[mode, ef] >= rec["full", ef] - 0.05,
                      f"hbm_mode={mode} ef={ef}: recall@10 "
                      f"{rec[mode, ef]:.4f} >= the f32 store's "
                      f"{rec['full', ef]:.4f} - 0.05")
    g.hbm_mode = "full"
    _beam_read("phase 10 (the 262,144-row wave build and its serving in "
               "every hbm_mode)", need=("rows",),
               need5=("rows", "qrows", "f16rows"), covered_only=True)
    _select_read("phase 10 (the 262,144-row wave build)")
    s = probe.summary
    check(s is not None and s["launches"] > 0,
          f"wave {PROFILE_WAVE} profiled")
    print(f"  wave {s['wave']} profile: wall {s['wall_ms']:.1f} ms, device "
          f"{s['device_ms']:.1f} ms, idle share {s['idle_share']:.3f}, "
          f"{s['launches']} launches (hand kernels recorded / in the trace: "
          f"{s['hand']})", flush=True)
    for label, p in s["parts"].items():
        print(f"    {label}: {p['calls']} calls, {p['launches']} launches, "
              f"device {p['device_ms']:.1f} ms", flush=True)
    del g
    torch.cuda.empty_cache()
    return launches

class _Stopwatch:
    """Host-clock seconds spent inside callables patched onto objects or
    modules, summed by label; ``restore()`` puts the originals back."""

    def __init__(self):
        self.seconds, self._patched = {}, []

    def wrap(self, owner, name: str, label: str) -> None:
        fn = getattr(owner, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                _sync_device()
                self.seconds[label] = (self.seconds.get(label, 0.0)
                                       + time.perf_counter() - t0)
        self._patched.append((owner, name, fn, name in vars(owner)))
        setattr(owner, name, timed)

    def restore(self) -> None:
        for owner, name, fn, own in reversed(self._patched):
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)
        self._patched = []


def _key_recall(rows, truth: np.ndarray, k: int) -> float:
    """recall@k of keyed results (rows of keys, None where short) against
    slot ids; keys are row numbers in every phase that uses this."""
    hits = sum(len({x for x in r[:k] if x is not None}
                   & set(t[:k].tolist())) for r, t in zip(rows, truth))
    return hits / (k * len(truth))


def _exact_truth(base: np.ndarray, batches, metric: str,
                 dists: bool = False) -> tuple:
    """Top-10 ids of each batch from the exact tier on the card (K1's
    wgmma route, checked), and its launches by route; with ``dists`` the
    (dists, ids) pairs in place of the ids."""
    from hnsw_tpu_torch import ExactIndex
    _reset_launches()
    oracle = ExactIndex(metric=metric, device=DEVICE)
    oracle.host_serve_max_batch = 0
    oracle.batch_add(list(range(len(base))), base)
    gt = [oracle.batch_search_slots(b, 10) for b in batches]
    if not dists:
        gt = [i for _, i in gt]
    by = _launches()
    if DEVICE == "cuda" and len(base) >= 32768:
        check(by == {"wgmma": len(gt), "wgmma_cp": 0},
              f"the exact-tier oracle over {len(base)} rows launched the "
              f"wgmma kernel {by['wgmma']} times for {len(gt)} batches, the "
              f"wgmma_cp route {by['wgmma_cp']}")
    oracle.close()
    return gt, by


def phase_ivf_clustered() -> tuple:
    """Phase 11: IVFIndex on a 1,024-centre Gaussian mixture; returns K1's
    launches by route (the exact-tier oracle) and what phase 17 holds the
    block-sharded IVF and the multihost slices to: the index, its rows,
    the queries and the exact tier's (dists, ids) for them."""
    from hnsw_tpu_torch import IVFIndex
    from hnsw_tpu_torch.index import ivf as ivf_mod
    rng = np.random.default_rng(6)
    centres = rng.standard_normal((IVF_PARTS, DIM), dtype=np.float32)

    def draw(m):
        return (centres[rng.integers(0, IVF_PARTS, m)] + np.float32(0.3)
                * rng.standard_normal((m, DIM), dtype=np.float32))

    base, queries = draw(N_IVF), draw(BATCH)
    print(f"# ivf-1m-clustered: {N_IVF} x {DIM} cosine, {IVF_PARTS} mixture "
          f"centres (noise 0.3), {IVF_PARTS} partitions, k=10, batches of "
          f"{BATCH}", flush=True)
    idx = IVFIndex(num_partitions=IVF_PARTS, nprobe="auto", auto_recall=0.9,
                   device=DEVICE)
    watch = _Stopwatch()
    watch.wrap(idx, "_train", "train")
    watch.wrap(ivf_mod, "_device_assign", "assign")
    watch.wrap(idx, "_commit", "commit")
    t0 = time.perf_counter()
    idx.build(list(range(N_IVF)), base)
    t_build = time.perf_counter() - t0
    watch.restore()
    t0 = time.perf_counter()
    blocks = idx._sync()[0]
    _sync_device()
    t_sync = time.perf_counter() - t0
    sec = watch.seconds
    check(blocks.device.type == DEVICE and blocks.dtype == torch.float32
          and len(idx) == N_IVF,
          f"block table on {DEVICE}: {list(blocks.shape)} f32, "
          f"{blocks.numel() * 4 / 1e9:.3f} GB for {N_IVF} rows")
    st = idx.stats()
    print(f"  build {t_build:.1f} s: k-means ({idx.kmeans_iters} steps) "
          f"{sec['train']:.2f} s, assignment {sec['assign']:.2f} s, commit "
          f"(host loop over rows) {sec['commit']:.2f} s = "
          f"{sec['commit'] / t_build:.2f} of the build; block table "
          f"(_sync) {t_sync:.2f} s; partition sizes {st['sizes_min']}.."
          f"{st['sizes_max']}", flush=True)

    truth, launches = _exact_truth(base, [queries], "cosine", dists=True)
    gt = truth[0][1]
    recalls = {}
    for npb in IVF_NPROBES + ("auto",):
        idx.nprobe = npb
        t0 = time.perf_counter()
        used = idx._resolve_nprobe()       # "auto": calibrates, once
        t_cal = time.perf_counter() - t0
        keys, d = idx.batch_search(queries, 10)
        rec = recalls[npb] = _key_recall(keys, gt, 10)
        check(np.isfinite(d).all() and d.shape == (BATCH, 10)
              and all(x is not None for row in keys for x in row),
              f"nprobe={npb}: finite [{BATCH}, 10] results, no None key")
        qps = _qps(lambda: idx.batch_search(queries, 10), BATCH)
        watch = _Stopwatch()          # one more batch, its steps timed
        watch.wrap(idx, "_group_by_block", "group")
        watch.wrap(ivf_mod, "_scan_blocks", "scan")
        watch.wrap(idx, "_merge_positions", "merge_host")
        watch.wrap(ivf_mod, "_merge_probed", "merge")
        t0 = time.perf_counter()
        idx.batch_search(queries, 10)
        wall = time.perf_counter() - t0
        watch.restore()
        parts = dict(watch.seconds)
        host = parts["group"] + parts["merge_host"]
        parts["probe, copies, keys"] = wall - sum(parts.values())
        note = (f" (resolved to {used}, calibration {t_cal:.1f} s)"
                if npb == "auto" else "")
        print(f"  nprobe={npb}{note}: recall@10 {rec:.4f} vs the exact tier, "
              f"{qps:.1f} QPS (one {BATCH}-query batch, median of 3); a "
              f"batch with each step synchronised {wall * 1e3:.1f} ms: "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in parts.items())
              + f" ms; host grouping loops {host / wall:.2f} of it",
              flush=True)
    ladder = [recalls[n] for n in IVF_NPROBES]
    check(all(b >= a for a, b in zip(ladder, ladder[1:])),
          f"recall does not fall as nprobe grows: {ladder}")
    check(ladder[-1] >= 0.95,
          f"nprobe={IVF_NPROBES[-1]}: recall@10 {ladder[-1]:.4f} >= 0.95")
    check(recalls["auto"] >= 0.9, f'"auto" (auto_recall 0.9) serves '
          f"recall@10 {recalls['auto']:.4f} >= 0.9")
    if DEVICE == "cuda":
        idx.nprobe = 16
        _profile(f"one {BATCH}-query IVF batch at nprobe 16",
                 lambda: idx.batch_search(queries, 10), need="gemm")
    del blocks
    return launches, {"ivf": idx, "base": base, "queries": queries,
                      "truth": truth[0]}


def _single_queries(eng, queries, gt, k: int) -> tuple:
    """(p50 ms, mean ms, recall@k) of eng.search over ``queries``, one at
    a time, host clock (every arm returns numpy or floats: its device
    work has ended when it returns)."""
    lats, hits = [], 0
    for q, t in zip(queries, gt):
        t0 = time.perf_counter()
        res = eng.search(q, k)
        lats.append(time.perf_counter() - t0)
        hits += len({kk for kk, _ in res} & set(t[:k].tolist()))
    return (statistics.median(lats) * 1e3, statistics.fmean(lats) * 1e3,
            hits / (k * len(queries)))


def _arm_stats(eng) -> str:
    """The selector's sliding window by arm: samples held, mean measured
    recall (None where no probe scored the arm)."""
    return "; ".join(
        f"{s} {v['count']} samples, recall "
        + ("None" if v["avg_recall"] is None else f"{v['avg_recall']:.3f}")
        for s, v in eng.get_stats()["strategies"].items()
        if isinstance(v, dict))


def phase_adaptive(base: np.ndarray) -> dict:
    """Phase 12: the adaptive engine on the graph tier's rows; returns
    K1's launches by route (warm-up and oracle included)."""
    import dataclasses
    import shutil
    import tempfile

    from hnsw_tpu_torch import (AdaptiveConfig, AdaptiveHybridIndex,
                                HybridConfig)
    from hnsw_tpu_torch.index.streaming import StreamingExactIndex
    from hnsw_tpu_torch.ops.topk import np_exact_topk
    n = len(base)
    rng = np.random.default_rng(7)
    batches = [rng.standard_normal((BATCH, DIM), dtype=np.float32)
               for _ in range(N_ADAPT_BATCHES)]
    singles = rng.standard_normal((N_SINGLE, DIM), dtype=np.float32)
    print(f"# adaptive-100k: AdaptiveHybridIndex(exact_threshold=500, "
          f"capacity_arms=('int8',)) on {n} x {DIM} cosine, k=10, with a "
          f"StreamingExactIndex attached as the stream arm", flush=True)
    gt, launches = _exact_truth(base, batches + [singles], "cosine")
    gt_single = gt.pop()
    # the kernel-backed oracle itself, and below the served results, held
    # against numpy on the first batch and the first N_NUMPY single queries
    _, np_batch = np_exact_topk(batches[0], base, 10, "cosine")
    _, np_single = np_exact_topk(singles[:N_NUMPY], base, 10, "cosine")
    agree = (_recall(gt[0], np_batch, 10),
             _recall(gt_single[:N_NUMPY], np_single, 10))
    check(min(agree) >= 0.9999,
          f"the exact-tier oracle equals the numpy oracle over {n} rows: "
          f"recall@10 {agree[0]:.5f} on a batch of {BATCH}, {agree[1]:.5f} on "
          f"{N_NUMPY} queries (>= 0.9999)")

    eng = AdaptiveHybridIndex(HybridConfig(exact_threshold=500),
                              AdaptiveConfig(capacity_arms=("int8",)),
                              device=DEVICE)
    # the streaming (disk) tier as a user attaches it: before the writes,
    # in a directory of its own
    stream_dir = tempfile.mkdtemp(prefix="hnsw_adaptive_stream_")
    eng.attach_stream(StreamingExactIndex(stream_dir, metric="cosine",
                                          device=DEVICE))
    watch = _Stopwatch()
    for sub, name, label in ((eng.exact, "batch_add", "exact"),
                             (eng.graph, "build", "graph (native build)"),
                             (eng.lsh, "batch_add", "lsh (host loop)"),
                             (eng.ivf, "batch_add", "ivf"),
                             (eng.stream, "batch_add", "stream (mmap)")):
        watch.wrap(sub, name, label)
    t0 = time.perf_counter()
    eng.batch_add(list(range(n)), base)
    t_add = time.perf_counter() - t0
    watch.restore()
    check(len(eng) == len(eng.graph) == len(eng.lsh) == len(eng.ivf) == n
          and len(eng.capacity["exact_int8"]) == len(eng.stream) == n,
          f"every vector is in the exact, graph, LSH, IVF, int8 and "
          f"stream arms")
    print(f"  batch_add {t_add:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in watch.seconds.items())
          + " s", flush=True)

    # the int8 arm's capacity scans, from warm() to the arm called alone
    _cap_reset()
    _reset_launches()
    t0 = time.perf_counter()
    eng.warm(10)
    t_warm = time.perf_counter() - t0
    arms = set(eng.selector.explore) | {"hybrid"}
    check(eng._warmed == arms and eng.get_stats()["total_queries"] == 0,
          f"warm() ran and marked every arm {sorted(arms)}, recorded nothing")
    launches = _add(launches, _launches())
    print(f"  warm(10): {t_warm:.1f} s, K1 launches {_launches()}",
          flush=True)

    _reset_launches()
    t0 = time.perf_counter()
    outs = [eng.batch_search(b, 10) for b in batches]
    _sync_device()
    wall = time.perf_counter() - t0
    by_batches = _launches()
    rec = float(np.mean([_key_recall([[kk for kk, _ in r] for r in out], g,
                                     10) for out, g in zip(outs, gt)]))
    ok = all(len(r) == 10 and all(np.isfinite(d) for _, d in r)
             for out in outs for r in out)
    check(ok, f"{N_ADAPT_BATCHES} batches: 10 finite results a query")
    check(rec >= 0.95, f"batches: recall@10 {rec:.4f} >= 0.95 against the "
          f"exact tier ({N_ADAPT_BATCHES * BATCH} queries)")
    rec_np = _key_recall([[kk for kk, _ in r] for r in outs[0]], np_batch,
                         10)
    check(rec_np >= 0.95, f"the first served batch: recall@10 {rec_np:.4f} "
          f">= 0.95 against the numpy oracle")
    if DEVICE == "cuda":
        check(by_batches["wgmma"] >= 1 and by_batches["wgmma_cp"] == 0,
              f"the engine's exact arm and recall probes launched the wgmma "
              f"kernel {by_batches['wgmma']} times over the batches")
    print(f"  {N_ADAPT_BATCHES} batches of {BATCH}: "
          f"{N_ADAPT_BATCHES * BATCH / wall:.1f} QPS (one pass), recall@10 "
          f"{rec:.4f}; window by arm: {_arm_stats(eng)}; _graph_ef "
          f"{eng._graph_ef}", flush=True)

    _reset_launches()
    p50, mean, rec1 = _single_queries(eng, singles, gt_single, 10)
    check(mean / p50 < 20, f"single queries after warm(): mean / p50 "
          f"{mean / p50:.2f} < 20")
    by_single = _launches()
    rec1_np = _key_recall(
        [[kk for kk, _ in eng.search(q, 10)] for q in singles[:N_NUMPY]],
        np_single, 10)
    by_np = {r: c - by_single[r] for r, c in _launches().items()}
    check(rec1_np >= 0.95, f"{N_NUMPY} single queries served again: "
          f"recall@10 {rec1_np:.4f} >= 0.95 against the numpy oracle (K1 "
          f"launches {by_np})")
    print(f"  {N_SINGLE} single queries: p50 {p50:.3f} ms, mean {mean:.3f} "
          f"ms, recall@10 {rec1:.4f}; K1 launches {by_single}; window by "
          f"arm: {_arm_stats(eng)}; _graph_ef {eng._graph_ef}", flush=True)

    # the exact arm and the probe oracle, called alone: one launch each
    _reset_launches()
    eng._run_batch("exact", batches[0], 10)
    probe = eng._probe_oracle(batches[0][:32], 10)
    by_direct = _launches()
    if DEVICE == "cuda":
        check(by_direct == {"wgmma": 2, "wgmma_cp": 0},
              f"the exact arm's table ({eng.exact._dev[0].shape[0]} padded "
              f"rows) and the recall probe each launched the wgmma kernel "
              f"once: {by_direct}")
    check(_key_recall(probe, gt[0][:32], 10) == 1.0,
          "the probe oracle equals the exact tier on 32 queries")
    # the int8 arm called alone: one capacity screen launch over its
    # table of n rows (capacity_applies: a CUDA int8 table, kk = 26)
    from hnsw_tpu_torch.ops import exact_screen
    before = exact_screen.capacity_launches_by_store["int8"]
    out8 = eng._run_batch("exact_int8", batches[0], 10)
    arm8 = exact_screen.capacity_launches_by_store["int8"] - before
    rec8 = _key_recall([[kk for kk, _ in r] for r in out8], gt[0], 10)
    if DEVICE == "cuda":
        check(arm8 == 1, f"the int8 arm alone launched the capacity screen "
              f"once ({arm8})")
    check(rec8 >= 0.99, f"the int8 arm alone: recall@10 {rec8:.4f} >= 0.99 "
          f"against the exact tier")
    check(eng.fallback_errors == 0,
          f"fallback_errors == 0 (last: {eng.last_fallback_error!r})")

    # the stream arm: every query of two batches explores it and each
    # batch is probed (the JAX spec's recipe, exploration 1.0 and a probe
    # a call); the arm scans one chunk of n rows, past K1's switch
    cfg, explore = eng.selector.cfg, eng.selector.explore
    eng.selector.cfg = dataclasses.replace(cfg, exploration_factor=1.0,
                                           recall_probe_interval=1)
    eng.selector.explore = ("stream",)
    _reset_launches()
    t0 = time.perf_counter()
    outs = [eng.batch_search(b, 10) for b in batches[:2]]
    t_stream = time.perf_counter() - t0
    by_stream = _launches()
    eng.selector.cfg, eng.selector.explore = cfg, explore
    st = eng.selector.metrics.stats("stream")
    arm_rec = None if st is None else st.avg_recall()
    rec_s = float(np.mean([_key_recall([[kk for kk, _ in r] for r in out],
                                       g, 10)
                           for out, g in zip(outs, gt[:2])]))
    check(arm_rec is not None and arm_rec >= 0.99 and rec_s >= 0.99,
          f"stream arm: measured recall {arm_rec} >= 0.99, served recall@10 "
          f"{rec_s:.4f} >= 0.99 against the exact tier (2 batches)")
    _reset_launches()
    eng._run_batch("stream", batches[0], 10)
    by_arm = _launches()
    if DEVICE == "cuda":
        check(by_stream["wgmma"] >= 2 and by_stream["wgmma_cp"] == 0
              and by_arm == {"wgmma": 1, "wgmma_cp": 0},
              f"stream arm: the 2 batches and their probes launched the "
              f"wgmma kernel {by_stream['wgmma']} times; one batch of the "
              f"arm alone (one {n}-row chunk) once: {by_arm}")
    check(eng.fallback_errors == 0,
          f"fallback_errors == 0 after the stream batches (last: "
          f"{eng.last_fallback_error!r})")
    print(f"  stream arm, 2 batches of {BATCH}, each probed: "
          f"{2 * BATCH / t_stream:.1f} QPS, served recall@10 {rec_s:.4f}, "
          f"measured {arm_rec:.4f}; K1 launches {by_stream} (the arm alone "
          f"{by_arm})", flush=True)
    for b in (by_batches, by_single, by_np, by_direct, by_stream, by_arm):
        launches = _add(launches, b)
    cap = dict(exact_screen.capacity_launches_by_store)
    _cap_read("the adaptive engine (warm(), batches, single queries, the "
              "probes, the int8 arm alone)", {"int8": max(1, cap["int8"])})
    print(f"  the int8 arm: recall@10 {rec8:.4f} alone; capacity screen "
          f"launches in this phase {cap}", flush=True)

    # the LSH arm alone (4 tables x 8 bits): no bound, for the record
    lsh = eng.lsh
    sizes = [len(lsh.get_candidates(q)) for q in batches[0][:256]]
    watch = _Stopwatch()
    watch.wrap(lsh, "get_candidates", "candidates")
    t0 = time.perf_counter()
    keys, _ = lsh.batch_search(batches[0], 10)
    _sync_device()
    t_lsh = time.perf_counter() - t0
    watch.restore()
    print(f"  LSH arm ({lsh.num_tables} tables x {lsh.num_bits} bits) at {n} "
          f"rows: recall@10 {_key_recall(keys, gt[0], 10):.4f}, candidates "
          f"a query min / median / max {min(sizes)} / "
          f"{int(statistics.median(sizes))} / {max(sizes)}; one "
          f"{BATCH}-query batch {t_lsh * 1e3:.1f} ms, its per-query "
          f"candidate loop {watch.seconds['candidates'] / t_lsh:.2f} of it",
          flush=True)
    if DEVICE == "cuda":
        _profile(f"one {BATCH}-query adaptive batch",
                 lambda: eng.batch_search(batches[1], 10))
    eng.close()
    shutil.rmtree(stream_dir, ignore_errors=True)
    del eng
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return launches


def phase_hybrid_bench() -> None:
    """Phase 13: bench.py's configuration (10,000 x 128 cosine Gaussian
    rows from seed 0, k=10) through HybridIndex and AdaptiveHybridIndex.
    Below K1's 32,768-row switch: no launch is expected or counted. The
    engine's single queries are answered by each arm's host latency tier
    (ExactIndex at <= 16 queries over <= 65,536 rows, the LSH index at
    <= 16 queries, the graph's native search), as in the JAX package:
    the phase prints the arms that served and the device work queued."""
    from hnsw_tpu_torch import (AdaptiveHybridIndex, HybridConfig,
                                HybridIndex)
    from hnsw_tpu_torch.ops.topk import np_exact_topk
    n, k = N_BENCH, 10
    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, DIM)).astype(np.float32)
    queries = rng.standard_normal((N_BATCHES * BATCH, DIM)).astype(
        np.float32)
    batches = [queries[b:b + BATCH] for b in range(0, len(queries), BATCH)]
    gt = np.concatenate([np_exact_topk(b, data, k, "cosine")[1]
                         for b in batches])
    print(f"# hybrid-bench-10k: {n} x {DIM} cosine, k={k}, "
          f"HybridConfig(exact_threshold=500), {N_BATCHES} batches of "
          f"{BATCH}; recall against the numpy oracle", flush=True)
    h = HybridIndex(HybridConfig(exact_threshold=500), device=DEVICE)
    t0 = time.perf_counter()
    h.batch_add(list(range(n)), data)
    print(f"  batch_add {time.perf_counter() - t0:.1f} s; tiers: exact "
          f"{len(h.exact)}, graph {len(h.graph)}, lsh {len(h.lsh)}, ivf "
          f"{len(h.ivf)}", flush=True)

    def serve(target):
        rows, t_all = [], []
        for b in batches:
            t0 = time.perf_counter()
            keys, d = h.batch_search(b, k, target_recall=target)
            _sync_device()
            t_all.append(time.perf_counter() - t0)
            if not rows:
                check(np.isfinite(d).all() and d.shape == (len(b), k),
                      f"target_recall={target}: finite [{len(b)}, {k}] "
                      f"results")
            rows.extend(keys)
        # the first batch pays the calibration: QPS over the others
        return rows, t_all[0], (len(queries) - BATCH) / sum(t_all[1:])

    for target, floor in ((0.95, 0.93), (1.0, 0.999), (None, None)):
        rows, t_first, qps = serve(target)
        rec = _key_recall(rows, gt, k)
        if floor is not None:
            check(rec >= floor, f"target_recall={target}: served recall@10 "
                  f"{rec:.4f} >= {floor}")
        print(f"  target_recall={target}: route {h.stats.last_strategy!r}, "
              f"recall@10 {rec:.4f}, {qps:.1f} QPS (batches 2-{N_BATCHES}; "
              f"the first, with any calibration, {t_first:.2f} s)",
              flush=True)

    doomed = list(range(0, n, 10))
    t0 = time.perf_counter()
    flags = h.batch_delete(doomed)
    t_del = time.perf_counter() - t0
    keys, d = h.batch_search(batches[0], k)
    dead = set(doomed)
    check(all(flags) and len(h) == n - len(doomed)
          and not any(x in dead for row in keys for x in row),
          f"batch_delete of {len(doomed)} keys ({t_del:.2f} s): no deleted "
          f"key is returned")
    h.close()
    del h

    eng = AdaptiveHybridIndex(hybrid_config=HybridConfig(exact_threshold=500),
                              device=DEVICE)
    eng.batch_add(list(range(n)), data)
    eng.warm(k)
    for i in range(64):               # steady state, as bench.py runs it
        eng.search(queries[i], k)
    p50, mean, rec = _single_queries(eng, queries[64:64 + N_SINGLE],
                                     gt[64:64 + N_SINGLE], k)
    check(eng.fallback_errors == 0 and rec >= 0.95,
          f"adaptive engine, single queries: recall@10 {rec:.4f} >= 0.95, "
          f"fallback_errors == 0")
    print(f"  adaptive engine, {N_SINGLE} single queries after warm() and 64 "
          f"warm queries: p50 {p50:.3f} ms, mean {mean:.3f} ms, recall@10 "
          f"{rec:.4f}; window by arm: {_arm_stats(eng)}", flush=True)
    # who served them: the arms of 64 more single queries, and the device
    # work they queued (none where each arm's host latency tier answers)
    arms, real_run = {}, eng._run

    def counted(strategy, query, k_):
        arms[strategy] = arms.get(strategy, 0) + 1
        return real_run(strategy, query, k_)
    eng._run = counted
    more = queries[64 + N_SINGLE:128 + N_SINGLE]
    n_ev, dev_ms = _device_work(lambda: [eng.search(q, k) for q in more])
    del eng._run
    where = ("device work not traced off CUDA" if n_ev is None else
             "no device work: these latencies are the host latency "
             "tiers', not the card's" if n_ev == 0 else
             f"{n_ev} kernel launches, {dev_ms:.3f} ms of device work")
    print(f"  64 more single queries under torch.profiler: arm calls "
          f"{arms}; {where}", flush=True)
    eng.close()
    del eng
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def phase_streaming(kept: dict) -> dict:
    """Phase 14: StreamingExactIndex at BIGANN-10M's shape: phase 6's rows
    (seed 2) written into a fresh memory-mapped row file, streamed in
    131,072-row float32 chunks through K1, cold, warm (every chunk pinned
    on the card) and with a 2 GB budget, then one cold batch of each
    reduced rung. Held to phase 6's float32 rung on its first batch.
    Returns K1's launches by route."""
    import shutil
    import tempfile

    from hnsw_tpu_torch.index import streaming as sm
    from hnsw_tpu_torch.io.mmap_store import MmapVectorStore
    from hnsw_tpu_torch.ops.topk import exact_topk
    rows, q = kept["rows"], kept["queries"]
    want_d, want_i = kept["dists"], kept["ids"]
    n = len(rows)
    file_bytes = n * DIM * 4
    d = tempfile.mkdtemp(prefix="hnsw_stream_")
    free = shutil.disk_usage(d).free
    print(f"# streaming-bigann10m-shape: StreamingExactIndex(metric='l2', "
          f"chunk_rows=131072) over {n} x {DIM} rows (phase 6's), batches of "
          f"{len(q)}, k=10; {d}: {free / 1e9:.1f} GB free for a "
          f"{file_bytes / 1e9:.2f} GB row file", flush=True)
    try:
        check(free >= 2 * file_bytes, f"{free / 1e9:.1f} GB free >= twice "
              f"the {file_bytes / 1e9:.2f} GB row file")
        t0 = time.perf_counter()
        MmapVectorStore(d, dim=DIM, capacity=n).flush()   # sized up front
        idx = sm.StreamingExactIndex(d, metric="l2", device=DEVICE)
        for c0 in range(0, n, 1 << 20):
            c1 = min(n, c0 + (1 << 20))
            idx.batch_add(range(c0, c1), rows[c0:c1])
        idx.flush()
        t_write = time.perf_counter() - t0
        step = idx.chunk_rows
        n_chunks = -(-n // step)
        print(f"  wrote the index in {t_write:.1f} s ({n_chunks} chunks); "
              f"the page cache holds the file just written, so 'cold' "
              f"below is a read from memory, not from the disk",
              flush=True)

        def batch():
            return idx.batch_search_slots(q, 10)

        def timed_batch():
            _sync_device()
            t = time.perf_counter()
            out = batch()
            return out, time.perf_counter() - t

        launches = {}
        _reset_launches()
        (dc, ic), t_first = timed_batch()
        by = _launches()
        launches = _add(launches, by)
        if DEVICE == "cuda":
            check(by == {"wgmma": n_chunks, "wgmma_cp": 0},
                  f"one cold batch launched the wgmma kernel {by['wgmma']} "
                  f"times ({n_chunks} chunks of >= 32768 rows), the wgmma_cp "
                  f"route {by['wgmma_cp']}")
        same = float(np.mean(ic == want_i))
        rec_t = _recall_ties(dc, want_d, 1e-4)
        check(np.isfinite(dc).all() and (same == 1.0 or rec_t == 1.0),
              f"stream vs phase 6's float32 rung ({len(q)} queries): ids "
              f"equal at {same:.5f} of the positions, tie-aware recall@10 "
              f"{rec_t:.4f} (ties within 1e-4)")
        _reset_launches()
        qps_cold = _qps(batch, len(q))
        launches = _add(launches, _launches())
        print(f"  cold (cache off): {qps_cold:.1f} QPS (median of 3 "
              f"batches; the first {t_first:.3f} s)", flush=True)

        chunk_bytes = (step * DIM * 4 + step * 5)
        idx.hbm_cache_bytes = n_chunks * chunk_bytes
        _reset_launches()
        _, t_fill = timed_batch()
        check(len(idx._cache) == n // step and
              all(e[0].device.type == DEVICE for e in idx._cache.values()),
              f"warm: {len(idx._cache)} full chunks pinned on {DEVICE} "
              f"({idx._cache_bytes / 1e9:.2f} GB; the short last one "
              f"streams)")
        (dw, iw), t_warm = timed_batch()
        check(np.array_equal(iw, ic), "warm: ids equal the cold batch's")
        qps_warm = _qps(batch, len(q))
        by_warm = _launches()
        launches = _add(launches, by_warm)
        print(f"  warm (hbm_cache_bytes {idx.hbm_cache_bytes / 1e9:.2f} GB): "
              f"{qps_warm:.1f} QPS (median of 3; the filling batch "
              f"{t_fill:.3f} s)", flush=True)

        # the predicate's evidence: the same warm batch with every chunk
        # on the plain exact_topk scan
        real = sm.exact_scan
        sm.exact_scan = (lambda qq, vv, ss, aa, **kw:
                         exact_topk(qq, vv, ss, aa, **kw))
        try:
            _reset_launches()
            (dp, ip), t_plain = timed_batch()
            plain_launches = _launches()
        finally:
            sm.exact_scan = real
        diff = ip != iw
        err = float(np.abs(dp - dw).max())
        check(plain_launches == {"wgmma": 0, "wgmma_cp": 0}
              and np.all(np.abs(dp[diff] - dw[diff]) <= 1e-4)
              and diff.mean() <= 1e-3 and err <= 1e-3,
              f"warm batch, plain exact_topk per chunk: ids equal at "
              f"{1 - diff.mean():.5f} of the positions (the rest near ties "
              f"within 1e-4), dists within {err:.2e}")
        print(f"  one warm batch: K1 per chunk {t_warm * 1e3:.1f} ms, plain "
              f"exact_topk per chunk {t_plain * 1e3:.1f} ms", flush=True)

        idx._cache.clear()
        idx._cache_bytes = 0
        idx.hbm_cache_bytes = 2_000_000_000
        _reset_launches()
        _, t_fill = timed_batch()
        pinned = len(idx._cache)
        (db, ib), _ = timed_batch()
        check(np.array_equal(ib, ic) and 0 < pinned < n_chunks,
              f"2 GB budget: {pinned} of {n_chunks} chunks pinned, ids "
              f"equal the cold batch's")
        qps_part = _qps(batch, len(q))
        launches = _add(launches, _launches())
        print(f"  2 GB budget ({pinned} chunks warm, {n_chunks - pinned} "
              f"cold): {qps_part:.1f} QPS (median of 3)", flush=True)

        idx._cache.clear()
        idx._cache_bytes = 0
        idx.hbm_cache_bytes = 0
        _cap_reset()
        for rd in ("bf16", "fp16", "int8"):
            idx.stream_dtype = rd
            _reset_launches()
            (dr, ir), t_r = timed_batch()
            check(_launches() == {"wgmma": 0, "wgmma_cp": 0},
                  f"{rd}: the reduced scan runs without K1")
            rec = _recall(ir, ic, 10)
            check(np.isfinite(dr).all() and rec >= 0.99,
                  f"{rd}: recall@10 {rec:.4f} >= 0.99 against the float32 "
                  f"stream")
            print(f"  {rd}, one cold batch: {t_r:.3f} s = "
                  f"{len(q) / t_r:.1f} QPS, recall@10 {rec:.4f}",
                  flush=True)
        _cap_read(f"one cold batch of each reduced rung ({n_chunks} chunks "
                  f"of >= 32768 rows each)",
                  dict.fromkeys(("bf16", "fp16", "int8"), n_chunks))
        idx.stream_dtype = "float32"
        print(f"  K1 launches in this phase: {launches}", flush=True)
        idx.close()
        del idx
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return launches


def phase_disk_graph(st: dict) -> dict:
    """Phase 15: phase 5's 100k graph written into a DiskGraph directory
    (npz tables, no rebuild), reopened and served; 200 adds and 100
    deletes through the WAL, an incremental reopen; then the same
    directory with vectors on disk and the int8 store on the card.
    Returns K1's launches by route (the exact-tier oracle)."""
    import shutil
    import tempfile

    from hnsw_tpu_torch import DiskGraph, ExactIndex, Graph, StoreConfig
    g, base, queries = st["g"], st["base"], st["queries"]
    n = len(base)
    d = tempfile.mkdtemp(prefix="hnsw_disk_")

    def cfg(**kw):
        return StoreConfig(directory=d, format="npz",
                           wal_flush_interval_seconds=0, **kw)

    def same_serving(x):
        x.native_serve_max_batch = 0
        for name in ("fast_math", "entry_mode", "merge_strategy",
                     "split_layers", "hbm_mode", "block_layout"):
            setattr(x, name, getattr(g, name))

    builds = {"n": 0}
    real_build = Graph.build

    def counted_build(self, *a, **kw):
        builds["n"] += 1
        return real_build(self, *a, **kw)

    print(f"# disk-graph-100k: phase 5's graph ({n} x {DIM} cosine) in a "
          f"DiskGraph directory, npz tables", flush=True)
    try:
        t0 = time.perf_counter()
        DiskGraph(d, store_config=cfg(), device=DEVICE)._persist(g)
        t_persist = time.perf_counter() - t0
        Graph.build = counted_build
        try:
            with _NativeInserts() as nat:
                t0 = time.perf_counter()
                dg = DiskGraph(d, store_config=cfg(), device=DEVICE)
                t_open = time.perf_counter() - t0
        finally:
            Graph.build = real_build
        check(builds["n"] == 0 and nat.calls == 0 and len(dg) == n,
              f"reopen restores the structure of {len(dg)} keys without a "
              f"build")
        same_serving(dg.graph)
        k_a, d_a = g.batch_search(queries, 10, ef=64)
        k_b, d_b = dg.graph.batch_search(queries, 10, ef=64)
        check(k_a == k_b and np.array_equal(d_a, d_b),
              f"reopened graph at ef 64: keys and distances equal phase 5's "
              f"({len(queries)} queries)")
        rng = np.random.default_rng(9)
        new_keys = list(range(n, n + 200))
        new_vecs = rng.standard_normal((200, DIM), dtype=np.float32)
        doomed = list(range(0, 1000, 10))
        dg.batch_add(new_keys, new_vecs)
        flags = dg.batch_delete(doomed)
        check(all(flags), "batch_delete of 100 keys")
        dg.close()
        t0 = time.perf_counter()
        dg = DiskGraph(d, store_config=cfg(), device=DEVICE)
        t_inc = time.perf_counter() - t0
        dg.graph.native_serve_max_batch = 0
        gone = [k for k in doomed if dg.graph.lookup(k) is not None]
        _, hit = dg.graph.batch_search_slots(new_vecs, 1, ef=64)
        found = float(np.mean([dg.graph.slots.key_of(int(s)) == key
                               for s, key in zip(hit[:, 0], new_keys)]))
        check(len(dg) == n + 100 and not gone and found >= 0.99
              and dg.wal.num_log_files > 0,
              f"incremental reopen ({dg.wal.num_log_files} WAL log(s) kept): "
              f"{len(dg)} keys, the 100 deleted gone, the 200 new found "
              f"({found:.3f} of them their own nearest neighbour)")
        stats = dg.stats()
        dg._stop_flusher.set()

        # the exact tier over the live rows, for the disk-resident reopen
        live = [k for k in range(n) if k not in set(doomed)] + new_keys
        rows = np.concatenate([np.delete(base, doomed, axis=0), new_vecs])
        _reset_launches()
        oracle = ExactIndex(metric="cosine", device=DEVICE)
        oracle.batch_add(live, rows)
        truth, _ = oracle.batch_search(queries, 10)
        oracle.close()
        launches = _launches()
        t0 = time.perf_counter()
        dq = DiskGraph(d, store_config=cfg(vectors_on_disk=True,
                                           hbm_mode="quantized"),
                       device=DEVICE)
        t_mm = time.perf_counter() - t0
        dq.graph.native_serve_max_batch = 0
        check(type(dq.graph.store).__name__ == "MmapVectorStore"
              and dq.graph.device_graph().qvec is not None
              and tuple(dq.graph.device_graph().vectors.shape) == (1, DIM),
              "vectors_on_disk + hbm_mode='quantized': a Graph over an "
              "MmapVectorStore, only the int8 store on the card")
        recs = {}
        for ef in (64, 192):
            keys, dist = dq.graph.batch_search(queries, 10, ef=ef)
            recs[ef] = sum(len(set(a) & set(b)) for a, b in
                           zip(keys, truth)) / (10 * len(queries))
            check(np.isfinite(dist).all(), f"quantized over mmap, ef {ef}: "
                  f"finite distances")
        dq._stop_flusher.set()
        print(f"  persist {t_persist:.2f} s, reopen {t_open:.2f} s, "
              f"incremental reopen (200 adds, 100 deletes) {t_inc:.2f} s, "
              f"reopen over mmap {t_mm:.2f} s; recall@10 over mmap + int8 "
              f"{recs[64]:.4f} / {recs[192]:.4f} at ef 64 / 192 vs the exact "
              f"tier; stats {stats}", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return launches


def phase_facets(st: dict) -> dict:
    """Phase 16: facets, metadata and the analyzer on phase 5's graph.
    Returns K1's launches by route (the masked exact scans)."""
    from hnsw_tpu_torch import (Analyzer, EqualityFilter, Facet,
                                FacetedGraph, MetadataGraph, RangeFilter)
    from hnsw_tpu_torch.ops.topk import np_exact_topk
    g, base, queries = st["g"], st["base"], st["queries"]
    n = len(base)
    vals = np.random.default_rng(10).integers(0, 100, n)
    fg = FacetedGraph(g)
    for key in range(n):                      # the store, not Graph.add
        fg.store.add(key, [Facet("bucket", int(vals[key]))])
    print(f"# facets-100k: phase 5's graph, a facet of 100 values on its "
          f"{n} keys, {len(queries)} queries, k=10", flush=True)
    launches = {}
    for label, flt, allowed in (
            ("equality (1%)", EqualityFilter("bucket", 7), vals == 7),
            ("range (10%)", RangeFilter("bucket", 10, 19),
             (vals >= 10) & (vals <= 19))):
        rows = np.flatnonzero(allowed)
        t_d, t_i = np_exact_topk(queries, base[rows], 10, "cosine")
        t_i = rows[t_i]
        _reset_launches()
        t0 = time.perf_counter()
        res = fg.batch_search_exact(queries, 10, [flt])
        t_exact = time.perf_counter() - t0
        by = _launches()
        launches = _add(launches, by)
        got_d = np.array([[dd for _, dd in r] for r in res], np.float32)
        got_i = np.array([[kk for kk, _ in r] for r in res])
        rec = _recall(got_i, t_i, 10)
        rec_t = _recall_ties(got_d, t_d)
        check(got_i.shape == (len(queries), 10)
              and bool(allowed[got_i].all()) and rec_t == 1.0,
              f"{label}: batch_search_exact recall@10 {rec:.4f} (ties within "
              f"1e-5: {rec_t:.4f} == 1) against numpy over the {len(rows)} "
              f"allowed rows, every result allowed")
        if DEVICE == "cuda":
            check(by == {"wgmma": 1, "wgmma_cp": 0},
                  f"{label}: the masked scan of {g.device_graph().cap} slots "
                  f"launched the wgmma kernel once: {by}")
        t0 = time.perf_counter()
        over = fg.batch_search(queries, 10, [flt])
        t_over = time.perf_counter() - t0
        rec_o = _key_recall([[kk for kk, _ in r] for r in over], t_i, 10)
        print(f"  {label}: batch_search_exact {t_exact * 1e3:.1f} ms, "
              f"recall@10 {rec:.4f}; batch_search (over-fetch x3 + "
              f"post-filter, ef {g.ef_search}) {t_over * 1e3:.1f} ms, recall@10 "
              f"{rec_o:.4f}", flush=True)

    mg = MetadataGraph(g)
    for key in range(n):
        mg.store.add(key, {"row": key, "bucket": int(vals[key])})
    out = mg.batch_search(queries[:64], 10)
    check(all(len(r) == 10 and all(x["metadata"]["row"] == x["key"]
                                   and np.isfinite(x["dist"]) for x in r)
              for r in out),
          "MetadataGraph.batch_search attaches each key's payload (64 "
          "queries)")
    # height, topography, connectivity (quality_metrics' BFS over sampled
    # pairs is a host loop; the CPU tests hold it to JAX's)
    a = Analyzer(g)
    t0 = time.perf_counter()
    topo, conn = a.topography(), a.connectivity()
    check(a.height() == g.num_layers and topo[0] == n,
          f"Analyzer: height {a.height()}, {topo[0]} nodes on layer 0")
    print(f"  Analyzer ({time.perf_counter() - t0:.2f} s): height "
          f"{a.height()}, topography {topo}, connectivity "
          f"{[round(c, 2) for c in conn]}", flush=True)
    return launches


def _timed(fn):
    _sync_device()
    t = time.perf_counter()
    out = fn()
    _sync_device()
    return out, time.perf_counter() - t


def _p17_exact(mesh, kept: dict) -> dict:
    """Phase 17.1-2: phase 6's rows row-sharded; K1 on every shard, then
    the int8 capacity candidates + host rerank. Returns K1's launches by
    route."""
    from types import SimpleNamespace

    from hnsw_tpu_torch.parallel.sharded import (sharded_exact_topk,
                                                 sharded_quantized_candidates)
    from hnsw_tpu_torch.utils.rerank import host_rerank
    rows, q_np = kept["rows"], kept["queries"]
    want_d, want_i = kept["dists"], kept["ids"]
    n, S = len(rows), mesh.shape["data"]
    dev = mesh.devices[0]
    t0 = time.perf_counter()
    v = torch.empty((n, DIM), dtype=torch.float32, device=dev)
    for c0 in range(0, n, 1 << 20):
        v[c0:c0 + (1 << 20)].copy_(torch.from_numpy(rows[c0:c0 + (1 << 20)]))
    sq = torch.from_numpy(kept["sq"]).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q = torch.from_numpy(q_np).to(dev)
    _sync_device()
    print(f"# sharded-exact-bigann10m-shape: phase 6's {n} x {DIM} L2 rows "
          f"over {S} row shards of {n // S} on {mesh.devices[0]}, k=10, "
          f"{len(q_np)}-query batches; upload {time.perf_counter() - t0:.1f} "
          f"s", flush=True)

    def exact():
        return sharded_exact_topk(q, v, sq, valid, k=10, metric="l2",
                                  mesh=mesh)

    _reset_launches()
    (d, i), t_first = _timed(exact)
    by = _launches()
    d, i = d.cpu().numpy(), i.cpu().numpy()
    same = float(np.mean(i == want_i))
    rec_t = _recall_ties(d, want_d, 1e-4)
    check(np.isfinite(d).all() and (same == 1.0 or rec_t == 1.0),
          f"row-sharded exact vs phase 6's float32 rung: ids equal at "
          f"{same:.5f} of the positions, tie-aware recall@10 {rec_t:.4f} "
          f"(ties within 1e-4)")
    if DEVICE == "cuda":
        check(by["wgmma"] == S and by["wgmma_cp"] == 0,
              f"one batch launched K1's wgmma route {by['wgmma']} times "
              f"(once a shard), the wgmma_cp route {by['wgmma_cp']}")
    _reset_launches()
    qps = _qps(exact, len(q_np))
    launches = _add(by, _launches())
    print(f"  row-sharded exact: {qps:.1f} QPS (median of 3; the first "
          f"batch {t_first:.3f} s) beside phase 6's single table "
          f"{kept['qps']:.1f} QPS; K1 launches by route in those 4 batches "
          f"{launches}", flush=True)

    # int8 capacity: per-row scales, quantised on the card a chunk at a time
    t0 = time.perf_counter()
    v8 = torch.empty((n, DIM), dtype=torch.int8, device=dev)
    scales = torch.empty(n, dtype=torch.float32, device=dev)
    for c0 in range(0, n, 1 << 20):
        blk = v[c0:c0 + (1 << 20)]
        amax = blk.abs().amax(dim=1)
        sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        scales[c0:c0 + (1 << 20)] = sc
        v8[c0:c0 + (1 << 20)] = torch.clamp(torch.round(blk / sc[:, None]),
                                            -127, 127).to(torch.int8)
    del v
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    _sync_device()
    t_q = time.perf_counter() - t0
    store = SimpleNamespace(capacity=n, sq_norms=kept["sq"],
                            get_batch=lambda s: rows[s])

    def capacity():
        _, cand = sharded_quantized_candidates(q, v8, scales, sq, valid,
                                               kk=10 + 16, metric="l2",
                                               mesh=mesh)
        return host_rerank(store, "l2", q_np, cand.cpu().numpy(), 10)

    _reset_launches()
    _cap_reset()
    (_, i8), t_first = _timed(capacity)
    check(_launches() == {"wgmma": 0, "wgmma_cp": 0},
          "int8 shards scan without the float32 kernel")
    rec = _recall(i8, i, 10)
    check(rec >= 0.99, f"row-sharded int8 + host rerank: recall@10 "
          f"{rec:.4f} >= 0.99 against the row-sharded exact ids")
    qps8 = _qps(capacity, len(q_np))
    _cap_read(f"4 batches over {S} int8 shards of {n // S} rows (once a "
              f"shard a batch)", {"int8": 4 * S})
    print(f"  row-sharded int8 (kk=26) + host rerank: {qps8:.1f} QPS (median "
          f"of 3; the first batch {t_first:.3f} s), recall@10 {rec:.4f}; "
          f"quantised on the card in {t_q:.1f} s, "
          f"{v8.numel() / 1e9:.2f} GB", flush=True)
    del v8, scales, sq, valid
    return launches


def _p17_graphs(mesh, graph: dict) -> None:
    """Phase 17.3-5: the 100k graph query-sharded and row-sharded, and a
    PartitionedGraph over the same rows."""
    from hnsw_tpu_torch import GraphConfig
    from hnsw_tpu_torch.core.search import pivot_seeds, search_graph
    from hnsw_tpu_torch.parallel.partitioned import PartitionedGraph
    from hnsw_tpu_torch.parallel.rowsharded import (make_row_shards,
                                                    rowsharded_graph_search)
    from hnsw_tpu_torch.parallel.sharded import sharded_graph_search
    g, base, q_np, gt = (graph[k] for k in ("g", "base", "queries", "gt"))
    dev = mesh.devices[0]
    S = mesh.shape["data"]
    _beam_reset()
    q = torch.from_numpy(q_np).to(dev)
    g.hbm_mode, g.fast_math, g.entry_mode = "full", False, "descent"
    print(f"# sharded-graph-100k: phase 5's graph ({len(g)} x {DIM} cosine, "
          f"split_layers={g.split_layers!r}), {len(q_np)} queries, k=10, "
          f"{S} shards on {dev}", flush=True)
    for store in ("full", "float16"):
        g.hbm_mode = store
        dg = g.device_graph()
        for ef in (64, 192):
            kw = dict(k=10, ef=ef, metric="cosine", max_hops=128)
            _, i1 = search_graph(dg, q, **kw)
            (_, i8), t8 = _timed(lambda: sharded_graph_search(
                dg, q, mesh=mesh, **kw))
            i1, i8 = i1.cpu().numpy(), i8.cpu().numpy()
            ov = _overlap(i8, i1)
            check(ov >= 0.99, f"query-sharded {store} ef={ef}: id overlap "
                  f"{ov:.4f} >= 0.99 with one search of the whole batch")
            qps = _qps(lambda: sharded_graph_search(dg, q, mesh=mesh, **kw),
                       len(q_np), reps=1)
            print(f"  query-sharded {store} store ef={ef}: {qps:.1f} QPS "
                  f"({S} parts of {len(q_np) // S}; phase 5's batch_search "
                  f"{graph['qps'].get(ef, float('nan')):.1f}), ids equal to "
                  f"the whole batch's at {np.mean(i8 == i1):.5f} of the "
                  f"positions, overlap {ov:.4f}, recall@10 "
                  f"{_recall(i8, gt, 10):.4f}", flush=True)
    g.hbm_mode = "full"

    print(f"# rowsharded-graph-100k: make_row_shards(g, {S}), pivot entry "
          f"(16 seeds), expand 2", flush=True)
    g.entry_mode = "pivots"
    dg = g.device_graph()
    pids, pvecs, psq = g._pivot_arrays()
    seeds = pivot_seeds(q, pvecs, psq, pids, s=16, metric="cosine")
    for dtype in (None, "float16"):
        shards = make_row_shards(g, S, dtype=dtype)
        for ef in (64, 192):
            _, i1 = search_graph(dg, q, k=10, ef=ef, metric="cosine",
                                 expand=2, seed_ids=seeds, merge="bitonic")
            stats: dict = {}

            def rs(stats=None):
                return rowsharded_graph_search(shards, q, k=10, ef=ef,
                                               seeds=16, expand=2, mesh=mesh,
                                               stats=stats)

            _, ir = rs(stats)
            i1, ir = i1.cpu().numpy(), ir.cpu().numpy()
            ov = _overlap(ir, i1)
            check(ov >= 0.9, f"row-sharded {dtype or 'float32'} ef={ef}: id "
                  f"overlap {ov:.4f} >= 0.9 with the single-device "
                  f"pivot-seeded search (F2)")
            qps = _qps(rs, len(q_np))
            print(f"  row-sharded {dtype or 'float32'} rows ef={ef}: "
                  f"{qps:.1f} QPS (median of 3), recall@10 "
                  f"{_recall(ir, gt, 10):.4f} vs the exact tier, overlap "
                  f"{ov:.4f} with single-device (ids equal at "
                  f"{np.mean(ir == i1):.5f}), hops {stats['hops']}",
                  flush=True)
        del shards
    g.entry_mode = "descent"

    cfg = GraphConfig(m=16, ef_construction=100, metric="cosine", seed=0)
    pg = PartitionedGraph(mesh=mesh, config=cfg)
    t0 = time.perf_counter()
    pg.build(list(range(len(base))), base)
    t_build = time.perf_counter() - t0
    print(f"# partitioned-graph-100k: PartitionedGraph({S} partitions) over "
          f"phase 5's {len(base)} rows: build {t_build:.1f} s (sub-graphs "
          f"concurrently), sizes {pg.stats()['sizes']}", flush=True)
    for ef in (64, 192):
        (keys, d), t = _timed(lambda: pg.batch_search(q_np, 10, ef=ef))
        rec = _key_recall(keys, gt, 10)
        floor = 0.9 * graph["recall"][ef]
        check(np.isfinite(d).all() and rec >= floor,
              f"partitioned ef={ef}: recall@10 {rec:.4f} >= 0.9 x phase 5's "
              f"{graph['recall'][ef]:.4f}")
        print(f"  partitioned ef={ef}: recall@10 {rec:.4f} (phase 5's one "
              f"graph {graph['recall'][ef]:.4f}), {len(q_np) / t:.1f} QPS "
              f"(one batch)", flush=True)
    del pg
    _beam_read("phase 17 (query-sharded, row-sharded, partitioned graphs)",
               need5=("rows", "f16rows"))


def _p17_ivf(mesh, ivf_st: dict) -> None:
    """Phase 17.6: phase 11's block table sharded over the mesh."""
    from hnsw_tpu_torch.parallel.sharded import sharded_ivf_candidates
    idx, q_np = ivf_st["ivf"], ivf_st["queries"]
    truth_d, truth_i = ivf_st["truth"]
    S = mesh.shape["data"]
    blocks, block_sq, block_valid, block_slot, cents, part_blocks = \
        idx._sync()
    NB = blocks.shape[0]
    pad = -(-NB // S) * S - NB
    bpart = np.full(NB + pad, -1, np.int32)
    for p, bl in enumerate(part_blocks):
        bpart[bl] = p
    F = torch.nn.functional
    args = (F.pad(blocks, (0, 0, 0, 0, 0, pad)),
            F.pad(block_sq, (0, 0, 0, pad)), F.pad(block_valid, (0, 0, 0, pad)),
            torch.from_numpy(bpart).to(blocks.device))
    flat = np.pad(block_slot, ((0, pad), (0, 0)),
                  constant_values=-1).reshape(-1)
    q = torch.from_numpy(q_np).to(blocks.device)
    print(f"# sharded-ivf-1m-clustered: phase 11's [{NB}, {blocks.shape[1]}, "
          f"{DIM}] block table padded to {NB + pad} blocks over {S} shards, "
          f"{len(q_np)} queries, k=10", flush=True)

    def sharded(npb):
        return sharded_ivf_candidates(q, cents, *args, nprobe=npb, k=10,
                                      metric="cosine", mesh=mesh)

    for npb in (16, idx.P):
        (d, i), t = _timed(lambda: sharded(npb))
        d, i = d.cpu().numpy(), i.cpu().numpy()
        slots = np.where(i >= 0, flat[np.clip(i, 0, None)], -1)
        if npb == 16:
            idx.nprobe = 16
            keys, _ = idx.batch_search(q_np, 10)
            ref = np.array([[-1 if k_ is None else k_ for k_ in row]
                            for row in keys])
            ov = _overlap(slots, ref)
            check(ov >= 0.999, f"nprobe=16: id overlap {ov:.5f} >= 0.999 "
                  f"with IVFIndex.batch_search")
            note = (f"overlap {ov:.5f} with IVFIndex.batch_search, ids equal "
                    f"at {np.mean(slots == ref):.5f} of the positions")
        else:
            same = float(np.mean(slots == truth_i))
            rec_t = _recall_ties(d, truth_d, 1e-5)
            check(same == 1.0 or rec_t == 1.0,
                  f"nprobe={npb}: slots equal the exact tier's at {same:.5f} "
                  f"of the positions, tie-aware recall@10 {rec_t:.4f}")
            note = (f"slots equal the exact tier's at {same:.5f} of the "
                    f"positions (tie-aware recall@10 {rec_t:.4f})")
        print(f"  block-sharded IVF nprobe={npb}: {len(q_np) / t:.1f} QPS "
              f"(one batch), recall@10 {_recall(slots, truth_i, 10):.4f} vs "
              f"the exact tier; {note}", flush=True)
    del args


def _p17_multihost(ivf_st: dict) -> dict:
    """Phase 17.7: a 2-slice MultiHostIndex over TCP, each slice an
    ExactIndex on the card with half of phase 11's rows (K1 a slice).
    Returns K1's launches by route."""
    from hnsw_tpu_torch import ExactIndex
    from hnsw_tpu_torch.parallel.multihost import MultiHostIndex
    from hnsw_tpu_torch.parallel.rpc import SliceServer, SocketTransport
    base, q_np = ivf_st["base"], ivf_st["queries"]
    truth_d, truth_i = ivf_st["truth"]
    slices = [ExactIndex(metric="cosine", device=DEVICE) for _ in range(2)]
    for s in slices:
        s.host_serve_max_batch = 0
    servers = [SliceServer(s) for s in slices]
    tr = SocketTransport([s.start() for s in servers], request_timeout=300.0)
    mh = MultiHostIndex(tr, replicas=1)
    try:
        t0 = time.perf_counter()
        for c0 in range(0, len(base), 1 << 18):
            mh.batch_add(list(range(c0, min(len(base), c0 + (1 << 18)))),
                         base[c0:c0 + (1 << 18)])
        t_add = time.perf_counter() - t0
        sizes = mh.stats()["per_slice"]
        print(f"# multihost-tcp-1m: 2 SliceServers on 127.0.0.1, each an "
              f"ExactIndex on {DEVICE} with {sizes} of phase 11's {len(base)} "
              f"cosine rows; batch_add over TCP {t_add:.1f} s", flush=True)
        _reset_launches()
        (keys, d), t_first = _timed(lambda: mh.batch_search(q_np, 10))
        by = _launches()
        ids = np.array([[-1 if k_ is None else k_ for k_ in row]
                        for row in keys])
        rec = _recall(ids, truth_i, 10)
        rec_t = _recall_ties(d, truth_d, 1e-5)
        check(rec == 1.0 or rec_t == 1.0,
              f"multihost over TCP: recall@10 {rec:.4f} (tie-aware "
              f"{rec_t:.4f}) == 1.0 against one ExactIndex over all rows")
        if DEVICE == "cuda":
            check(by == {"wgmma": 2, "wgmma_cp": 0},
                  f"one batch launched K1 once a slice: {by}")
        _reset_launches()
        qps = _qps(lambda: mh.batch_search(q_np, 10), len(q_np))
        by = _add(by, _launches())
        print(f"  multihost: {qps:.1f} QPS (median of 3; the first batch "
              f"{t_first:.3f} s, the slices' device tables built in it), "
              f"recall@10 {rec:.4f}, K1 launches {by}", flush=True)
    finally:
        mh.close()
        tr.close()
        for s in servers:
            s.shutdown()
        for s in slices:
            s.close()
    return by


def phase_parallel(kept: dict, graph: dict, ivf_st: dict) -> dict:
    """Phase 17: the parallel package on default_mesh(8), eight shards on
    the one card. Returns K1's launches by route."""
    from hnsw_tpu_torch.parallel.dryrun import dryrun_multichip
    from hnsw_tpu_torch.parallel.sharded import default_mesh
    mesh = (default_mesh(8) if DEVICE == "cuda"
            else default_mesh(8, device=DEVICE))
    check(mesh.shape["data"] == 8 and mesh.one_device
          and mesh.devices[0].type == DEVICE,
          f"default_mesh(8): 8 shards on {mesh.devices[0]}")
    launches = _p17_exact(mesh, kept)
    _p17_graphs(mesh, graph)
    _p17_ivf(mesh, ivf_st)
    launches = _add(launches, _p17_multihost(ivf_st))
    print("# dryrun_multichip(8) of the port", flush=True)
    _reset_launches()
    t0 = time.perf_counter()
    rec = dryrun_multichip(8, device=None if DEVICE == "cuda" else DEVICE)
    launches = _add(launches, _launches())
    check(min(rec.values()) >= 0.9 and rec["multihost"] == 1.0,
          f"dryrun_multichip(8) passed its 8 checks in "
          f"{time.perf_counter() - t0:.1f} s: {rec}")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return launches


def _trace_holds(log_dir: str, name: str) -> tuple:
    """(kernel events, events named ``name``) in the Chrome trace(s)
    device_trace wrote into ``log_dir``."""
    import glob

    from hnsw_tpu_torch.utils.profiling import kernel_events
    kernels = named = 0
    for path in glob.glob(os.path.join(log_dir, "*.json")):
        kernels += kernel_events(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        named += sum(e.get("name") == name for e in events)
    return kernels, named


def phase_drivers(sweep_small: bool = False, **bench_sizes) -> dict:
    """Phase 18: the drivers a benchmark wraps. tools/bench at full size
    (its JSON line), every configuration of tools/sweep at full size with
    the --big ladder (K1 at 1M and 8M rows x 128, 8,192 queries), entry()
    against the same call on the CPU, and utils/profiling.device_trace
    around bench's exact batch. ``sweep_small`` and ``bench_sizes``
    (tools/bench.main's n_q, reps) shrink a rehearsal on the CPU.
    Returns K1's launches by route."""
    import tempfile

    from hnsw_tpu_torch.tools import bench, sweep
    from hnsw_tpu_torch.tools.entry import entry
    from hnsw_tpu_torch.utils.profiling import annotate, device_trace
    from hnsw_tpu_torch.utils.roofline import peak_flops
    cuda = DEVICE == "cuda"
    _reset_launches()
    print(f"# tools/bench: {N_BENCH} x {DIM} cosine {bench_sizes}",
          flush=True)
    t0 = time.perf_counter()
    _beam_reset()
    rec = bench.main([] if cuda else ["--device", "cpu"], n=N_BENCH,
                     **bench_sizes)
    _beam_read("phase 18, tools/bench (its graph rows)", need5=("blocks",))
    check(rec["recall"] == 1.0 and rec["exact_fast_recall"] >= 0.999,
          f"bench ({time.perf_counter() - t0:.1f} s): exact recall@10 "
          f"{rec['recall']} == 1.0, fast_math {rec['exact_fast_recall']} "
          f">= 0.999")

    print(f"# tools/sweep: configs 1-8 (--big){' --small' * sweep_small}",
          flush=True)
    t0 = time.perf_counter()
    sw = sweep.Sweep(small=sweep_small, device=DEVICE, big=True)
    rows = []
    for r in sw.rows():
        sweep.emit(r)
        rows.append(r)
    print(f"  {len(rows)} rows in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ladder = {(r["config"], r["strategy"]): r for r in rows
              if r["config"].startswith("exact_roofline_")}
    # the ladder's f32 rows are held to the plain scan with its ties
    # (sweep.plain_agreement) instead: over 8,192 queries a 10th/11th
    # rank within f32 rounding is expected, and either row is exact
    exact = [r for r in rows if r.get("strategy") in ("exact", "exact_fast")
             and (r["config"], r["strategy"]) not in ladder]
    check(all(r["recall@10"] >= (0.999 if r["strategy"] == "exact_fast"
                                 else 1.0) for r in exact),
          f"{len(exact)} exact rows: recall@10 1.0 (fast_math >= 0.999)")
    if not sweep_small:
        want = {("exact_roofline_1m", "exact"),
                ("exact_roofline_1m", "exact_fast"),
                ("exact_roofline_8m", "exact_fast")}
        check(set(ladder) == want and all(
            "mfu" in r and "floor_frac" in r for r in ladder.values()),
            f"the ladder's rows {sorted(ladder)} each carry mfu and "
            f"floor_frac")
        f32 = [(r["n"], r["ids_equal_plain"], r["ids_differ"])
               for r in ladder.values() if r["strategy"] == "exact"] + [
            (r["n"], r["f32_ids_equal_plain"], r["f32_ids_differ"])
            for r in ladder.values() if "f32_ids_equal_plain" in r]
        check(len(f32) == 2 and all(ok for _, ok, _ in f32),
              f"K1's f32 scan at 1M and 8M rows, all 8,192 queries: ids "
              f"equal to the plain scan's (ops/topk.exact_topk) but for "
              f"f32 ties, (rows, ok, ids at a tie) {f32}")
        check(all(r["recall@10"] >= 0.999 for r in ladder.values()),
              "every ladder row, all 8,192 queries: recall@10 >= 0.999 "
              "against the plain scan: "
              + ", ".join(f"{c} {s} {r['recall@10']}"
                          for (c, s), r in sorted(ladder.items())))
    peak = peak_flops()
    for r in rows:
        if "achieved_tflops" in r:
            check(r.get("mfu", 0.0) <= 1.0 and (
                peak is None or r["achieved_tflops"] <= peak / 1e12),
                f"{r['config']} {r['strategy']}: mfu {r.get('mfu')} <= 1, "
                f"{r['achieved_tflops']} TFLOP/s <= the card's peak")

    fn, args = entry(device=None if cuda else DEVICE)
    _, ids = fn(*args)
    fn_c, args_c = entry(device="cpu")
    _, ids_c = fn_c(*args_c)
    ov = _overlap(ids.cpu().numpy(), ids_c.numpy())
    check(ov >= 0.99, f"entry() on {DEVICE}: ids overlap {ov:.4f} >= 0.99 "
          f"with the CPU's")

    # bench's exact batch (bench.exact_ids) on the sweep's 10k graph and
    # queries, traced in this process
    batch = annotate("bench_exact_batch")(bench.exact_ids)
    dev = sw.graph().device_graph()
    q = torch.from_numpy(sw.queries).to(dev.vectors.device)
    with tempfile.TemporaryDirectory() as td:
        with device_trace(td):
            batch(dev, q)
        kernels, named = _trace_holds(td, "bench_exact_batch")
    check(named > 0 and (kernels > 0 or not cuda),
          f"device_trace around one bench exact batch ({len(q)} queries "
          f"over {dev.vectors.shape[0]} slots): {kernels} CUDA kernel "
          f"events, {named} event(s) named bench_exact_batch")
    by = _launches()
    if cuda:
        check(by["wgmma"] > 0, f"phase 18 launched K1: {by}")
    return by


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
    beam = phase_beam_kernel(graph, smi)
    graph_k = phase_graph_kernel(graph, smi)
    by, kept = phase_capacity_ladder()
    launches = _add(launches, by)
    launches = _add(launches, phase_auto_ladder())
    phase_graph_modes(graph)
    select = phase_select_kernel(smi)
    launches = _add(launches, phase_device_builds(graph))
    launches = _add(launches, phase_sift_shape_build())
    print(f"# smoke: phases 1-10 took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    by, ivf_st = phase_ivf_clustered()
    launches = _add(launches, by)
    launches = _add(launches, phase_adaptive(graph["base"]))
    phase_hybrid_bench()
    t_new = time.perf_counter()
    launches = _add(launches, phase_streaming(kept))
    launches = _add(launches, phase_disk_graph(graph))
    launches = _add(launches, phase_facets(graph))
    print(f"# smoke: phases 14-16 took {time.perf_counter() - t_new:.1f} s",
          flush=True)
    t_new = time.perf_counter()
    launches = _add(launches, phase_parallel(kept, graph, ivf_st))
    del kept, graph, ivf_st
    print(f"# smoke: phase 17 took {time.perf_counter() - t_new:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    launches = _add(launches, phase_drivers())
    print(f"# smoke: phase 18 took {time.perf_counter() - t_new:.1f} s",
          flush=True)
    check(all(launches[r] > 0 for r in ("wgmma", "wgmma_cp"))
          and all(BEAM_LAUNCHES[m] > 0 for m in ("rows", "blocks",
                                                  "f16rows"))
          and all(n > 0 for n in GRAPH_LAUNCHES.values())
          and all(n > 0 for n in CAPACITY_LAUNCHES.values())
          and CAPACITY_ROUTE_LAUNCHES["bf16_ws"] > 0
          and CAPACITY_ROUTE_LAUNCHES["wgmma"] > 0
          and SELECT_LAUNCHES["diverse_select"] > 0,
          f"the main path launched every K1 route: {launches}, K2 in "
          f"each of the builder's modes: {BEAM_LAUNCHES}, K5 in every "
          f"mode: {GRAPH_LAUNCHES}, the capacity screen on every "
          f"store: {CAPACITY_LAUNCHES} and both its kernels: "
          f"{CAPACITY_ROUTE_LAUNCHES}, and K4: {SELECT_LAUNCHES}")
    print(f"# smoke: {time.perf_counter() - t_start:.1f} s, the kernels' "
          f"build included", flush=True)
    print(smi)
    print(json.dumps({"kernels": [dict(timing[r], launches=launches[r])
                                  for r in ("wgmma", "wgmma_cp")] + [
        dict(beam, launches=sum(BEAM_LAUNCHES.values()),
             launches_by_mode=dict(BEAM_LAUNCHES)),
        dict(graph_k, launches=sum(GRAPH_LAUNCHES.values()),
             launches_by_mode=dict(GRAPH_LAUNCHES)),
        dict(timing["capacity"],
             launches=(CAPACITY_ROUTE_LAUNCHES["wgmma"]
                       + CAPACITY_ROUTE_LAUNCHES["wgmma_ld"]),
             launches_by_store=dict(CAPACITY_LAUNCHES),
             launches_by_route=dict(CAPACITY_ROUTE_LAUNCHES)),
        dict(timing["capacity_ws"],
             launches=CAPACITY_ROUTE_LAUNCHES["bf16_ws"]),
        dict(select, launches=SELECT_LAUNCHES["diverse_select"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
