"""Roofline accounting for the exact-scan tiers (port of
hnsw_tpu/utils/roofline.py).

Two ratio fields for an exact-scan row:

  * ``mfu``        achieved FLOP/s over the card's dense bf16 peak (the
    absolute roofline), read from ``PEAKS`` by the card's name
    (``torch.cuda.get_device_name()``) or from HNSW_TPU_PEAK_FLOPS.
    Emitted only for ``platform == "gpu"`` on a card whose peak is known.
    Every row, f32 included, is measured against the one bf16 peak
    (equal footing: an f32 row's TF32 passes or full-f32 products are
    work the configuration chose, not a different roofline).
  * ``floor_frac`` the bare Gram product's time over the row's time, on
    this run's card and shapes (the relative roofline: 1 - floor_frac is
    what selection and rerank add). Not clipped: K1's 3xTF32 screen may
    beat the bare full-f32 product, and a value above 1 is reported as
    it is.

``screen_bound_s`` is the least time of one exact screen on the card, for
a float32 table (K1's work) or a capacity table (int8, bf16, fp16: the
capacity screen's), the bound ``chip_smoke.py`` and
``tools/screen_split.py`` put beside the kernel's times; ``hop_bound_s``
is K2's (one layer of beam search) and ``select_bound_s`` K4's (one call
of the wave builder's neighbour selection).
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Optional, Sequence, Tuple

import torch

# pins full-f32 GEMMs (TF32 off) for the floor's f32 product
import hnsw_tpu_torch.ops.distance  # noqa: F401

#: the card whose data-sheet peaks ``screen_bound_s`` uses
H100_SXM = "NVIDIA H100 80GB HBM3"

#: dense peaks by card name (NVIDIA's data sheet, no sparsity, at the
#: full power limit): FLOP/s for bf16 and TF32 tensor-core products, int8
#: tensor-core OP/s, float32 FLOP/s outside the tensor cores, and HBM
#: bytes/s
PEAKS = {H100_SXM: {"bf16": 989.4e12, "tf32": 494.7e12, "int8": 1979e12,
                    "fp32": 66.9e12, "hbm_bytes_s": 3.35e12}}

#: an exact screen's cheapest product on the card, by fast_math: (passes,
#: peak key, name). An f32-accurate product takes at least three TF32
#: passes (3xTF32); fast_math's bf16 operands one pass at the bf16 rate.
SCREEN_PRODUCT = {False: (3, "tf32", "3xTF32"), True: (1, "bf16", "bf16")}
#: the capacity screen's cheapest product, by the table's store: int8
#: values are exact in bf16, so int8 and bf16 rows against a bf16-rounded
#: query take one bf16 pass; fp16 rows against the f32 query, at f32
#: fidelity, two TF32 passes (the query split hi + lo, the fp16 values
#: exact in TF32)
CAPACITY_PRODUCT = {"int8": (1, "bf16", "bf16"), "bf16": (1, "bf16", "bf16"),
                    "fp16": (2, "tf32", "2xTF32")}
#: bytes of one table value, by store
STORE_BYTES = {"float32": 4, "int8": 1, "bf16": 2, "fp16": 2}


def peak_flops(device_name: Optional[str] = None) -> Optional[float]:
    """The dense bf16 peak the ``mfu`` field divides by: the
    HNSW_TPU_PEAK_FLOPS override, else ``PEAKS`` for ``device_name`` (by
    default the current CUDA card's); None for an unknown card or no
    card."""
    env = os.environ.get("HNSW_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name()
    peaks = PEAKS.get(device_name)
    return peaks["bf16"] if peaks else None


def scan_flops(n_q: int, n: int, d: int) -> float:
    """FLOPs of one exact Gram scan: the [n_q, d] x [d, n] matmul."""
    return 2.0 * n_q * n * d


def screen_bound_s(nq: int, n: int, d: int, k_sel: int,
                   fast_math: bool = False, store: str = "float32"
                   ) -> Tuple[float, str, float]:
    """(seconds, "bytes" | "operations", peak FLOP/s): the least time on
    the H100 SXM (``PEAKS[H100_SXM]``) of one exact screen of ``nq``
    queries over an [n, d] table of ``store`` ("float32", or a capacity
    table: "int8", "bf16", "fp16") for ``k_sel`` winners each: the larger
    of the bytes it must move (queries, the table at ``STORE_BYTES`` a
    value, norms, validity and int8's f32 scales read once, int64 keys
    written once) over the HBM rate, and 2 nq n d flops a product pass
    (``SCREEN_PRODUCT`` by ``fast_math`` for float32, ``CAPACITY_PRODUCT``
    by store) over the tensor cores' peak for that pass's type, which is
    the third value."""
    peaks = PEAKS[H100_SXM]
    if store == "float32":
        passes, kind, _ = SCREEN_PRODUCT[fast_math]
    else:
        passes, kind, _ = CAPACITY_PRODUCT[store]
    moved = (4 * nq * d + STORE_BYTES[store] * n * d + 4 * n + n
             + (4 * n if store == "int8" else 0) + 8 * nq * k_sel)
    t_bytes = moved / peaks["hbm_bytes_s"]
    t_ops = passes * scan_flops(nq, n, d) / peaks[kind]
    if t_ops >= t_bytes:
        return t_ops, "operations", peaks[kind]
    return t_bytes, "bytes", peaks[kind]


def hop_bound_s(n_queries: int, d: int, pool: int, starts: int, width: int,
                nodes: int, rows: int, scored: int, row_bytes: int,
                kind: str) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time on the H100 SXM of
    one layer of graph beam search (the K2 kernel, ops/beam_search) for
    ``n_queries`` queries that read the ``width`` neighbour ids of
    ``nodes`` distinct nodes, ``row_bytes`` of each of ``rows`` distinct
    rows, and scored ``scored`` candidates in all. It is the larger of the
    bytes it must move over the HBM rate (each query row, its squared norm
    and its ``starts`` start ids and distances read once, each distinct
    node's ids and each distinct row once, the [n_queries, pool] distances
    and ids written once) and 2 d operations a scored candidate over the
    peak for ``kind``, the operands' type ("fp32", "bf16" or "int8").
    With ``nodes`` and ``rows`` the totals over the queries (a row read
    again for every query that scores it) it is the bound without reuse
    across queries."""
    peaks = PEAKS[H100_SXM]
    moved = (n_queries * (4 * d + 4 + 8 * starts + 8 * pool + 12)
             + 4 * width * nodes + row_bytes * rows)
    t_bytes = moved / peaks["hbm_bytes_s"]
    t_ops = 2.0 * d * scored / peaks[kind]
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def search_bound_s(n_queries: int, d: int, k: int, starts: int,
                   layers: Sequence[Tuple[int, int, int, int, int, str]],
                   rerank_rows: int = 0, rerank_row_bytes: int = 0,
                   rerank_scored: int = 0) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time on the H100 SXM of
    a whole graph search (the K5 kernel, ops/graph_search) for
    ``n_queries`` queries. ``layers`` holds, for each layer searched,
    (width, nodes, rows, scored, row_bytes, kind) as ``hop_bound_s`` takes
    them: the neighbour ids of ``nodes`` distinct nodes, ``row_bytes`` of
    each of ``rows`` distinct rows, ``scored`` candidates scored with
    operands of type ``kind``. The rerank reads ``rerank_row_bytes`` of
    each of ``rerank_rows`` distinct rows and scores ``rerank_scored``
    candidates at fp32. It is the larger of the bytes the launch must move
    over the HBM rate (each query row and squared norm and its ``starts``
    entry ids once, each layer's distinct node ids and rows once, the
    rerank's rows once, the [n_queries, k] distances and ids and one hop
    count a layer and query written once; the pools between layers never
    leave the chip) and the operations (2 d a scored candidate) over the
    peaks of their types, summed over the layers. At or below the sum of
    ``hop_bound_s`` over the same layers, which writes every layer's
    pool."""
    peaks = PEAKS[H100_SXM]
    moved = (n_queries * (4 * d + 4 + 4 * starts + 8 * k + 4 * len(layers))
             + rerank_row_bytes * rerank_rows)
    t_ops = 2.0 * d * rerank_scored / peaks["fp32"]
    for width, nodes, rows, scored, row_bytes, kind in layers:
        moved += 4 * width * nodes + row_bytes * rows
        t_ops += 2.0 * d * scored / peaks[kind]
    t_bytes = moved / peaks["hbm_bytes_s"]
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def select_bound_s(P: int, C: int, D: int, deg: int, *,
                   rows: Optional[int] = None, pairs: Optional[int] = None,
                   diversify: bool = True,
                   store_bytes: int = 4) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time on the H100 SXM of
    one call of the wave builder's neighbour selection (the K4 kernel,
    ops/diverse_select) over ``P`` rows of ``C`` candidates, ``D`` wide,
    keeping min(C, deg) a row. It is the larger of the bytes it must move
    over the HBM rate (the [P, C] ids and distances read once, ``rows``
    candidate rows of ``store_bytes`` an element (4 float32, 2 float16 or
    bfloat16) and a squared norm each, the [P, min(C, deg)]
    ids written once) and 2 D operations a candidate pair of the Gram over
    the bf16 tensor peak (DEFAULT rounds the operands to bf16). ``pairs``
    defaults to every pair e < j of every row, P C (C - 1) / 2, and
    ``rows`` to P C: every row read again for each candidate slot it
    fills, the bound without reuse across rows; the distinct rows and the
    valid candidates' pairs of a call give the bound of its data. Without
    ``diversify`` no row is read and no pair scored."""
    peaks = PEAKS[H100_SXM]
    if rows is None:
        rows = P * C
    if pairs is None:
        pairs = P * C * (C - 1) // 2
    if not diversify:
        rows = pairs = 0
    moved = (8 * P * C + (store_bytes * D + 4) * rows
             + 4 * P * min(C, deg))
    t_bytes = moved / peaks["hbm_bytes_s"]
    t_ops = 2.0 * D * pairs / peaks["bf16"]
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def matmul_floor_dt(queries: torch.Tensor, vectors: torch.Tensor, *,
                    fast_math: bool, reps: int = 5,
                    chunk: int = 65536) -> float:
    """Median seconds of the BARE Gram product on the tensors' device:
    the scan-only ceiling every epilogue and selection rides on. The
    precision follows the measured configuration: fast_math = bf16
    operands (the GEMM accumulates in f32), else full f32 (the port's
    HIGHEST: TF32 off, ``ops/distance``).

    Chunked over ``chunk`` rows with a [Q] max per chunk: the whole
    [Q, N] Gram is 32 GB at Q=8192, N=1M, and the floor must be
    measurable at the Ns where it matters. Synchronises a CUDA device
    before each clock read."""
    cuda = queries.is_cuda
    if fast_math:   # cast once, outside the timed product
        queries = queries.to(torch.bfloat16)
        vectors = vectors.to(torch.bfloat16)
    starts = range(0, vectors.shape[0], chunk)

    def run():
        for c in starts:
            torch.matmul(queries, vectors[c:c + chunk].T).amax(dim=1)
        if cuda:
            torch.cuda.synchronize(queries.device)

    run()  # warm: cuBLAS handles, both chunk shapes (full + ragged tail)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return statistics.median_high(times)


def roofline_fields(*, n_q: int, n: int, d: int, dt: float,
                    floor_dt: Optional[float] = None,
                    platform: str = "gpu",
                    device_name: Optional[str] = None) -> dict:
    """The ratio fields for a measured exact-scan row (``dt`` seconds for
    one batch of ``n_q`` queries over ``n`` rows). ``mfu`` appears only
    for ``platform == "gpu"`` when the card's peak is known
    (``peak_flops(device_name)``)."""
    fl = scan_flops(n_q, n, d)
    out = {"achieved_tflops": round(fl / dt / 1e12, 2)}
    peak = peak_flops(device_name) if platform == "gpu" else None
    if peak:
        out["mfu"] = round(fl / dt / peak, 4)
    if floor_dt is not None and dt > 0:
        out["floor_frac"] = round(floor_dt / dt, 3)
    return out
