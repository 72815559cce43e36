"""The wave builder's neighbour selection: the hand-written CUDA kernel (K4).

The kernel (``csrc/diverse_select.cu``) runs one call of
``core/build._diverse_select_dev`` as one launch, one block a row: the
stable sort and dedup of the row's candidates, each candidate's row
gathered once into shared memory as bf16, the lower triangle of their Gram
on the tensor cores (``mma.sync``) turned into conflict bits in registers,
Malkov's diversity scan, the backfill to ``deg`` and the compaction. Its
plain twin is ``core/build._diverse_select_reference``, which returns the
same rows (the kernel's f32 Gram sums run in another order). Where a row's
candidates do not fit the block whole, D is staged in slabs (``layout``)
and the launch takes a workspace the wrapper allocates.

Which calls take the kernel is decided here, in ``select_kernel_applies``:
CUDA tensors on one device, at most ``SELECT_MAX_C`` candidates a row and,
with ``diversify``, a built-in metric and a float32, float16 or bfloat16
row store. Every other call (a CPU tensor, a registered custom metric)
runs the twin; on CUDA each such call is counted in ``plain_on_cuda``, by
reason, so a caller can see that a covered call never reached the twin.

The library is compiled with nvcc at first use into ``build/hnsw_tpu_torch``
beside the package (rebuilt when the source is newer) and bound with
ctypes; nothing is built when this module is imported. A build or launch
that fails raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import torch

from hnsw_tpu_torch.ops.exact_screen import BUILD_DIR, _nvcc

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "diverse_select.cu")
_METRIC_CODE = {"cosine": 0, "l2": 1, "sqeuclidean": 2, "dot": 3}
#: the row stores the kernel reads (csrc/diverse_select.cu ST_*)
STORES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

#: most candidates a row the kernel takes (its scan keeps one 32-bit kept
#: mask a lane of one warp)
SELECT_MAX_C = 1024
#: csrc/diverse_select.cu: bytes of staged rows a block, dynamic shared
#: memory a block can have
ROW_BUDGET, SMEM_MAX = 96 * 1024, 232_448

#: kernel launches so far (one per call on CUDA), in all and by how the
#: rows were staged: "whole" (every candidate's row in shared memory at
#: once, or no row: a call without diversify) or "slabs" (D staged in
#: slabs, the accumulators in the workspace between them)
launches = 0
launches_by_layout = {"whole": 0, "slabs": 0}
#: calls on CUDA tensors that ran the twin, by reason: "mode" (a registered
#: metric or a row store the kernel lacks), "size" (more than SELECT_MAX_C
#: candidates a row) or "other" (a covered call within its limits: tensors
#: on different devices, or the twin forced)
plain_on_cuda = {"mode": 0, "size": 0, "other": 0}

_lock = threading.Lock()
_lib = None


def build(defines=(), build_dir: Optional[str] = None,
          source: Optional[str] = None) -> str:
    """Compile ``csrc/diverse_select.cu`` (or ``source``) into ``build_dir``
    (default ``BUILD_DIR``) if the library is missing or older than the
    source; returns its path. ``defines``: macros passed as ``-D``
    (``SELECT_PHASE_CLOCKS`` for ``tools/select_split.py``; the port
    defines none). ptxas's report goes to ``diverse_select.ptxas.txt``
    beside the library."""
    build_dir = build_dir or BUILD_DIR
    source = source or SOURCE
    so = os.path.join(build_dir, "libdiverse_select.so")
    if (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(source)):
        return so
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", *(f"-D{m}" for m in defines), source,
           "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    with open(os.path.join(build_dir, "diverse_select.ptxas.txt"), "w") as f:
        f.write(res.stderr)
    os.replace(tmp, so)
    return so


def bind(path: str):
    """The library at ``path`` loaded with ctypes, its entry points
    typed."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.diverse_select_launch.argtypes = [vp] * 4 + [ci] * 9 + [vp] * 3
    lib.diverse_select_launch.restype = ci
    lib.diverse_select_smem_bytes.argtypes = [ci] * 3
    lib.diverse_select_smem_bytes.restype = ci
    lib.diverse_select_blocks_per_sm.argtypes = [ci] * 3
    lib.diverse_select_blocks_per_sm.restype = ci
    lib.diverse_select_workspace_bytes.argtypes = [ci] * 4
    lib.diverse_select_workspace_bytes.restype = ctypes.c_longlong
    lib.workspace_sizes = {}     # workspace_bytes: (device, P, C, D, store)
    return lib


def workspace_bytes(lib, device: int, P: int, C: int, D: int,
                    store: int) -> int:
    """Bytes of global workspace a diversifying launch of ``lib`` needs
    (its ``diverse_select_workspace_bytes``: 0 where the rows are staged
    whole), asked of the library once for each (device, P, C, D, store):
    the builder repeats a few shapes, and the question queries the device
    where D is staged in slabs."""
    key = (device, P, C, D, store)
    n = lib.workspace_sizes.get(key)
    if n is None:
        n = lib.workspace_sizes[key] = int(
            lib.diverse_select_workspace_bytes(P, C, D, store))
    return n


def bit_words(C: int) -> int:
    """Words of the kernel's triangle of conflict bits over C candidates
    (row j holds words 0 .. j // 32): sum over j < C of j // 32 + 1."""
    q, r = divmod(C, 32)
    return 32 * (q * (q + 1) // 2) + r * (q + 1)


def unit_count(R: int) -> int:
    """The kernel's (m-tile, word) units over R m-tiles of 16 candidates:
    m-tile r pairs with the 32-candidate words 0 .. r // 2."""
    return sum(r // 2 + 1 for r in range(R))


def layout(C: int, D: int, row_budget: int = ROW_BUDGET) -> dict:
    """The kernel's shared layout at C candidates a row, D wide (the
    source's ``layout()``): C and D padded to multiples of 16 (D at least
    16); three [C] arrays (each padded to a multiple of 4) and, at
    ``bits``, the triangle of conflict bits; then, 128-byte aligned at
    ``rows``, the staged rows, ``pitch`` = slab + 8 bf16 a row, where the
    rank first reads the input ids and distances (``plain``: the bytes of
    a launch without diversify, which stages no row). The rows are whole
    (one slab of D_pad) where C_pad x pitch x 2 bytes fit ``row_budget``
    (the library's, ``ROW_BUDGET`` unless it was built with another
    ``DIVERSE_SELECT_ROW_BUDGET``) and ``SMEM_MAX`` beside the arrays, else
    in slabs of the widest multiple of 16 columns that fit. ``total`` is
    -1 where not even 16 columns fit."""
    c_pad = -(-C // 16) * 16
    d_pad = max(16, -(-D // 16) * 16)
    cq = -(-C // 4) * 4
    bits = 12 * cq
    rows = -(-(bits + 4 * bit_words(C)) // 128) * 128
    budget = min(row_budget, SMEM_MAX - rows)
    if c_pad * (d_pad + 8) * 2 <= budget:
        slab = d_pad
    else:
        slab = (budget // (2 * c_pad) - 8) // 16 * 16
    out = dict(c_pad=c_pad, d_pad=d_pad, bits=bits, rows=rows,
               plain=rows + 8 * cq, units=unit_count(c_pad // 16))
    if slab < 16:
        return dict(out, slab=0, n_slabs=0, pitch=0, total=-1)
    return dict(out, slab=slab, n_slabs=-(-d_pad // slab), pitch=slab + 8,
                total=rows + c_pad * (slab + 8) * 2)


def smem_bytes(C: int, D: int, store: int) -> int:
    """Dynamic shared memory of one block (the library's
    ``diverse_select_smem_bytes``): ``layout(C, D)["total"]``, or -1 for
    arguments the kernel does not take (C outside 1 .. SELECT_MAX_C, D < 0,
    an unknown store code)."""
    if not 1 <= C <= SELECT_MAX_C or D < 0 or store not in STORES.values():
        return -1
    return layout(C, D)["total"]


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def _covered(vectors: torch.Tensor, metric: str, diversify: bool) -> bool:
    """Whether the kernel computes this call at some size: any call
    without ``diversify``, else a built-in metric over a row store it
    reads."""
    return not diversify or (metric in _METRIC_CODE
                             and vectors.dtype in STORES)


def _fits(cand_i: torch.Tensor) -> bool:
    return cand_i.ndim == 2 and 1 <= cand_i.shape[1] <= SELECT_MAX_C


def select_kernel_applies(cand_i: torch.Tensor, cand_d: torch.Tensor,
                          vectors: torch.Tensor, sq: torch.Tensor, *,
                          metric: str, diversify: bool) -> bool:
    """Whether ``core/build._diverse_select_dev`` runs this call through
    the kernel: CUDA tensors on one device, a covered call (``_covered``)
    of at most ``SELECT_MAX_C`` candidates a row. The one place that
    decides; every other call runs ``_diverse_select_reference``."""
    dev = cand_i.device
    return (cand_i.is_cuda
            and all(t.device == dev for t in (cand_d, vectors, sq))
            and _covered(vectors, metric, diversify) and _fits(cand_i))


def count_plain(cand_i: torch.Tensor, vectors: torch.Tensor, *, metric: str,
                diversify: bool) -> str:
    """Counts one call that ran the twin on CUDA in ``plain_on_cuda``, by
    reason: "mode" where the kernel lacks the metric or the row store,
    "size" past ``SELECT_MAX_C``, else "other" (tensors on different
    devices, the twin forced). Returns the reason."""
    if not _covered(vectors, metric, diversify):
        reason = "mode"
    elif not _fits(cand_i):
        reason = "size"
    else:
        reason = "other"
    with _lock:
        plain_on_cuda[reason] += 1
    return reason


def diverse_select_cuda(cand_i: torch.Tensor, cand_d: torch.Tensor,
                        vectors: torch.Tensor, sq: torch.Tensor, *, deg: int,
                        metric: str, diversify: bool) -> torch.Tensor:
    """One launch of the kernel: rows [P, min(C, deg)] int32, -1 padded,
    as the twin returns them. Raises on what the kernel does not take."""
    global launches
    if not select_kernel_applies(cand_i, cand_d, vectors, sq, metric=metric,
                                 diversify=diversify):
        raise ValueError(f"the selection kernel does not take this call "
                         f"({metric}, diversify={diversify}, candidates "
                         f"{tuple(cand_i.shape)} on {cand_i.device}, store "
                         f"{vectors.dtype} on {vectors.device})")
    P, C = cand_i.shape
    N, D = vectors.shape
    if (cand_d.shape != (P, C) or sq.ndim != 1 or sq.shape[0] < N or N < 1
            or deg < 1):
        raise ValueError(f"candidates {tuple(cand_i.shape)} / "
                         f"{tuple(cand_d.shape)}, store {tuple(vectors.shape)}"
                         f", norms {tuple(sq.shape)}, deg {deg}: shapes the "
                         f"kernel does not take")
    dev = cand_i.device
    cand_i = cand_i.to(torch.int32).contiguous()
    cand_d = cand_d.to(torch.float32).contiguous()
    vectors = vectors.contiguous()
    sq = sq.to(torch.float32).contiguous()
    out_w = min(C, deg)
    out = torch.empty((P, out_w), dtype=torch.int32, device=dev)
    if P == 0:
        return out
    lib = _load()
    store = STORES.get(vectors.dtype, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        n = workspace_bytes(lib, dev.index, P, C, D, store) if (
            diversify) else 0
        if n < 0:
            raise RuntimeError(f"diverse_select workspace for P={P}, C={C}, "
                               f"D={D}: error {n}")
        # D in slabs: the units' accumulators between slabs
        ws = torch.empty(n, dtype=torch.uint8, device=dev) if n else None
        rc = lib.diverse_select_launch(
            cand_i.data_ptr(), cand_d.data_ptr(), vectors.data_ptr(),
            sq.data_ptr(), P, C, N, D, deg, out_w,
            _METRIC_CODE.get(metric, 0), store, int(bool(diversify)),
            out.data_ptr(), None if ws is None else ws.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"diverse_select launch failed: cudaError {rc}")
    with _lock:                  # slices on one card launch from threads
        launches += 1
        launches_by_layout["slabs" if n else "whole"] += 1
    return out
