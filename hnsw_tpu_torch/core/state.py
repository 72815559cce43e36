"""Device-resident graph state (port of hnsw_tpu/core/state.py).

One fixed-shape array representation of the HNSW graph, held as torch
tensors on the serving device:

    vectors   f32[cap, D]      raw vectors (row = dense slot id); fp16 or
                               bf16 in the reduced stores, a [1, D]
                               placeholder in the int8 capacity mode
    sq_norms  f32[cap]         cached squared norms (distance epilogues)
    neighbors i32[L, cap, M]   per-layer fixed-degree adjacency, -1 = empty
                               (only layer 0 when the uppers are split)
    levels    i32[cap]         node's max layer, -1 = free slot
    alive     bool[cap]        tombstones
    entry     i32 scalar       entry slot (a node on the top layer)

and the optional serving layouts: the int8 traversal store (``qvec``,
``qscale``), layer-0 neighbor-vector blocks (``nbr_blocks``,
``block_scale``) and split or compact upper layers (``nbr_upper``,
``upper_map``). Keys never reach the device (utils/keystore.SlotMap
holds them). Host arrays are quantised with numpy exactly as the JAX
package does, so the int8 tables are bit-equal to its.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """float32 / float16 / bfloat16 as a torch dtype, from a torch dtype, a
    numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported store dtype {dtype!r}") from None


class DeviceGraph(NamedTuple):
    vectors: torch.Tensor    # [cap, D] float32 (fp16/bf16 store, [1, D])
    sq_norms: torch.Tensor   # [cap] float32
    neighbors: torch.Tensor  # [L, cap, M] int32, -1 padded
    levels: torch.Tensor     # [cap] int32, -1 = unused
    alive: torch.Tensor      # [cap] bool
    entry: torch.Tensor      # [] int32
    #: optional int8 traversal store: hop scoring gathers these in the
    #: capacity mode; qscale is the per-row dequant factor (absmax/127),
    #: folded into the Gram epilogue, not the gather.
    qvec: Optional[torch.Tensor] = None     # [cap, D] int8
    qscale: Optional[torch.Tensor] = None   # [cap] float32
    #: optional contiguous neighbor-vector blocks for layer 0: a hop
    #: gathers ONE [M0, D] block per expanded node instead of M0 rows.
    #: int8 blocks share the global dequant factor block_scale (1.0 for
    #: fp16 blocks).
    nbr_blocks: Optional[torch.Tensor] = None   # [cap, M0, D] int8/fp16
    block_scale: Optional[torch.Tensor] = None  # [] float32
    #: optional split upper-layer storage: ``neighbors`` then holds only
    #: layer 0 and this holds layers 1..L-1 at the upper degree m, either
    #: as a dense [L-1, cap, m] tensor (rows by slot) or as a COMPACT
    #: tuple of [U_l, m] tensors (rows by ``upper_map[slot]``; upper ids
    #: are assigned by descending level, so layer l's nodes occupy a
    #: prefix of every table and each layer stores only its occupancy).
    nbr_upper: Optional[Union[torch.Tensor, tuple]] = None
    #: slot -> compact upper row (int32 [cap], -1 = no upper layers). Set
    #: iff nbr_upper is the compact tuple.
    upper_map: Optional[torch.Tensor] = None

    @property
    def cap(self) -> int:
        # from neighbors, not vectors: in the int8 capacity mode
        # ``vectors`` is a [1, D] placeholder
        return self.neighbors.shape[1]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def num_layers(self) -> int:
        if self.nbr_upper is not None:
            return self.neighbors.shape[0] + len(self.nbr_upper)
        return self.neighbors.shape[0]

    @property
    def m(self) -> int:
        return self.neighbors.shape[2]

    def layer_neighbors(self, layer: int) -> torch.Tensor:
        """[cap, width] adjacency of one layer. Not defined for compact
        upper layers — use gather_neighbors."""
        if self.nbr_upper is not None and layer > 0:
            if self.upper_map is not None:
                raise ValueError(
                    "compact upper storage has no [cap, m] table; "
                    "gather rows via gather_neighbors()")
            return self.nbr_upper[layer - 1]
        return self.neighbors[layer]

    def layer_width(self, layer: int) -> int:
        """Edge width of one layer's rows."""
        if self.nbr_upper is not None and layer > 0:
            return self.nbr_upper[layer - 1].shape[-1]
        return self.neighbors.shape[2]

    def gather_neighbors(self, layer: int, ids: torch.Tensor
                         ) -> torch.Tensor:
        """Neighbor rows of ``ids`` (any shape of in-range slot ids) at one
        layer -> [..., width] int32, -1 padded; hides which upper layout
        (dense by slot, compact by upper_map rank) is active."""
        if self.nbr_upper is not None and layer > 0:
            tab = self.nbr_upper[layer - 1]
            if self.upper_map is not None:
                u = self.upper_map[ids].long()
                rows = tab[torch.clamp(u, 0, tab.shape[0] - 1)]
                return torch.where((u >= 0)[..., None], rows, -1)
            return tab[ids]
        return self.neighbors[layer][ids]


def bucket_pow2(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def quantize_rows(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization.

    Returns (q int8[N, D], scale f32[N]) with scale = absmax/127 so that
    ``q * scale`` reconstructs the row. Zero rows get scale 0.
    """
    v = np.asarray(vectors, np.float32)
    absmax = np.max(np.abs(v), axis=-1)
    scale = absmax / 127.0
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    q = np.clip(np.rint(v * inv[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _int8_block_fit(vectors: np.ndarray, metric: str = "cosine",
                    probes: int = 32, k: int = 10,
                    max_rows: int | None = None) -> float:
    """How well global-int8 scoring preserves neighbor RANKING.

    Returns mean top-k overlap between f32 and int8-dequant neighbor sets
    for sampled probes scanned against the FULL store (chunked; capped at
    ``max_rows``). Near 1.0 on spread-out data; collapses on tightly
    clustered data, where within-cluster separations drown in int8
    quantization noise.

    The scan runs at full density: subsampling the store inflates the
    k-NN gaps and the check false-passes, so ``max_rows`` defaults to
    None. ``metric`` is the serving metric; for cosine the rows are
    normalized first, as the serving store is.
    """
    n = vectors.shape[0]
    if n < 4 * k:
        return 1.0
    rng = np.random.default_rng(0)
    if max_rows is not None and n > max_rows:
        rows = np.sort(rng.choice(n, max_rows, replace=False))
        vs_src = vectors[rows]
        n = max_rows
    else:
        vs_src = vectors

    def prep(vm):
        vm = np.asarray(vm, np.float32)
        if metric == "cosine":
            return vm / np.maximum(
                np.linalg.norm(vm, axis=1, keepdims=True), 1e-30)
        return vm

    q_idx = rng.choice(n, min(probes, n), replace=False)
    q = prep(vs_src[q_idx])
    q_sq = np.sum(q * q, axis=1)
    # global absmax over the prepped rows, strided sample
    gs = 0.0
    for c0 in range(0, n, 65536):
        gs = max(gs, float(np.abs(prep(vs_src[c0:c0 + 4096])).max()))
    gs = (gs / 127.0) or 1.0

    def dists(qm, qsq, mat):
        qv = qm @ mat.T
        if metric == "dot":
            return -qv
        if metric == "cosine":
            nr = np.maximum(np.linalg.norm(mat, axis=1), 1e-30)
            return 1.0 - qv / nr[None, :]
        vsq = np.sum(mat * mat, axis=1)
        return qsq[:, None] + vsq[None, :] - 2.0 * qv   # (sq)euclidean

    kk = min(k + 1, n)
    P = len(q)
    d32 = np.full((P, kk), np.inf, np.float32)
    i32 = np.full((P, kk), -1, np.int64)
    d8 = np.full((P, kk), np.inf, np.float32)
    i8 = np.full((P, kk), -1, np.int64)
    for c0 in range(0, n, 131072):
        c1 = min(c0 + 131072, n)
        vm = prep(vs_src[c0:c1])
        v8 = np.clip(np.rint(vm / gs), -127, 127) * gs
        for dbuf, ibuf, mat in ((d32, i32, vm), (d8, i8, v8)):
            d = dists(q, q_sq, mat)
            cat_d = np.concatenate([dbuf, d], axis=1)
            cat_i = np.concatenate(
                [ibuf, np.broadcast_to(np.arange(c0, c1), (P, c1 - c0))],
                axis=1)
            part = np.argpartition(cat_d, kk - 1, axis=1)[:, :kk]
            dbuf[:] = np.take_along_axis(cat_d, part, axis=1)
            ibuf[:] = np.take_along_axis(cat_i, part, axis=1)
    return float(np.mean([len(set(i32[i]) & set(i8[i])) / kk
                          for i in range(P)]))


def upload(arr: np.ndarray, fill, shape: Sequence[int], device,
           dtype: Optional[torch.dtype] = None,
           chunk_bytes: int = 64 << 20) -> torch.Tensor:
    """``arr`` placed as the axis-0 prefix of a ``fill``-padded [shape]
    tensor on ``device`` (``dtype`` defaults to arr's). Rows are
    converted on the host per chunk of about ``chunk_bytes`` (round to
    nearest even), so no full-size converted copy is made on either
    side."""
    arr = np.asarray(arr)
    if dtype is None:
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    out = torch.full(tuple(shape), fill, dtype=dtype, device=device)
    n = arr.shape[0] if arr.ndim else 0
    if n and arr.size:
        step = max(1, chunk_bytes // max(1, arr[0].nbytes))
        for c0 in range(0, n, step):
            src = torch.from_numpy(np.ascontiguousarray(arr[c0:c0 + step]))
            out[c0:c0 + src.shape[0]].copy_(src.to(dtype))
    return out


def _upload_layers(nb: np.ndarray, cap: int, device) -> torch.Tensor:
    """[L, n, w] adjacency as a -1 padded [L, cap, w] int32 tensor."""
    out = torch.full((nb.shape[0], cap, nb.shape[2]), -1, dtype=torch.int32,
                     device=device)
    for lyr in range(nb.shape[0]):
        out[lyr] = upload(nb[lyr], -1, (cap, nb.shape[2]), device)
    return out


def default_device() -> torch.device:
    """The device an entry point given ``device=None`` serves on: the
    current CUDA device. Raises when CUDA is absent, so that a machine
    whose driver or card has failed never serves on the CPU unnoticed."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on "
            "the CPU")
    return torch.device("cuda")


def from_host(vectors: np.ndarray, sq_norms: np.ndarray,
              neighbors: np.ndarray, levels: np.ndarray,
              alive: np.ndarray, entry: int,
              cap_pad: int | None = None,
              store_dtype=np.float32,
              quantize: bool = False,
              hbm_vectors: bool = True,
              block_layout: bool = False,
              block_m: int | None = None,
              block_dtype: str = "auto",
              metric: str = "cosine",
              split_layers: "bool | str" = False,
              upper_m: int | None = None,
              device=None) -> DeviceGraph:
    """Upload host arrays to ``device`` (default: the CUDA device; raises
    without one), padding capacity to ``cap_pad`` (default: n bucketed to
    a power of two).

    ``store_dtype``: float32, float16 or bfloat16 (numpy dtype, torch
    dtype or name) for ``vectors``. ``quantize`` adds the int8 traversal
    store with per-row scales. ``hbm_vectors=False`` (requires quantize
    or block_layout) keeps only the int8 store and a [1, D] f32
    placeholder on the device: the capacity mode where raw vectors stay
    on the host and searches rerank there.

    ``block_layout`` adds layer-0 neighbor-vector blocks, gathered on the
    device from an uploaded store (``block_m`` < M0 keeps the first
    block_m edges of each row). ``block_dtype``: "int8" (global scale),
    "float16", or "auto" (_int8_block_fit under the serving ``metric``
    picks). ``split_layers`` True keeps the uppers as a dense
    [L-1, cap, upper_m] tensor, "compact" as a tuple of per-layer tables
    indexed through ``upper_map``.
    """
    device = torch.device(device) if device is not None \
        else default_device()
    if not hbm_vectors and not (quantize or block_layout):
        raise ValueError("hbm_vectors=False requires quantize=True")
    if block_layout:
        quantize = True
    n = vectors.shape[0]
    cap = cap_pad if cap_pad is not None else bucket_pow2(n)
    # bit 30 of slot ids carries the search pool's "expanded" flag
    # (core/search._EXP_BIT); ids at/above 2^30 would be corrupted.
    if cap >= (1 << 30):
        raise ValueError(
            f"cap {cap} >= 2^30: slot ids would collide with the "
            "search pool's expanded-flag bit (core/search._EXP_BIT)")
    L = neighbors.shape[0]
    dim = vectors.shape[1] if vectors.ndim == 2 and vectors.size else 1

    def put(a, fill, shape, dtype=None):
        return upload(a, fill, shape, device, dtype)

    # Prefold tombstones into the adjacency: edges to dead nodes become
    # -1 here, so the search hop never gathers an alive mask
    # (core/search.beam_search_layer relies on this invariant).
    nb = np.asarray(neighbors, np.int32)
    al = np.asarray(alive, bool)
    if nb.size and not al.all():
        safe = np.clip(nb, 0, al.shape[0] - 1)
        nb = np.where((nb >= 0) & al[safe], nb, -1)

    qvec = qscale = None
    gscale = None
    if quantize and vectors.size:
        if block_layout:
            # global scale: blocks and rows dequantize with one scalar
            gscale = float(np.abs(vectors).max()) / 127.0 or 1.0
            q = np.clip(np.rint(vectors.astype(np.float32) / gscale),
                        -127, 127).astype(np.int8)
            s = np.full((vectors.shape[0],), gscale, np.float32)
        else:
            q, s = quantize_rows(vectors.astype(np.float32))
        qvec = put(q, 0, (cap, q.shape[1]))
        qscale = put(s, 0, (cap,))

    if hbm_vectors:
        vec_dev = put(vectors, 0, (cap, dim), torch_dtype(store_dtype))
    else:
        vec_dev = torch.zeros((1, dim), dtype=torch.float32, device=device)

    nbr_upper = upper_map = None
    if split_layers and nb.shape[0] > 1:
        # layer 0 at full width, uppers truncated to upper_m (host upper
        # rows never carry more than the upper degree m)
        mu = upper_m if upper_m is not None else nb.shape[2]
        nb_dev = put(nb[0], -1, (cap, nb.shape[2]))[None]
        if split_layers == "compact":
            # rows ranked by descending level: layer l's U_l nodes are the
            # prefix [0, U_l) of every table
            lv = np.asarray(levels, np.int32)
            ups = np.flatnonzero(lv >= 1)
            ups = ups[np.argsort(-lv[ups], kind="stable")]
            umap = np.full((cap,), -1, np.int32)
            umap[ups] = np.arange(len(ups), dtype=np.int32)
            occupancy = [int((lv >= lyr).sum()) for lyr in range(1, L)]
            nbr_upper = tuple(
                put(nb[lyr][ups[:u], :mu], -1, (bucket_pow2(max(u, 1)), mu))
                for lyr, u in zip(range(1, L), occupancy))
            upper_map = put(umap, -1, (cap,))
        else:
            nbr_upper = _upload_layers(nb[1:, :, :mu], cap, device)
    else:
        nb_dev = _upload_layers(nb, cap, device)

    nbr_blocks = block_scale = None
    if block_layout and qvec is not None and nb_dev.shape[0]:
        if block_dtype == "auto":
            block_dtype = ("int8" if _int8_block_fit(
                vectors[: max(1, n)], metric=metric) >= 0.9
                else "float16")
        if block_dtype == "float16":
            # int8 cannot rank this data (tight clusters): gather the
            # blocks from a transient fp16 copy instead
            h16 = put(vectors, 0, (cap, dim), torch.float16)
            nbr_blocks = _gather_blocks(h16, nb_dev[0], block_m=block_m)
            del h16
            block_scale = torch.tensor(1.0, dtype=torch.float32,
                                       device=device)
        elif block_dtype == "int8":
            nbr_blocks = _gather_blocks(qvec, nb_dev[0], block_m=block_m)
            block_scale = torch.tensor(np.float32(gscale),
                                       dtype=torch.float32, device=device)
        else:
            raise ValueError(f"bad block_dtype {block_dtype!r}")
    return DeviceGraph(
        vectors=vec_dev,
        sq_norms=put(np.asarray(sq_norms, np.float32), 0, (cap,)),
        neighbors=nb_dev,
        levels=put(np.asarray(levels, np.int32), -1, (cap,)),
        alive=put(al, False, (cap,)),
        entry=torch.tensor(entry, dtype=torch.int32, device=device),
        qvec=qvec, qscale=qscale,
        nbr_blocks=nbr_blocks, block_scale=block_scale,
        nbr_upper=nbr_upper, upper_map=upper_map)


def _gather_blocks(table: torch.Tensor, nb0: torch.Tensor,
                   block_m: int | None = None) -> torch.Tensor:
    """[cap, M0, D] neighbor blocks via one device gather (rows for -1
    edges are arbitrary — the search hop masks them by id). ``block_m``
    < M0 keeps the first block_m edges of each row (rows are
    selection-ordered, best first)."""
    if block_m is not None and block_m < nb0.shape[1]:
        nb0 = nb0[:, :block_m]
    return table[torch.clamp(nb0, 0, table.shape[0] - 1).long()]
