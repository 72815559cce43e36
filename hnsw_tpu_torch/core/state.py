"""Device-resident graph state (port of hnsw_tpu/core/state.py).

One fixed-shape array representation of the HNSW graph, held as torch
tensors on the serving device:

    vectors   f32[cap, D]      raw vectors (row = dense slot id)
    sq_norms  f32[cap]         cached squared norms (distance epilogues)
    neighbors i32[L, cap, M]   per-layer fixed-degree adjacency, -1 = empty
    levels    i32[cap]         node's max layer, -1 = free slot
    alive     bool[cap]        tombstones
    entry     i32 scalar       entry slot (a node on the top layer)

Keys never reach the device (utils/keystore.SlotMap holds them). Only the
dense, unquantized, unblocked layout is ported; the int8 traversal store,
neighbor-vector blocks and split/compact upper layers are ROADMAP Queue 1
item 5.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DeviceGraph(NamedTuple):
    vectors: torch.Tensor    # [cap, D] float32
    sq_norms: torch.Tensor   # [cap] float32
    neighbors: torch.Tensor  # [L, cap, M] int32, -1 padded
    levels: torch.Tensor     # [cap] int32, -1 = unused
    alive: torch.Tensor      # [cap] bool
    entry: torch.Tensor      # [] int32

    @property
    def cap(self) -> int:
        return self.neighbors.shape[1]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def num_layers(self) -> int:
        return self.neighbors.shape[0]

    @property
    def m(self) -> int:
        return self.neighbors.shape[2]

    def layer_neighbors(self, layer: int) -> torch.Tensor:
        """[cap, M] adjacency of one layer."""
        return self.neighbors[layer]

    def layer_width(self, layer: int) -> int:
        """Edge width of one layer's rows."""
        return self.neighbors.shape[2]

    def gather_neighbors(self, layer: int, ids: torch.Tensor
                         ) -> torch.Tensor:
        """Neighbor rows of ``ids`` (any shape of in-range slot ids) at one
        layer -> [..., M] int32, -1 padded."""
        return self.neighbors[layer][ids]


def bucket_pow2(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def from_host(vectors: np.ndarray, sq_norms: np.ndarray,
              neighbors: np.ndarray, levels: np.ndarray,
              alive: np.ndarray, entry: int,
              cap_pad: int | None = None,
              store_dtype=np.float32,
              quantize: bool = False,
              hbm_vectors: bool = True,
              block_layout: bool = False,
              split_layers: "bool | str" = False,
              device="cpu") -> DeviceGraph:
    """Upload host arrays to ``device``, padding capacity to ``cap_pad``
    (default: n bucketed to a power of two)."""
    if np.dtype(store_dtype) != np.float32:
        raise NotImplementedError(
            f"store_dtype={np.dtype(store_dtype).name}: reduced-precision "
            "graph stores are ROADMAP Queue 1 item 5")
    if quantize or not hbm_vectors:
        raise NotImplementedError(
            "the int8 traversal store (quantize / hbm_vectors=False) is "
            "ROADMAP Queue 1 item 5")
    if block_layout:
        raise NotImplementedError(
            "neighbor-vector blocks are ROADMAP Queue 1 item 5")
    if split_layers:
        raise NotImplementedError(
            "split/compact upper-layer storage is ROADMAP Queue 1 item 5")
    n = vectors.shape[0]
    cap = cap_pad if cap_pad is not None else bucket_pow2(n)
    # bit 30 of slot ids carries the search pool's "expanded" flag
    # (core/search._EXP_BIT); ids at/above 2^30 would be corrupted.
    if cap >= (1 << 30):
        raise ValueError(
            f"cap {cap} >= 2^30: slot ids would collide with the "
            "search pool's expanded-flag bit (core/search._EXP_BIT)")
    L, _, m = neighbors.shape

    def padded(a: np.ndarray, fill, shape, dtype) -> torch.Tensor:
        out = torch.full(shape, fill, dtype=dtype, device=device)
        if a.size:
            src = torch.from_numpy(np.ascontiguousarray(a))
            if a.ndim == 3:
                out[:, :a.shape[1]].copy_(src)
            else:
                out[:a.shape[0]].copy_(src)
        return out

    # Prefold tombstones into the adjacency: edges to dead nodes become
    # -1 here, so the search hop never gathers an alive mask
    # (core/search.beam_search_layer relies on this invariant).
    nb = np.asarray(neighbors, np.int32)
    al = np.asarray(alive, bool)
    if nb.size and not al.all():
        safe = np.clip(nb, 0, al.shape[0] - 1)
        nb = np.where((nb >= 0) & al[safe], nb, -1)

    dim = vectors.shape[1] if vectors.ndim == 2 else 1
    return DeviceGraph(
        vectors=padded(np.asarray(vectors, np.float32), 0.0, (cap, dim),
                       torch.float32),
        sq_norms=padded(np.asarray(sq_norms, np.float32), 0.0, (cap,),
                        torch.float32),
        neighbors=padded(nb, -1, (L, cap, m), torch.int32),
        levels=padded(np.asarray(levels, np.int32), -1, (cap,),
                      torch.int32),
        alive=padded(al, False, (cap,), torch.bool),
        entry=torch.tensor(entry, dtype=torch.int32, device=device),
    )
