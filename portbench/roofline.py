"""The least time the H100 could take for a measured piece of work.

Frozen copies of the program's ``utils/roofline.PEAKS`` and
``search_bound_s``: the published peaks of one NVIDIA H100 SXM (NVIDIA's
data sheet, dense, at the full 700 W power limit) and the bound of a whole
graph search. The work they are given is counted by this benchmark's own
plain search (``reference.walk``), never by the program.
"""

from __future__ import annotations

from typing import Sequence, Tuple

H100_SXM = "NVIDIA H100 80GB HBM3"

#: dense peaks by card name: FLOP/s for bf16 and TF32 tensor-core
#: products, int8 tensor-core OP/s, float32 FLOP/s outside the tensor
#: cores, and HBM bytes/s
PEAKS = {H100_SXM: {"bf16": 989.4e12, "tf32": 494.7e12, "int8": 1979e12,
                    "fp32": 66.9e12, "hbm_bytes_s": 3.35e12}}


def search_bound_s(n_queries: int, d: int, k: int, starts: int,
                   layers: Sequence[Tuple[int, int, int, int, int, str]]
                   ) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time on the H100 SXM of
    a whole graph search for ``n_queries`` queries. ``layers`` holds, for
    each layer searched, (width, nodes, rows, scored, row_bytes, kind): the
    neighbour ids of ``nodes`` distinct nodes, ``row_bytes`` of each of
    ``rows`` distinct rows, ``scored`` candidates scored with operands of
    type ``kind``. It is the larger of the bytes the search must move over
    the HBM rate (each query row and squared norm and its ``starts`` entry
    ids once, each layer's distinct node ids and rows once, the
    [n_queries, k] distances and ids and one hop count a layer and query
    written once) and the operations (2 d a scored candidate) over the peaks
    of their types, summed over the layers."""
    peaks = PEAKS[H100_SXM]
    moved = n_queries * (4 * d + 4 + 4 * starts + 8 * k + 4 * len(layers))
    t_ops = 0.0
    for width, nodes, rows, scored, row_bytes, kind in layers:
        moved += 4 * width * nodes + row_bytes * rows
        t_ops += 2.0 * d * scored / peaks[kind]
    t_bytes = moved / peaks["hbm_bytes_s"]
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"
