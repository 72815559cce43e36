"""Carry state from the JAX package into this one, through numpy.

    fields = {k: (tuple(np.asarray(t) for t in v) if isinstance(v, tuple)
                  else np.asarray(v))
              for k, v in jax_dev._asdict().items() if v is not None}
    dev = device_graph_from_numpy(fields, "cuda")

    g = graph_from_host_arrays(jg.cfg, jg.slots.slot_to_key,
                               jg.store.vectors[:n], jg.store.alive[:n],
                               *jg.host.arrays())

(``nbr_upper`` of a compact-upper graph is a tuple of per-layer arrays of
different shapes, so it is converted array by array.) Neither function
imports the JAX package; both take plain numpy arrays (and, for the
config, any object with GraphConfig's fields).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch

from hnsw_tpu_torch.config import GraphConfig
from hnsw_tpu_torch.core.state import DeviceGraph

#: every DeviceGraph field and the dtype it is carried in (None: keep the
#: array's own float type, float32 / float16 / bfloat16)
_FIELDS = {"vectors": None, "sq_norms": np.float32,
           "neighbors": np.int32, "levels": np.int32, "alive": bool,
           "entry": np.int32, "qvec": np.int8, "qscale": np.float32,
           "nbr_blocks": None, "block_scale": np.float32,
           "nbr_upper": np.int32, "upper_map": np.int32}


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if dtype is None and a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (what np.asarray gives for a JAX bf16 array):
        # carried bit for bit
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, dtype if dtype is not None
                                     else a.dtype)).to(device)


def device_graph_from_numpy(fields: Dict[str, Any], device) -> DeviceGraph:
    """The JAX ``DeviceGraph``'s fields (numpy arrays; None fields left
    out) as this package's ``DeviceGraph`` on ``device``, in any layout.
    ``nbr_upper`` may be one array (dense split) or a sequence of arrays
    (compact uppers)."""
    extra = sorted(set(fields) - set(_FIELDS))
    if extra:
        raise ValueError(f"not DeviceGraph fields: {extra}")
    out = {}
    for name, a in fields.items():
        dt = _FIELDS[name]
        if name == "nbr_upper" and isinstance(a, (list, tuple)):
            out[name] = tuple(_tensor(t, dt, device) for t in a)
        else:
            out[name] = _tensor(a, dt, device)
    return DeviceGraph(**out)


def graph_from_host_arrays(config, slot_to_key: Sequence[Any],
                           vectors: np.ndarray, alive: np.ndarray,
                           neighbors: np.ndarray, levels: np.ndarray,
                           entry: int, top: int, device=None):
    """A ``Graph`` of this package that serves the same graph as a JAX
    ``hnsw_tpu.Graph``: keys by slot (None = free slot), the store's
    vectors and alive flags for those slots, and ``host.arrays()``
    (neighbors [L, cap, M], levels, entry, top). ``config`` is a
    GraphConfig of either package."""
    from hnsw_tpu_torch.index.hnsw import Graph
    cfg = GraphConfig(**dataclasses.asdict(config))
    g = Graph(config=cfg, device=device)
    n = len(slot_to_key)
    g.slots.slot_to_key = list(slot_to_key)
    g.slots.key_to_slot = {k: s for s, k in enumerate(slot_to_key)
                           if k is not None}
    g.slots.free = [s for s, k in enumerate(slot_to_key) if k is None]
    vectors = np.asarray(vectors, np.float32)[:n]
    g.store.ensure_dim(vectors.shape[1])
    g.store.ensure_capacity(max(n, 1))
    live = np.flatnonzero(np.asarray(alive, bool)[:n])
    g.store.vectors[:n] = vectors
    g.store.put_batch(live, vectors[live])
    h = g.host
    h.neighbors = np.array(neighbors, np.int32)
    h.levels = np.array(levels, np.int32)
    h.entry, h.top = int(entry), int(top)
    h.count = int((h.levels >= 0).sum())
    return g
