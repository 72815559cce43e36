"""Carry state from the JAX package into this one, through numpy.

    fields = {k: np.asarray(v) for k, v in jax_dev._asdict().items()
              if v is not None}
    dev = device_graph_from_numpy(fields, "cuda")

    g = graph_from_host_arrays(jg.cfg, jg.slots.slot_to_key,
                               jg.store.vectors[:n], jg.store.alive[:n],
                               *jg.host.arrays())

Neither function imports the JAX package; both take plain numpy arrays
(and, for the config, any object with GraphConfig's fields).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch

from hnsw_tpu_torch.config import GraphConfig
from hnsw_tpu_torch.core.state import DeviceGraph

_FIELDS = ("vectors", "sq_norms", "neighbors", "levels", "alive", "entry")


def device_graph_from_numpy(fields: Dict[str, np.ndarray],
                            device) -> DeviceGraph:
    """The JAX ``DeviceGraph``'s fields (numpy arrays; None fields left
    out) as this package's ``DeviceGraph`` on ``device``. Only the dense,
    unquantized, unblocked layout exists here."""
    extra = sorted(set(fields) - set(_FIELDS))
    if extra:
        raise NotImplementedError(
            f"DeviceGraph fields {extra}: the int8 store, neighbor blocks "
            "and split upper layers are ROADMAP Queue 1 item 5")
    dtypes = {"vectors": np.float32, "sq_norms": np.float32,
              "neighbors": np.int32, "levels": np.int32, "alive": bool,
              "entry": np.int32}
    return DeviceGraph(**{
        k: torch.from_numpy(np.array(fields[k], dtypes[k])).to(device)
        for k in _FIELDS})


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
