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


def _carry_slots(dst, src_slots) -> None:
    """Copy a SlotMap's state (keys by slot, free list) into ``dst``."""
    dst.slot_to_key = list(src_slots.slot_to_key)
    dst.key_to_slot = dict(src_slots.key_to_slot)
    dst.free = list(src_slots.free)


def _carry_store(dst, src_store, n: int) -> None:
    """Copy the first ``n`` rows of a host vector store into ``dst``."""
    if src_store.dim is None:
        return
    dst.ensure_dim(int(src_store.dim))
    dst.ensure_capacity(max(n, 1))
    dst.vectors[:n] = np.asarray(src_store.vectors[:n], np.float32)
    dst.sq_norms[:n] = np.asarray(src_store.sq_norms[:n], np.float32)
    dst.alive[:n] = np.asarray(src_store.alive[:n], bool)


def ivf_from_jax(ivf, device=None):
    """An ``IVFIndex`` of this package holding the state of a trained
    ``hnsw_tpu`` IVFIndex (centroids, slot map, store, partition
    members, auto-nprobe cache), so both search identical indexes without
    retraining. Takes the object's numpy state; imports nothing of the
    JAX package."""
    from hnsw_tpu_torch.index.ivf import IVFIndex
    out = IVFIndex(num_partitions=ivf.P, nprobe=ivf.nprobe,
                   metric=ivf.metric, seed=ivf.seed,
                   kmeans_iters=ivf.kmeans_iters,
                   auto_recall=ivf.auto_recall, device=device)
    if ivf.centroids is not None:
        out.centroids = np.array(ivf.centroids, np.float32)
    _carry_slots(out.slots, ivf.slots)
    _carry_store(out.store, ivf.store, ivf.slots.capacity_used)
    # a set's iteration order follows its insertion history, and _sync
    # lays a block out in that order: re-insert in the source's order
    out._members = [set() for _ in range(ivf.P)]
    for p, mem in enumerate(ivf._members):
        for s in mem:
            out._members[p].add(int(s))
    out._part_of = {int(s): int(p) for s, p in ivf._part_of.items()}
    out._auto_cache = ivf._auto_cache
    return out


def lsh_from_jax(lsh, device=None):
    """An ``LSHIndex`` of this package holding the state of a filled
    ``hnsw_tpu`` LSHIndex (planes, slot map, store, bucket tables and
    per-slot codes)."""
    from hnsw_tpu_torch.index.lsh import LSHIndex
    out = LSHIndex(metric=lsh.metric, num_tables=lsh.num_tables,
                   num_bits=lsh.num_bits, seed=lsh.seed, device=device)
    if lsh.planes is not None:
        out.planes = np.array(lsh.planes, np.float32)
    _carry_slots(out.slots, lsh.slots)
    _carry_store(out.store, lsh.store, lsh.slots.capacity_used)
    out.tables = [{int(c): {int(s) for s in b} for c, b in t.items()}
                  for t in lsh.tables]
    out._codes = {int(s): np.array(c, np.int64)
                  for s, c in lsh._codes.items()}
    out.host_serve_max_batch = lsh.host_serve_max_batch
    return out


def partitioner_from_jax(p, device=None):
    """A ``Partitioner`` of this package holding the state of a
    ``hnsw_tpu`` Partitioner (centroids, members, assignment, vectors)."""
    from hnsw_tpu_torch.index.partitioner import Partitioner
    out = Partitioner(p.num_partitions, metric=p.metric, seed=p.seed,
                      device=device)
    out.dim = p.dim
    if p.centroids is not None:
        out.centroids = np.array(p.centroids, np.float32)
    out.members = [set(m) for m in p.members]
    out.assignment = dict(p.assignment)
    out._vectors = {k: np.array(v, np.float32)
                    for k, v in p._vectors.items()}
    return out


def row_shards_from_jax(shards, device=None):
    """A ``RowShards`` of this package (parallel/rowsharded.py) holding
    the tensors of a JAX ``RowShards`` (layer-0 rows, vectors in their
    float32 or float16 dtype, norms, pivot table) on ``device``."""
    from hnsw_tpu_torch.core.state import default_device
    from hnsw_tpu_torch.parallel.rowsharded import RowShards
    device = torch.device(device) if device is not None else default_device()
    dtypes = {"nbr0": np.int32, "vectors": None, "sq_norms": np.float32,
              "pivot_ids": np.int32, "pivot_vecs": np.float32,
              "pivot_sq": np.float32}
    return RowShards(**{f: _tensor(getattr(shards, f), dt, device)
                        for f, dt in dtypes.items()})


def partitioned_from_jax(pg, device=None):
    """A ``PartitionedGraph`` of this package serving what a built
    ``hnsw_tpu`` PartitionedGraph serves: its trained Partitioner (through
    ``partitioner_from_jax``) and each sub-graph (through
    ``graph_from_host_arrays``), every partition on ``device``."""
    from hnsw_tpu_torch.core.state import default_device
    from hnsw_tpu_torch.parallel.partitioned import PartitionedGraph
    from hnsw_tpu_torch.parallel.sharded import Mesh
    device = torch.device(device) if device is not None else default_device()
    cfg = GraphConfig(**dataclasses.asdict(pg.cfg))
    out = PartitionedGraph(Mesh([device] * pg.n_parts, pg.axis), cfg,
                           axis=pg.axis)
    out.partitioner = partitioner_from_jax(pg.partitioner, device)
    for p, jg in enumerate(pg.graphs):
        n = jg.slots.capacity_used
        if n == 0:
            continue                    # an empty partition stays empty
        g = graph_from_host_arrays(jg.cfg, jg.slots.slot_to_key[:n],
                                   jg.store.vectors[:n], jg.store.alive[:n],
                                   *jg.host.arrays(), device=device)
        g.split_layers = False
        out.graphs[p] = g
    return out
