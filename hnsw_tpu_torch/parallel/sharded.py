"""Multi-device execution over a device mesh (port of
hnsw_tpu/parallel/sharded.py).

The JAX package runs these as ``shard_map`` programs: global arrays go
in, XLA places one shard on each device of a ``jax.sharding.Mesh`` and
inserts the collectives. The port keeps that single-controller form.
A ``Mesh`` here is an ordered tuple of ``torch.device``s, one per shard;
devices may repeat, so eight shards can sit on one card (or on the CPU
in tests, the counterpart of the JAX tests' virtual 8-device CPU mesh).
One process drives every shard in turn and the collectives are local
tensor moves: ``all_gather`` moves each shard's small [Q, k] result to
the first shard's device and stacks it; ``psum`` sums the owner-masked
contributions there. There is no ``torch.distributed``: a communicator
takes one rank per GPU, and a mesh of several shards on one card is the
configuration the card's smoke run and the tests use.

Two axes of scale, as in JAX:

  * queries sharded, index replicated (``sharded_graph_search``);
  * rows sharded (``sharded_exact_topk``, ``sharded_quantized_candidates``,
    ``sharded_ivf_candidates``): each shard scans its rows, nominates k
    local candidates, and a global top-k merges the gathered winners.

A shard of a row-sharded table is a row view of the caller's tensor, not
a copy, when it lives on the shard's device. Each shard's exact scan is
``ops/exact_screen.exact_scan``: K1 (csrc/exact_screen.cu) on a float32
CUDA shard of at least 32,768 rows, the plain chunked scan elsewhere;
each shard's capacity scan is ``ops/exact_screen.capacity_scan``.
(The JAX function calls XLA's ``exact_topk`` per shard; the function and
its result are the same.)

Tensors go in on any device; results come back on the first device of
the mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from hnsw_tpu_torch.config import canonical_metric
from hnsw_tpu_torch.core.search import search_graph
from hnsw_tpu_torch.core.state import DeviceGraph, default_device
from hnsw_tpu_torch.ops.distance import INF_DIST, pairwise_dist
from hnsw_tpu_torch.ops.exact_screen import capacity_scan, exact_scan
from hnsw_tpu_torch.ops.topk import merge_topk, topk_smallest

_INF = float(INF_DIST)
#: score bytes per step of a shard's probe-masked IVF scan
_IVF_SCAN_BYTES = 1 << 28


def _indexed(d: torch.device) -> torch.device:
    """``d`` with its index: "cuda" is the current CUDA device, so that
    shards compare equal to the devices their tensors report."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """One named axis of shards, each on a ``torch.device``.

    ``mesh.shape[axis]`` is the shard count, as on a JAX mesh. Devices may
    repeat: ``Mesh(["cpu"] * 8)`` is eight shards on the CPU,
    ``Mesh(["cuda:0"] * 8)`` eight on one card."""

    def __init__(self, devices: Sequence, axis: str = "data"):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(
            _indexed(torch.device(d)) for d in devices)
        self.axis = axis
        self.shape: Dict[str, int] = {axis: len(self.devices)}

    @property
    def one_device(self) -> bool:
        """Whether every shard sits on the same device."""
        return len(set(self.devices)) == 1

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def default_mesh(n_devices: Optional[int] = None, axis: str = "data",
                 device=None) -> Mesh:
    """``n_devices`` shards. ``device=None``: round-robin over the visible
    CUDA devices (default: one shard each); raises without CUDA, so a mesh
    never lands on the CPU unnoticed. A named ``device`` ("cpu", "cuda:1")
    holds every shard (default: one)."""
    if device is not None:
        return Mesh([torch.device(device)] * (n_devices or 1), axis)
    default_device()                     # raises without CUDA
    count = torch.cuda.device_count()
    n = n_devices or count
    return Mesh([torch.device("cuda", i % count) for i in range(n)], axis)


def _shards(t: torch.Tensor, mesh: Mesh, axis: str):
    """Row blocks of ``t`` over the mesh, each on its shard's device: a
    view of ``t`` where it already lives there."""
    n_local = t.shape[0] // mesh.shape[axis]
    return [t[s * n_local:(s + 1) * n_local].to(dev)
            for s, dev in enumerate(mesh.devices)]


def _all_gather(parts, device) -> torch.Tensor:
    """[S, ...] stack of per-shard tensors on ``device``."""
    return torch.stack([p.to(device) for p in parts])


def _psum(parts, device) -> torch.Tensor:
    """Sum of per-shard contributions on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def _merge(dg: torch.Tensor, ig: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k of gathered per-shard winners dg / ig [S, Q, k'];
    equal distances go to the lower shard (the stable sort), so to the
    lower global id."""
    q_n = dg.shape[1]
    dd = dg.permute(1, 0, 2).reshape(q_n, -1)
    ii = ig.permute(1, 0, 2).reshape(q_n, -1)
    dk, pos = topk_smallest(dd, k)
    ik = torch.gather(ii, 1, pos)
    return dk, torch.where(dk >= _INF, -1, ik)


def _pad_k(d: torch.Tensor, i: torch.Tensor, k: int):
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.nn.functional.pad(d, (0, pad), value=_INF)
        i = torch.nn.functional.pad(i, (0, pad), value=-1)
    return d, i


def sharded_exact_topk(queries, vectors, v_sq, valid, *, k: int,
                       metric: str = "cosine", mesh: Mesh,
                       axis: str = "data"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded exact k-NN: each shard's exact scan (K1 on a float32
    CUDA shard of >= 32,768 rows) + a global top-k merge.

    vectors [N, D] / v_sq [N] / valid [N] are split into S row blocks;
    queries are replicated. Returned indices are GLOBAL row ids (int64),
    -1 for a miss; ties go to the lower id, as in one scan of the whole
    table. N must divide by the mesh size (pad with valid=False rows).
    """
    metric = canonical_metric(metric)
    S = mesh.shape[axis]
    if vectors.shape[0] % S:
        raise ValueError(f"row count {vectors.shape[0]} not divisible by "
                         f"mesh size {S}; pad with valid=False rows")
    n_local = vectors.shape[0] // S
    home = mesh.devices[0]
    vs = _shards(vectors, mesh, axis)
    sqs = _shards(v_sq, mesh, axis)
    vds = _shards(valid, mesh, axis)
    q = queries.to(home).to(torch.float32)
    ds, is_ = [], []
    for s, dev in enumerate(mesh.devices):
        d, i = exact_scan(q.to(dev), vs[s], sqs[s], vds[s],
                          k=min(k, n_local), metric=metric)
        i = torch.where(i >= 0, i + s * n_local, -1)
        d, i = _pad_k(d, i, k)
        ds.append(d)
        is_.append(i)
    return _merge(_all_gather(ds, home), _all_gather(is_, home), k)


def sharded_quantized_candidates(queries, table, scales, v_sq, valid, *,
                                 kk: int, metric: str = "cosine",
                                 mesh: Mesh, axis: str = "data"
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded CAPACITY-mode scan: each shard scans its own
    reduced-precision rows (bf16 / fp16 table with scales=None, or int8
    with per-row scales: ops/exact_screen.capacity_scan, the capacity
    screen on every CUDA shard), nominates kk
    local candidates, and a gather + exact merge returns the global kk.
    The caller restores exact f32 ordering with one host rerank of the
    merged pool (utils/rerank.host_rerank), as in the single-table mode.
    Returned indices are GLOBAL row ids; rows must divide by the mesh
    size (pad with valid=False rows)."""
    metric = canonical_metric(metric)
    S = mesh.shape[axis]
    if table.shape[0] % S:
        raise ValueError(f"row count {table.shape[0]} not divisible by "
                         f"mesh size {S}; pad with valid=False rows")
    n_local = table.shape[0] // S
    kk = min(kk, n_local)
    home = mesh.devices[0]
    ts = _shards(table, mesh, axis)
    scs = (_shards(scales, mesh, axis)
           if scales is not None else [None] * S)
    sqs = _shards(v_sq, mesh, axis)
    vds = _shards(valid, mesh, axis)
    q = queries.to(home).to(torch.float32)
    ds, is_ = [], []
    for s, dev in enumerate(mesh.devices):
        d, i = capacity_scan(q.to(dev), ts[s], scs[s], sqs[s], vds[s],
                             kk=kk, metric=metric)
        ds.append(d)
        is_.append(torch.where(i >= 0, i + s * n_local, -1))
    return _merge(_all_gather(ds, home), _all_gather(is_, home), kk)


def _probe_masked_scan(q, probed, metric: str, blocks, bsq, bv, bp,
                       kk: int):
    """One shard's probe-masked scan of its blocks [nb, bs, D] at full
    f32 -> (dists [Q, kk], flattened local ids [Q, kk]). Blocks are taken
    in runs of at most _IVF_SCAN_BYTES of scores with a running top-k
    (ties to the lower flattened id, as one selection over all)."""
    nb, bs, _ = blocks.shape
    q_sq = torch.sum(q * q, dim=-1)
    step = max(1, _IVF_SCAN_BYTES // max(1, q.shape[0] * bs * 4))
    dk = ik = None
    for b0 in range(0, nb, step):
        b = blocks[b0:b0 + step]
        gram = torch.einsum("qd,ncd->qnc", q, b)
        sq = bsq[b0:b0 + step]
        if metric == "cosine":
            d = 1.0 - gram * torch.rsqrt(
                q_sq[:, None, None] * sq[None, :, :] + 1e-30)
        elif metric == "dot":
            d = -gram
        else:
            d = torch.clamp_min(q_sq[:, None, None] + sq[None, :, :]
                                - 2.0 * gram, 0.0)
            if metric == "l2":
                d = torch.sqrt(d)
        hit = (bp[b0:b0 + step][None, :, None]
               == probed[:, None, :]).any(-1)               # [Q, nb']
        d = torch.where(bv[b0:b0 + step][None, :, :], d, _INF)
        d = torch.where(hit[:, :, None], d, _INF)
        d = d.reshape(q.shape[0], -1)
        cd, ci = topk_smallest(d, min(kk, d.shape[1]))
        ci = ci + b0 * bs
        if dk is None:
            dk, ik = cd, ci
        else:
            dk, ik = merge_topk(dk, ik, cd, ci, kk)
    return dk, ik


def sharded_ivf_candidates(queries, cents, blocks, block_sq, block_valid,
                           block_part, *, nprobe: int, k: int,
                           metric: str = "cosine", mesh: Mesh,
                           axis: str = "data"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-sharded IVF scan: the [NB, bs, D] partition-block table is
    split on its block axis, the centroids are replicated, and every shard
    runs the probe routing (one [Q, P] product at full f32, the same
    ``pairwise_dist`` IVFIndex routes with) and a probe-MASKED scan of its
    blocks at full f32, nominates k local candidates, and a global top-k
    merges the gathered winners.

    block_part [NB] int32 is the owning partition of each block (-1 for a
    pad block). NB must divide by the mesh size (pad with empty blocks).
    Returned ids index the FLATTENED global [NB * bs] block grid (-1 =
    miss); callers decode them to store slots through
    ``block_slot.reshape(-1)[ids]`` (index/ivf.IVFIndex layout).
    """
    metric = canonical_metric(metric)
    S = mesh.shape[axis]
    if blocks.shape[0] % S:
        raise ValueError(f"block count {blocks.shape[0]} not divisible by "
                         f"mesh size {S}; pad with empty blocks")
    nb_local = blocks.shape[0] // S
    bs = blocks.shape[1]
    kk = min(k, nb_local * bs)
    home = mesh.devices[0]
    bl = _shards(blocks, mesh, axis)
    bsqs = _shards(block_sq, mesh, axis)
    bvs = _shards(block_valid, mesh, axis)
    bps = _shards(block_part, mesh, axis)
    q = queries.to(home).to(torch.float32)
    c = cents.to(home).to(torch.float32)
    routed: Dict[torch.device, tuple] = {}
    ds, is_ = [], []
    for s, dev in enumerate(mesh.devices):
        if dev not in routed:
            # probe routing on the replicated centroids: the same probes
            # for every shard, computed once per device
            qs, cs = q.to(dev), c.to(dev)
            _, probed = topk_smallest(pairwise_dist(qs, cs, metric=metric),
                                      min(nprobe, cs.shape[0]))
            routed[dev] = (qs, probed)
        qs, probed = routed[dev]
        dk, ik = _probe_masked_scan(qs, probed, metric, bl[s], bsqs[s],
                                    bvs[s], bps[s], kk)
        ik = torch.where(dk < _INF, ik + s * (nb_local * bs), -1)
        dk, ik = _pad_k(dk, ik, k)
        ds.append(dk)
        is_.append(ik)
    return _merge(_all_gather(ds, home), _all_gather(is_, home), k)


def _graph_on(g: DeviceGraph, device) -> DeviceGraph:
    """``g`` with every tensor on ``device`` (``g`` itself when it is
    there already)."""
    if g.vectors.device == torch.device(device):
        return g
    return DeviceGraph(**{
        f: (None if v is None else
            tuple(t.to(device) for t in v) if isinstance(v, tuple)
            else v.to(device))
        for f, v in g._asdict().items()})


def sharded_graph_search(g: DeviceGraph, queries, *, k: int, ef: int,
                         metric: str = "cosine", max_hops: int = 128,
                         mesh: Mesh, axis: str = "data"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-sharded HNSW search: the graph is replicated (the shards of
    one device share its tensors), the batch is split over the mesh and
    each shard runs ``core/search.search_graph`` on its part. The query
    count must divide by the mesh size. Results are concatenated in query
    order on the first device."""
    metric = canonical_metric(metric)
    S = mesh.shape[axis]
    if queries.shape[0] % S:
        raise ValueError(
            f"query count {queries.shape[0]} not divisible by mesh size "
            f"{S}; pad the batch")
    home = mesh.devices[0]
    q = queries.to(home)
    per = q.shape[0] // S
    copies: Dict[torch.device, DeviceGraph] = {}
    ds, is_ = [], []
    for s, dev in enumerate(mesh.devices):
        gs = copies.setdefault(dev, _graph_on(g, dev))
        d, i = search_graph(gs, q[s * per:(s + 1) * per].to(dev), k=k,
                            ef=ef, metric=metric, max_hops=max_hops)
        ds.append(d.to(home))
        is_.append(i.to(home))
    return torch.cat(ds), torch.cat(is_)


def partitioned_graph_search(graphs: DeviceGraph, queries, *, k: int,
                             ef: int, metric: str = "cosine",
                             max_hops: int = 128, mesh: Mesh,
                             axis: str = "data"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partition-sharded HNSW (the expert-parallel analogue): shard p owns
    an independent sub-graph over its partition of the data. ``graphs``
    holds stacked per-partition tensors with a leading shard axis:
    vectors [S, cap, D], neighbors [S, L, cap, M], entry [S], ... (the
    dense layout: no optional DeviceGraph fields). Every shard searches
    its own sub-graph for ALL queries; the global top-k merges the
    gathered per-partition candidates.

    Returned ids are (partition, local slot) encoded as
    partition * cap + local_slot; -1 = miss.
    """
    metric = canonical_metric(metric)
    cap = graphs.vectors.shape[-2]
    home = mesh.devices[0]
    q = queries.to(home)
    ds, is_ = [], []
    for p, dev in enumerate(mesh.devices):
        gp = DeviceGraph(**{f: (None if v is None else v[p].to(dev))
                            for f, v in graphs._asdict().items()})
        d, i = search_graph(gp, q.to(dev), k=k, ef=ef, metric=metric,
                            max_hops=max_hops)
        ds.append(d)
        is_.append(torch.where(i >= 0, i.to(torch.int64) + p * cap, -1))
    return _merge(_all_gather(ds, home), _all_gather(is_, home), k)
