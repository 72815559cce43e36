"""Device-resident bulk construction (port of hnsw_tpu/core/build_device.py).

core/build.py's wave builder keeps the neighbor tables host-authoritative
and re-uploads them every wave. This module keeps ALL build state on the
graph's device across waves:

  vectors/sq     uploaded once (immutable during build)
  neighbors      layer 0 as one [cap, M0] tensor, the upper layers as
                 COMPACT level-ranked tables; updated in place
  levels/alive   device tensors, committed per wave

Per wave the only host<->device traffic is the wave's slot ids and
levels. Edge assembly runs fully on the device:

  * wave rows: candidate slate (descent pool + intra-wave top-k) ->
    diversity-heuristic selection (core/build._diverse_select_dev, one
    launch of the K4 kernel on the card) -> row write;
  * reverse edges: sort-based segmentation — rank incoming edges per
    target with two stable sorts and a cummax, keep the best m, then one
    masked top-m merge of (existing row ∪ incoming) per touched target
    (plain closest-m by default; GraphConfig.reverse_diversify switches
    to the diversity heuristic).

The host arrays are synchronized once at the end (and at checkpoints).

Every candidate that ranks edge selection is scored at HIGHEST
(_row_dist_dense): the descent runs at DEFAULT (bf16-rounded operands)
and, optionally, over fp16 rows or int8 neighbor blocks, so its pool
distances order the pool but do not rank edges. (The JAX package's
_row_dist_dense runs its einsum at DEFAULT, which is one bf16 pass on a
TPU; ROADMAP Queue 3, fault F6.)

Shapes follow the data, not a compile cache: a layer's assembly takes
only the wave nodes that reach it, and the reverse update only the
targets its edges touch.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Optional

import numpy as np
import torch

from hnsw_tpu_torch.config import canonical_metric
from hnsw_tpu_torch.core import host_build
from hnsw_tpu_torch.core.build import (_diverse_select_dev,
                                       construction_descent)
from hnsw_tpu_torch.core.search import beam_search_layer
from hnsw_tpu_torch.core.state import (DeviceGraph, _gather_blocks,
                                       bucket_pow2, default_device, upload)
from hnsw_tpu_torch.ops.distance import (DEFAULT, HIGHEST, INF_DIST,
                                         _custom_pairwise, gathered_dist,
                                         pairwise_dist, registered)
from hnsw_tpu_torch.ops.topk import topk_smallest
from hnsw_tpu_torch.utils.profiling import span
from hnsw_tpu_torch.utils.progress import BuildHeartbeat

_INF = float(INF_DIST)

#: the reverse update re-selects touched rows in chunks of this many
#: targets, bounding the [chunk, Wd + deg, D] gather
_REVERSE_CHUNK = 4096


def _row_dist_dense(vectors, sq, anchors, others, metric):
    """dist(vectors[anchors[u]], vectors[others[u, k]]) -> [U, K] at
    HIGHEST precision (f32 rows of any stored dtype); -1 anchors/others
    give INF_DIST. A registered custom metric scores each anchor's row
    with its pairwise_fn."""
    n = vectors.shape[0]
    safe_a = torch.clamp(anchors, 0, n - 1).long()
    safe_o = torch.clamp(others, 0, n - 1).long()
    va = vectors[safe_a].to(torch.float32)
    vo = vectors[safe_o].to(torch.float32)
    spec = registered(metric)
    if spec is not None:
        pw = _custom_pairwise(metric, spec)
        d = torch.stack([pw(a[None, :], o)[0] for a, o in zip(va, vo)]) \
            if va.shape[0] else torch.zeros(others.shape, device=va.device)
    else:
        d = gathered_dist(va, vo, sq[safe_o], sq[safe_a], metric=metric,
                          precision=HIGHEST)
    return torch.where((others >= 0) & (anchors[:, None] >= 0), d, _INF)


def _assemble_refine_rows(vectors, sq, cand_d_l, cand_i_l, wslots,
                          part_idx, *, deg, n_cand, metric, diversify):
    """Refinement rows: snapshot candidates only, self-excluded.

    Candidate distances are RE-SCORED at HIGHEST (_row_dist_dense)
    rather than trusting the descent pool's values: the descent runs at
    DEFAULT precision, optionally over the int8 blocks, so its distances
    order the pool but should not rank edge selection."""
    W = wslots.shape[0]
    safe_p = torch.clamp(part_idx, 0, W - 1).long()
    sc_i = cand_i_l[safe_p].to(torch.int32)
    self_slot = wslots[safe_p][:, None]
    anchors = torch.where(part_idx >= 0, wslots[safe_p].to(torch.int32), -1)
    sc_d = _row_dist_dense(vectors, sq, anchors, sc_i, metric)
    sc_d = torch.where((sc_i >= 0) & (sc_i != self_slot), sc_d, _INF)
    rows = _diverse_select_dev(sc_i, sc_d, vectors, sq, deg=deg,
                               metric=metric, diversify=diversify)
    return torch.where((part_idx >= 0)[:, None], rows, -1)


def _assemble_wave_rows(vectors, sq, cand_d_l, cand_i_l, intra_d,
                        wslots, part_idx, in_layer, *, deg, n_cand,
                        intra_k, metric, diversify):
    """Wave-node rows for one layer, fully on the device.

    cand_d_l/cand_i_l: [W, n_cand] snapshot candidates at this layer
    intra_d:           [W, W] intra-wave distances (diag INF)
    wslots:            [W] global slot per wave node
    part_idx:          [P] indices into the wave (-1 pad) participating
    in_layer:          [W] bool — wave nodes whose level >= layer
    Returns rows [P, deg] of global slots (-1 pad). Intra-wave
    candidates are the intra_k nearest in-layer wave nodes, ties to the
    lower wave index.
    """
    W = intra_d.shape[0]
    safe_p = torch.clamp(part_idx, 0, W - 1).long()
    sc_i = cand_i_l[safe_p].to(torch.int32)             # [P, n_cand]
    anchors = torch.where(part_idx >= 0, wslots[safe_p].to(torch.int32), -1)
    sc_d = _row_dist_dense(vectors, sq, anchors, sc_i, metric)
    sc_d = torch.where(sc_i >= 0, sc_d, _INF)
    iw = intra_d[safe_p]                                # [P, W]
    iw = torch.where(in_layer[None, :], iw, _INF)
    iw_d, cols = topk_smallest(iw, min(intra_k, W))     # [P, kk]
    iw_i = torch.where(iw_d < _INF, wslots[cols].to(torch.int32), -1)
    comb_i = torch.cat([sc_i, iw_i], dim=1)
    comb_d = torch.cat([sc_d, iw_d], dim=1).to(torch.float32)
    rows = _diverse_select_dev(comb_i, comb_d, vectors, sq, deg=deg,
                               metric=metric, diversify=diversify)
    return torch.where((part_idx >= 0)[:, None], rows, -1)


def _scatter_rows(nb_l: torch.Tensor, tgt_rows: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """In-place row write into a neighbor table. ``tgt_rows`` outside
    [0, nb_l.shape[0]) are skipped: callers flag rows to skip by pointing
    them past the table (the JAX package's scatter mode="drop"; torch
    would raise on them, and clamping would overwrite the last row).
    Targets must be distinct. Returns ``nb_l``."""
    ok = (tgt_rows >= 0) & (tgt_rows < nb_l.shape[0])
    nb_l[tgt_rows[ok].long()] = rows[ok].to(nb_l.dtype)
    return nb_l


def _reverse_update(nb_l, vectors, sq, tgt, src, *, deg, metric,
                    diversify=False, row_of=None):
    """Apply reverse edges (tgt <- src) to one layer's neighbor table, in
    place.

    nb_l: [rows_n, Wd] int32; tgt/src: [E] int32 SLOT ids (-1 pads
    skipped). Per target keeps the closest ``deg`` of (existing ∪
    incoming), ties to the existing row and then to the nearer-ranked
    incoming edge — or, with ``diversify``, re-selects the row with the
    Malkov neighbor-diversity heuristic (_diverse_select_dev).

    ``row_of`` ([cap] int32, optional) maps slot -> table row for the
    COMPACT upper-layer layout (DeviceGraph.upper_map): distances are
    computed in slot space, reads/writes of nb_l go through the map.
    None means rows are indexed by slot (layer 0).

    Incoming edges are ranked per target by a stable sort on distance
    and then a stable sort on target (the JAX package's lexsort), with
    group starts spread by cummax. Work scales with the edge count, not
    the table: only touched targets are gathered, in chunks of
    _REVERSE_CHUNK (distinct targets, so chunk order cannot matter).
    Returns ``nb_l``.
    """
    rows_n, Wd = nb_l.shape
    slot_hi = vectors.shape[0]                          # cap_pad
    E = tgt.shape[0]
    if E == 0:
        return nb_l
    dev = nb_l.device
    d = _row_dist_dense(vectors, sq, tgt, src[:, None], metric)[:, 0]
    key_t = torch.where(tgt >= 0, tgt, slot_hi)         # pads last
    o1 = torch.sort(d, stable=True).indices
    order = o1[torch.sort(key_t[o1], stable=True).indices]
    t_s = key_t[order]
    s_s = src[order].to(torch.int32)
    d_s = d[order]
    idx = torch.arange(E, device=dev)
    is_start = torch.ones(E, dtype=torch.bool, device=dev)
    is_start[1:] = t_s[1:] != t_s[:-1]
    start_idx = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - start_idx
    keep = (t_s < slot_hi) & (rank < deg) & (d_s < _INF)

    # incoming buffer for the touched targets only: group g of the sorted
    # edges is target uniq[g] (pads form the last group, past uniq)
    grp = torch.cumsum(is_start.to(torch.int64), dim=0) - 1
    uniq = t_s[is_start & (t_s < slot_hi)]
    U = uniq.shape[0]
    inc = torch.full((U, deg), -1, dtype=torch.int32, device=dev)
    inc[grp[keep], rank[keep]] = s_s[keep]

    for c0 in range(0, U, _REVERSE_CHUNK):
        anchors = uniq[c0:c0 + _REVERSE_CHUNK]
        rows_inc = inc[c0:c0 + _REVERSE_CHUNK]
        arow = anchors if row_of is None else row_of[anchors.long()]
        valid = arow >= 0
        safe = torch.clamp(arow, 0, rows_n - 1).long()
        rows_nb = nb_l[safe]                            # [A, Wd]
        comb = torch.cat([rows_nb, rows_inc], dim=1)
        anc = torch.where(valid, anchors, -1)
        comb_d = _row_dist_dense(vectors, sq, anc, comb, metric)
        # dedup incoming already present in the row
        dup = ((rows_inc[:, :, None] == rows_nb[:, None, :]).any(-1)
               & (rows_inc >= 0))
        comb_d[:, Wd:] = torch.where(dup, _INF, comb_d[:, Wd:])
        if diversify:
            new_rows = _diverse_select_dev(comb, comb_d, vectors, sq,
                                           deg=deg, metric=metric,
                                           diversify=True)
        else:
            top_d, pos = topk_smallest(comb_d, deg)
            new_rows = torch.where(top_d < _INF, torch.gather(comb, 1, pos),
                                   -1)
        if Wd > new_rows.shape[1]:
            new_rows = torch.nn.functional.pad(
                new_rows, (0, Wd - new_rows.shape[1]), value=-1)
        _scatter_rows(nb_l, torch.where(valid, arow, rows_n), new_rows)
    return nb_l


def _sparse_sync(host: host_build.HostGraph, nb0_dev, nbU_tabs,
                 ups: np.ndarray, u_counts, ncap: int) -> None:
    """Device -> host copy of the neighbor state: dense layer 0, occupied
    uppers.

    With the COMPACT level-ranked layout the occupied rows of layer l
    are exactly the table prefix [0, U_l), so each layer is one
    contiguous prefix copy.

    ``nb0_dev`` [cap_pad, Wd] is layer 0; ``nbU_tabs`` is the list of
    [U_l_pad, m] upper tables (None when the graph has one layer);
    ``ups`` maps compact rank -> slot; ``u_counts[l-1]`` is the
    occupancy of layer l.
    """
    L_all = host.neighbors.shape[0]
    host.neighbors[0][:ncap] = nb0_dev[:ncap].cpu().numpy()
    for lyr in range(1, L_all):
        host.neighbors[lyr][:ncap] = -1
        u_l = u_counts[lyr - 1] if nbU_tabs is not None else 0
        if not u_l:
            continue
        sel = nbU_tabs[lyr - 1][:u_l].cpu().numpy()      # [U_l, m_up]
        rows = ups[:u_l]
        m_up = sel.shape[1]
        host.neighbors[lyr][rows, :m_up] = sel
        host.neighbors[lyr][rows, m_up:] = -1


def _compact_upper_tables(host: host_build.HostGraph, lv_all: np.ndarray,
                          cap_pad: int, L_all: int, m_up: int, device):
    """Build the COMPACT upper tables (DeviceGraph.nbr_upper / upper_map)
    from final node levels on ``device``: upper nodes ranked by
    DESCENDING level so layer l occupies the prefix [0, U_l) of its
    right-sized table. Returns (ups, u_counts, nbU_tabs, umap_dev);
    tabs/map are None for single-layer graphs."""
    ups = np.flatnonzero(lv_all >= 1)
    ups = ups[np.argsort(-lv_all[ups], kind="stable")]
    umap = np.full(cap_pad, -1, np.int32)
    umap[ups] = np.arange(len(ups), dtype=np.int32)
    u_counts = [int((lv_all >= lyr).sum()) for lyr in range(1, L_all)]
    nbU_tabs = umap_dev = None
    if L_all > 1:
        nbU_tabs = []
        for lyr in range(1, L_all):
            u_l = u_counts[lyr - 1]
            occ = (np.ascontiguousarray(host.neighbors[lyr][ups[:u_l], :m_up])
                   if u_l else np.zeros((0, m_up), np.int32))
            nbU_tabs.append(upload(occ, -1, (bucket_pow2(max(u_l, 1), 8),
                                             m_up), device))
        umap_dev = upload(umap, -1, (cap_pad,), device)
    return ups, u_counts, nbU_tabs, umap_dev


class BuildDeadlineExceeded(RuntimeError):
    """A deadline-bounded build stopped early AFTER syncing its host
    state (and saving a resumable checkpoint when one was wired). The
    graph is partially built (pending nodes have level < 0); finish it
    with ``Graph.resume_build(checkpoint_path)``, or serve the inserted
    prefix with ``Graph.mask_pending_for_serve()``."""


def _device_tables(host, store, ncap, cap_pad, device, vec_dtype,
                   lv_all, quant_descent, block_m, metric):
    """The build's device state: vectors, squared norms, layer 0, the
    compact upper tables, levels, and (``quant_descent``) the int8
    traversal copy with its global scale."""
    Wd = host.neighbors.shape[2]
    L_all = host.neighbors.shape[0]
    vectors_dev = upload(store.vectors[:ncap], 0, (cap_pad, store.dim),
                         device, vec_dtype)
    sq_dev = upload(store.sq_norms[:ncap], 0, (cap_pad,), device)
    nb0_dev = upload(host.neighbors[0], -1, (cap_pad, Wd), device)
    ups, u_counts, nbU_tabs, umap_dev = _compact_upper_tables(
        host, lv_all, cap_pad, L_all, host.cfg.m, device)
    levels_dev = upload(host.levels[:ncap], -1, (cap_pad,), device)
    quant = None
    if quant_descent and registered(metric) is None:
        gs = float(np.abs(store.vectors[:ncap]).max()) / 127.0 or 1.0
        qh = np.clip(np.rint(store.vectors[:ncap] / gs),
                     -127, 127).astype(np.int8)
        if block_m is None and cap_pad * Wd * store.dim > 5 * 1024 ** 3:
            # the JAX package's guard for a 16 GB TPU chip, kept for
            # parity: full blocks over ~5 GB are halved, then cut to 8
            block_m = max(8, Wd // 2)
            if cap_pad * block_m * store.dim > 5 * 1024 ** 3:
                block_m = 8
        quant = dict(qvec=upload(qh, 0, (cap_pad, store.dim), device),
                     qscale=torch.full((cap_pad,), gs, dtype=torch.float32,
                                       device=device),
                     block_scale=torch.tensor(np.float32(gs), device=device),
                     block_m=block_m)
    return (vectors_dev, sq_dev, nb0_dev, ups, u_counts, nbU_tabs, umap_dev,
            levels_dev, quant)


def _descent_graph(vectors_dev, sq_dev, nb0_dev, levels_dev, entry,
                   nbU_tabs, umap_dev, quant) -> DeviceGraph:
    """The DeviceGraph a wave's descent reads: views of the build's
    tables (``nb0_dev[None]`` is a view, not a copy), plus fresh int8
    neighbor blocks of the current layer 0 under quant_descent."""
    blocks = {}
    if quant is not None:
        blocks = dict(qvec=quant["qvec"], qscale=quant["qscale"],
                      block_scale=quant["block_scale"],
                      nbr_blocks=_gather_blocks(quant["qvec"], nb0_dev,
                                                block_m=quant["block_m"]))
    return DeviceGraph(
        vectors=vectors_dev, sq_norms=sq_dev, neighbors=nb0_dev[None],
        levels=levels_dev, alive=levels_dev >= 0,
        entry=torch.tensor(entry, dtype=torch.int32,
                           device=vectors_dev.device),
        nbr_upper=tuple(nbU_tabs) if nbU_tabs is not None else None,
        upper_map=umap_dev, **blocks)


def _update_layer(layer, rows, tgt_slots, deg, nb0_dev, nbU_tabs,
                  umap_dev, vectors_dev, sq_dev, metric, reverse_diversify):
    """Write a layer's new rows for ``tgt_slots`` and apply their reverse
    edges, in place (layer 0 by slot, upper layers through the compact
    map)."""
    if layer == 0:
        nb_l, tgt_rows = nb0_dev, tgt_slots
    else:
        nb_l = nbU_tabs[layer - 1]
        tr = umap_dev[tgt_slots.long()]
        tgt_rows = torch.where(tr >= 0, tr, nb_l.shape[0])
    w = rows.shape[1]      # deg, or fewer when the slate is narrower
    _scatter_rows(nb_l, tgt_rows,
                  torch.nn.functional.pad(rows, (0, nb_l.shape[1] - w),
                                          value=-1))
    rev_t = rows.reshape(-1)
    rev_s = torch.where(rev_t >= 0, tgt_slots.to(torch.int32)
                        .repeat_interleave(w), -1)
    _reverse_update(nb_l, vectors_dev, sq_dev, rev_t, rev_s, deg=deg,
                    metric=metric, diversify=reverse_diversify,
                    row_of=None if layer == 0 else umap_dev)


def sample_levels(host: host_build.HostGraph, n_new: int) -> np.ndarray:
    """Insertion levels of the next ``n_new`` nodes, from ONE
    ``host.rng.random(n_new)`` draw (the JAX package's vectorized
    sampler, so the same seed gives the same levels).

    The sequential law (graph.go:370-417) is `while lvl < cap and
    rng() <= ml: lvl += 1`, i.e. P(lvl >= k) = ml^k capped at max_level
    of the graph size at insertion time; floor(log u / log ml) for one
    uniform u has exactly that tail."""
    cfg = host.cfg
    counts = host.count + np.arange(n_new, dtype=np.int64)
    inv = math.log(1.0 / cfg.ml)
    cap_lvl = np.where(
        counts == 0, 1,
        np.round(np.log(np.maximum(counts, 1)) / inv).astype(np.int64) + 1)
    u = np.maximum(host.rng.random(n_new), 1e-300)
    geom = np.floor(np.log(u) / math.log(cfg.ml)).astype(np.int64)
    return np.minimum(geom, cap_lvl).astype(np.int32)


def bulk_insert_device(host: host_build.HostGraph, slots: np.ndarray, *,
                       wave: int = 2048,
                       intra_k: Optional[int] = None,
                       quant_descent: bool = False,
                       block_m: Optional[int] = None,
                       descent_dtype: str = "float32",
                       on_checkpoint=None,
                       checkpoint_every: int = 0,
                       abort_deadline: Optional[float] = None,
                       device=None) -> None:
    """Device-resident wave insertion on ``device``; syncs host arrays
    once at the end.

    ``quant_descent`` gives the construction descent the int8
    neighbor-BLOCK layout: per wave, layer-0 blocks are rebuilt by one
    device gather from a globally scaled int8 copy of the store, so each
    descent hop gathers one contiguous [M0, D] block per expanded node
    instead of M0 scattered rows. ``block_m`` narrows the blocks to the
    first block_m edges of each row. Edge SELECTION still scores f32 at
    HIGHEST, so only the candidate pool ordering sees quantization noise.

    ``on_checkpoint(inserted)`` + ``checkpoint_every=K`` snapshot the
    build every K waves: device levels/neighbors sync to the host
    arrays, then the callback persists them (Graph.build wires it to
    io.codec.save_graph), so a killed build loses at most K waves
    (Graph.resume_build).

    ``abort_deadline`` (absolute ``time.time()`` seconds) stops the
    build at the first wave boundary past the deadline: sync host
    arrays, write a checkpoint (if wired), then raise
    BuildDeadlineExceeded.

    ``descent_dtype="float16"`` keeps the device vector table in fp16 —
    half the table bytes and half the descent's row-gather bytes. Every
    scoring op upcasts to f32 and the fp16 hop scores at HIGHEST
    (core/search._score_hop), so only the one-time fp16 rounding of the
    stored components is lost.
    """
    cfg = host.cfg
    metric = canonical_metric(host.metric)
    intra_k = intra_k if intra_k is not None else cfg.m_base
    store = host.store
    device = torch.device(device) if device is not None \
        else default_device()
    # The intra-wave kNN is a dense [W, W] f32 matrix: the JAX package
    # caps W at 16384 (1 GB) for a 16 GB TPU chip; kept for parity.
    if wave > 16384:
        warnings.warn(f"wave={wave} clamped to 16384 (intra-wave kNN "
                      f"is O(W^2) device memory)", RuntimeWarning)
        wave = 16384

    slots = np.asarray(slots, np.int64)
    n_new = len(slots)
    if n_new == 0:
        return
    levels = sample_levels(host, n_new)

    start = 0
    if host.entry < 0:
        host._ensure(int(slots[0]), int(levels[0]))
        host.levels[slots[0]] = levels[0]
        host.count += 1
        host.entry, host.top = int(slots[0]), int(levels[0])
        start = 1

    host._ensure(int(slots.max()), int(levels.max()))
    ncap = host.neighbors.shape[1]
    store.ensure_capacity(ncap)
    cap_pad = bucket_pow2(ncap)
    L_all = host.neighbors.shape[0]

    # Every node's final level is known here (existing graph + the wave
    # levels just sampled), so the compact upper assignment is fixed for
    # the whole build.
    lv_all = np.full(cap_pad, -1, np.int32)
    lv_all[:ncap] = host.levels[:ncap]
    lv_all[slots] = levels
    (vectors_dev, sq_dev, nb0_dev, ups, u_counts, nbU_tabs, umap_dev,
     levels_dev, quant) = _device_tables(
        host, store, ncap, cap_pad, device,
        torch.float16 if descent_dtype == "float16" else torch.float32,
        lv_all, quant_descent, block_m, metric)

    n_cand = min(cfg.ef_construction, 2 * cfg.m_base)
    hb = BuildHeartbeat(n_new, "device build")
    waves_done = 0
    w0 = start
    while w0 < n_new:
        # one wave: its descent, each layer's selection (K4) and reverse
        # update, and the commit; spans only, no synchronisation
        with span("build.wave"):
            # ramp: a wave may be up to 4x the current graph size (the
            # intra-wave kNN carries within-wave edges; refine() recovers
            # any residual early-wave quality)
            cur_wave = min(wave, max(512, bucket_pow2(4 * host.count)))
            w1 = min(w0 + cur_wave, n_new)
            wslots = slots[w0:w1]
            wlevels = levels[w0:w1]
            W = len(wslots)
            wsl_dev = torch.from_numpy(wslots.astype(np.int32)).to(device)

            with span("build.descent"):
                g = _descent_graph(vectors_dev, sq_dev, nb0_dev, levels_dev,
                                   host.entry, nbU_tabs, umap_dev, quant)
                wq = vectors_dev[wsl_dev.long()]
                cand_d, cand_i = construction_descent(  # [L_all, W, n_cand]
                    g, wq, ef=max(cfg.ef_construction, n_cand),
                    m_out=n_cand, metric=metric, max_hops=cfg.max_hops)
                del g   # its neighbor blocks are the largest transient

            # HIGHEST so intra-wave distances rank consistently against the
            # f32-rescored snapshot candidates in _assemble_wave_rows
            intra = pairwise_dist(wq, wq, metric=metric, precision=HIGHEST)
            intra.fill_diagonal_(_INF)

            max_l = int(max(wlevels.max(initial=0), host.top))
            for layer in range(0, min(max_l, L_all - 1) + 1):
                part = np.flatnonzero(wlevels >= layer)
                if len(part) == 0:
                    continue
                deg = cfg.max_degree(layer)
                part_dev = torch.from_numpy(part.astype(np.int32)).to(device)
                in_layer = torch.from_numpy(wlevels >= layer).to(device)
                with span("build.select"):
                    rows = _assemble_wave_rows(
                        vectors_dev, sq_dev, cand_d[layer], cand_i[layer],
                        intra, wsl_dev, part_dev, in_layer, deg=deg,
                        n_cand=n_cand, intra_k=intra_k, metric=metric,
                        diversify=cfg.diversify)            # [P, deg]
                with span("build.update"):
                    _update_layer(layer, rows, wsl_dev[part_dev.long()], deg,
                                  nb0_dev, nbU_tabs, umap_dev, vectors_dev,
                                  sq_dev, metric, cfg.reverse_diversify)

            with span("build.commit"):
                levels_dev[wsl_dev.long()] = \
                    torch.from_numpy(wlevels).to(device)
                host.count += W
                wmax = int(wlevels.max())
                if wmax > host.top:
                    host.top = wmax
                    host.entry = int(wslots[int(np.argmax(wlevels))])
        w0 = w1
        waves_done += 1
        if hb.due():
            # the count must reflect completed device work
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            hb.emit(w0, extra=f" [wave +{W}]")
        deadline_hit = (abort_deadline is not None and w0 < n_new
                        and time.time() >= abort_deadline)
        if deadline_hit or (
                on_checkpoint is not None and checkpoint_every > 0
                and w0 < n_new and waves_done % checkpoint_every == 0):
            # mid-build host sync: levels mark exactly the inserted
            # prefix (-1 = pending); the device tables stay the build's
            # source of truth
            host.levels[:ncap] = levels_dev[:ncap].cpu().numpy()
            _sparse_sync(host, nb0_dev, nbU_tabs, ups, u_counts, ncap)
            if on_checkpoint is not None:
                on_checkpoint(int(w0))
                ck = getattr(on_checkpoint, "checkpoint_path", None)
                if ck:
                    hb.checkpoint(ck)
                elif not hb.silent:
                    hb.emit(w0, extra=" [checkpoint synced]")
        if deadline_hit:
            raise BuildDeadlineExceeded(
                f"build deadline reached after {w0}/{n_new} inserts; "
                f"host state synced"
                + (" and checkpoint saved" if on_checkpoint else "")
                + " — finish with Graph.resume_build")

    host.levels[:ncap] = levels_dev[:ncap].cpu().numpy()
    _sparse_sync(host, nb0_dev, nbU_tabs, ups, u_counts, ncap)


def _local_repair_wave(g: DeviceGraph, nb0_dev, vectors, sq, wsl, valid,
                       *, deg, n_cand, metric, hops, ef, diversify,
                       reverse_diversify):
    """One local-repair wave: seeded short beam -> layer-0 row
    re-selection -> reverse update, in place on ``nb0_dev``. See
    refine_device(local=True)."""
    cap_pad = nb0_dev.shape[0]
    wq = vectors[wsl.long()].to(torch.float32)
    q_sq = torch.sum(wq * wq, dim=-1)
    seeds = torch.cat([g.layer_neighbors(0)[wsl.long()],
                       g.entry.to(torch.int32).expand(wsl.shape[0])[:, None]],
                      dim=1)
    safe = torch.clamp(seeds, 0, g.cap - 1).long()
    sd = gathered_dist(wq, g.vectors[safe], g.sq_norms[safe], q_sq,
                       metric=metric, precision=DEFAULT)
    sd = torch.where((seeds >= 0) & (seeds != wsl[:, None]), sd, _INF)
    pd, pi = beam_search_layer(g, 0, wq, q_sq, seeds, sd, pool_size=ef,
                               max_hops=hops, metric=metric,
                               precision=DEFAULT, expand=4)
    part_idx = torch.where(valid, torch.arange(
        wsl.shape[0], dtype=torch.int32, device=wsl.device), -1)
    rows = _assemble_refine_rows(vectors, sq, pd[:, :n_cand],
                                 pi[:, :n_cand], wsl, part_idx,
                                 deg=deg, n_cand=n_cand, metric=metric,
                                 diversify=diversify)
    tgt = torch.where(valid, wsl, cap_pad).to(torch.int32)
    _scatter_rows(nb0_dev, tgt, torch.nn.functional.pad(
        rows, (0, nb0_dev.shape[1] - rows.shape[1]), value=-1))
    rev_t = rows.reshape(-1)
    rev_s = tgt.repeat_interleave(rows.shape[1])
    rev_t = torch.where((rev_t >= 0) & (rev_s < cap_pad), rev_t, -1)
    rev_s = torch.where(rev_t >= 0, rev_s, -1)
    return _reverse_update(nb0_dev, vectors, sq, rev_t, rev_s, deg=deg,
                           metric=metric, diversify=reverse_diversify)


def refine_device(host: host_build.HostGraph, *, wave: int = 2048,
                  slots=None, quant_descent: bool = False,
                  block_m: Optional[int] = None, local: bool = False,
                  local_hops: int = 3, device=None) -> None:
    """Second-pass graph refinement on ``device``.

    Re-runs the construction descent for every node against the FINAL
    graph and re-selects its edges (+ reverse edges). Wave construction
    gives early nodes edges chosen against small snapshots; one
    refinement pass re-chooses them with full information. Host arrays
    are synced once at the end.

    ``slots`` scopes the pass to a subset of nodes — the post-delete
    repair path (replenish alone leaves delete-heavy recall degraded;
    re-running the descent for the affected neighborhoods restores it).

    ``local=True`` is the cheap repair variant: each node's candidates
    come from a ``local_hops``-hop layer-0 beam SEEDED with its current
    neighbors (+ the entry as a connectivity fallback), and only layer-0
    edges are re-selected (upper-layer rows were already repaired by
    replenish, and re-selecting them from layer-0 candidates would break
    the layer-membership invariant).
    """
    cfg = host.cfg
    metric = canonical_metric(host.metric)
    store = host.store
    device = torch.device(device) if device is not None \
        else default_device()
    if slots is None:
        alive_slots = np.flatnonzero(host.levels >= 0)
    else:
        slots = np.unique(np.asarray(slots, np.int64))
        alive_slots = slots[host.levels[slots] >= 0]
    if len(alive_slots) == 0:
        return
    ncap = host.neighbors.shape[1]
    store.ensure_capacity(ncap)
    cap_pad = bucket_pow2(ncap)
    L_all = host.neighbors.shape[0]
    # levels are fixed during refinement: the level-ranked compact
    # assignment comes straight from the host levels
    lv_all = np.full(cap_pad, -1, np.int32)
    lv_all[:ncap] = host.levels[:ncap]
    (vectors_dev, sq_dev, nb0_dev, ups, u_counts, nbU_tabs, umap_dev,
     levels_dev, quant) = _device_tables(
        host, store, ncap, cap_pad, device, torch.float32, lv_all,
        quant_descent, block_m, metric)
    n_cand = min(cfg.ef_construction, 2 * cfg.m_base)
    ef = max(cfg.ef_construction, n_cand)

    for w0 in range(0, len(alive_slots), wave):
        wslots = alive_slots[w0:w0 + wave]
        wlevels = host.levels[wslots]
        wsl_dev = torch.from_numpy(wslots.astype(np.int32)).to(device)
        g = _descent_graph(vectors_dev, sq_dev, nb0_dev, levels_dev,
                           host.entry, nbU_tabs, umap_dev, quant)
        if local:
            _local_repair_wave(
                g, nb0_dev, vectors_dev, sq_dev, wsl_dev,
                torch.ones(len(wslots), dtype=torch.bool, device=device),
                deg=cfg.max_degree(0), n_cand=n_cand, metric=metric,
                hops=local_hops, ef=ef, diversify=cfg.diversify,
                reverse_diversify=cfg.reverse_diversify)
            continue
        cand_d, cand_i = construction_descent(
            g, vectors_dev[wsl_dev.long()], ef=ef, m_out=n_cand,
            metric=metric, max_hops=cfg.max_hops)
        del g

        max_l = int(wlevels.max(initial=0))
        for layer in range(0, min(max_l, L_all - 1) + 1):
            part = np.flatnonzero(wlevels >= layer)
            if len(part) == 0:
                continue
            deg = cfg.max_degree(layer)
            part_dev = torch.from_numpy(part.astype(np.int32)).to(device)
            rows = _assemble_refine_rows(
                vectors_dev, sq_dev, cand_d[layer], cand_i[layer],
                wsl_dev, part_dev, deg=deg, n_cand=n_cand, metric=metric,
                diversify=cfg.diversify)
            _update_layer(layer, rows, wsl_dev[part_dev.long()], deg,
                          nb0_dev, nbU_tabs, umap_dev, vectors_dev, sq_dev,
                          metric, cfg.reverse_diversify)

    _sparse_sync(host, nb0_dev, nbU_tabs, ups, u_counts, ncap)
