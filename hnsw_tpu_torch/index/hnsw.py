"""Keyed HNSW graph (port of hnsw_tpu/index/hnsw.py).

Public API mirrors the reference ``Graph[K]``
(graph.go:437,534,631,843,869,898,942,1047,1116,1382): add / batch_add /
build / search / batch_search / delete / batch_delete / lookup /
parallel_search / validate, plus negative-example variants.

Split of responsibilities:
  host   — key<->slot mapping, sequential mutation semantics and the
           native C++ sequential builder (core/host_build.HostGraph),
           negative-example re-scoring, the capacity modes' f32 rerank
  device — batched query traffic (core/search.search_graph) on padded
           tensors in the serving layout the modes pick (f32/fp16/bf16
           store, int8 traversal store, neighbor blocks, compact upper
           layers; small batches go to the native host engine), and the
           wave builder (core/build_device: ``build(method="device")``,
           ``refine``, ``batch_delete(refine=True)``), both on the
           graph's ``device``
"""

from __future__ import annotations

import functools
import time
from typing import Any, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import GraphConfig, canonical_dtype, \
    canonical_metric
from hnsw_tpu_torch.core import host_build
from hnsw_tpu_torch.core.search import (hop_maxima, pivot_seeds,
                                        results_to_host, search_graph)
from hnsw_tpu_torch.core.state import (DeviceGraph, _int8_block_fit,
                                       bucket_pow2, from_host)
from hnsw_tpu_torch.index.exact import default_device
from hnsw_tpu_torch.ops.distance import (INF_DIST, np_gram_epilogue,
                                         np_pairwise_dist, registered)
from hnsw_tpu_torch.utils.keystore import HostVectorStore, SlotMap
from hnsw_tpu_torch.utils.profiling import annotate, span
from hnsw_tpu_torch.utils.rwlock import RWLock


def _writes(fn):
    """Mutation: exclusive hold on the graph's RWLock (graph.go:328's
    ``g.mu.Lock()``). Re-entrant. The span ``hnsw.lock`` covers taking
    the hold, not holding it."""
    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with span("hnsw.lock"):
            self._rw.acquire_write()
        try:
            return fn(self, *a, **kw)
        finally:
            self._rw.release_write()
    return wrapper


def _reads(fn):
    """Query/read path: shared hold (graph.go:328's ``g.mu.RLock()``).
    Lazily built serving caches (device graph, pivots) are written under
    the read hold: assignment is GIL-atomic and rebuilding twice is
    idempotent. The span ``hnsw.lock`` covers taking the hold, not
    holding it."""
    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with span("hnsw.lock"):
            self._rw.acquire_read()
        try:
            return fn(self, *a, **kw)
        finally:
            self._rw.release_read()
    return wrapper


def _route(method: str, n: int) -> str:
    """Resolve build method "auto": the native sequential builder up to
    1,000,000 vectors when it is available, the device wave builder
    above."""
    if method != "auto":
        return method
    from hnsw_tpu_torch import native
    return "host" if native.available() and n <= 1_000_000 else "device"


class Graph:
    """HNSW index over arbitrary hashable keys, served with PyTorch."""

    def __init__(self, m: int = 16, ml: float = 0.25, ef_search: int = 20,
                 metric: str = "cosine", seed: int = 0,
                 ef_construction: int = 100,
                 config: Optional[GraphConfig] = None,
                 store=None, device=None):
        self.cfg = config or GraphConfig(m=m, ml=ml, ef_search=ef_search,
                                         metric=metric, seed=seed,
                                         ef_construction=ef_construction)
        self.cfg.validate()
        self.metric = canonical_metric(self.cfg.metric)
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.slots = SlotMap()
        #: vector storage — RAM by default; the capacity modes rerank
        #: against it on the host
        self.store = store if store is not None else HostVectorStore()
        self.host = host_build.HostGraph(self.cfg, self.store)
        self._dev: Optional[DeviceGraph] = None
        self._dirty = True
        #: bf16 traversal matmuls + f32 rerank of the pool head
        self.fast_math = False
        self._hbm_mode = "full"
        self._entry_mode = "descent"
        self._block_layout = False
        self._block_m: Optional[int] = None
        self._block_dtype = "auto"
        self._block_fit_cache = None      # (resolved_dtype, n_at_check)
        self._mut_since_fit = 0           # vectors changed since check
        self._pivot_cache = None
        self._pivot_host_cache = None
        #: seeds per query when entry_mode == "pivots"
        self.seed_width = 16
        #: pivot-count cap (subset scanned by the entry matmul)
        self.max_pivots = 4096
        #: per-hop pool update: "bitonic" (sorted-pool merge network) or
        #: "sort" (full stable sort)
        self.merge_strategy = "bitonic"
        #: split device neighbor storage: "auto" keeps the dense
        #: [L, cap, M0] stack up to 1 GB and switches to compact upper
        #: layers above; True (dense split) / "compact" / False force it
        self.split_layers: "bool | str" = "auto"
        #: LATENCY tier: batches up to this size are served by the native
        #: C++ engine on the host graph arrays, with no device round trip.
        #: 0 disables the native tier.
        self.native_serve_max_batch = 32
        #: the last device search's hop counts: a list, one per layer,
        #: top first, or K5's [layers, B] counts on the host
        self._last_hops = []
        self._ef_calib: dict = {}     # (k, target) -> {ef, recall, n}
        self._ef_default: Optional[int] = None
        self._rw = RWLock()

    @property
    def last_search_hops(self) -> List[int]:
        """Hop counts of the last device search, one per layer, top first:
        each layer's largest, taken from K5's counts a query when read."""
        h = self._last_hops
        return h if isinstance(h, list) else hop_maxima(h)

    @property
    def ef_search(self) -> int:
        """Default search ef — ``cfg.ef_search`` unless ``calibrate_ef``
        (or the setter) installed an override."""
        return self._ef_default if self._ef_default is not None \
            else self.cfg.ef_search

    @ef_search.setter
    def ef_search(self, ef: int) -> None:
        self._ef_default = int(ef)

    # -- serving modes ------------------------------------------------------
    @property
    def block_layout(self) -> bool:
        """Materialize layer-0 neighbor-vector blocks on the device: each
        hop gathers ONE contiguous [M0, D] block per expanded node instead
        of M0 scattered rows, at M0*D bytes per node (int8) of device
        memory."""
        return self._block_layout

    @block_layout.setter
    def block_layout(self, on: bool) -> None:
        if on and registered(self.metric) is not None:
            raise ValueError("block_layout unsupported for custom metrics")
        if bool(on) != self._block_layout:
            self._block_layout = bool(on)
            self._dirty = True

    @property
    def block_m(self) -> Optional[int]:
        """Narrow the serving neighbor blocks to the first block_m edges
        per row (device-memory knob; None = full rows)."""
        return self._block_m

    @block_m.setter
    def block_m(self, m: Optional[int]) -> None:
        m = None if m is None else int(m)
        if m != self._block_m:
            self._block_m = m
            self._dirty = True

    @property
    def block_dtype(self) -> str:
        """Neighbor-block element type: "int8" (1 byte, global scale),
        "float16" (2 bytes — needed on tightly clustered data, where
        within-cluster separations drown in int8 noise), or "auto"
        (check int8's ranking fidelity and pick; default)."""
        return self._block_dtype

    @block_dtype.setter
    def block_dtype(self, dt: str) -> None:
        dt = canonical_dtype(dt, ("auto", "int8", "float16"),
                             "block_dtype")
        if dt != self._block_dtype:
            self._block_dtype = dt
            self._block_fit_cache = None
            self._dirty = True

    def _resolve_block_dtype(self, n: int) -> str:
        """Resolve "auto" once per data regime (re-checked when the index
        doubles or halves, or a quarter of it changed)."""
        if self._block_dtype != "auto" or not self._block_layout:
            return self._block_dtype
        c = self._block_fit_cache
        if (c is not None and c[1] <= 2 * n and n <= 2 * c[1]
                and self._mut_since_fit <= 0.25 * c[1]):
            return c[0]
        used = self.slots.capacity_used
        fit = (_int8_block_fit(self.store.vectors[:used],
                               metric=self.metric) if used else 1.0)
        dt = "int8" if fit >= 0.9 else "float16"
        self._block_fit_cache = (dt, max(n, 1))
        self._mut_since_fit = 0
        return dt

    @property
    def entry_mode(self) -> str:
        """How searches enter layer 0: "descent" (the classic upper-layer
        elevator, default) or "pivots" (one matmul over a ~N/4 pivot
        subset, at most ``max_pivots``, picks ``seed_width`` entry
        candidates per query and skips the upper layers)."""
        return self._entry_mode

    @entry_mode.setter
    def entry_mode(self, mode: str) -> None:
        if mode not in ("descent", "pivots"):
            raise ValueError(f"bad entry_mode {mode!r}")
        self._entry_mode = mode

    def _pivot_arrays(self):
        """(slot ids int32, f32 vectors, squared norms) of the pivots on
        the device; cleared whenever the device graph is rebuilt."""
        if self._pivot_cache is None:
            used = self.slots.capacity_used
            alive = np.flatnonzero(self.store.alive[:used])
            n_piv = int(min(self.max_pivots, max(1, len(alive) // 4)))
            stride = max(1, len(alive) // n_piv)
            sel = alive[::stride][:n_piv]
            dev = self.device
            self._pivot_cache = (
                torch.from_numpy(sel.astype(np.int32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    self.store.vectors[sel], np.float32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    self.store.sq_norms[sel])).to(dev))
        return self._pivot_cache

    @property
    def hbm_mode(self) -> str:
        """Device residency of the vector store.

        "full"      — f32 vectors on the device (default).
        "float16"   — fp16 traversal store + exact f32 host rerank of the
          pool head: half the memory and half the row-gather bytes, with
          enough mantissa to route through tightly clustered data.
        "quantized" — the device holds ONLY the int8 traversal store (and
          the graph); raw vectors stay in ``self.store`` and the pool head
          is reranked on the host.
        """
        return self._hbm_mode

    @hbm_mode.setter
    def hbm_mode(self, mode: str) -> None:
        mode = canonical_dtype(mode, ("full", "float16", "quantized"),
                               "hbm_mode")
        if mode != "full" and registered(self.metric) is not None:
            raise ValueError(
                f"hbm_mode={mode!r} unsupported for custom metrics "
                "(the host rerank scores built-in metrics only)")
        if mode != self._hbm_mode:
            self._hbm_mode = mode
            self._dirty = True

    # -- invariants (graph.go:916-937) ----------------------------------------
    def validate(self) -> None:
        self.cfg.validate()

    def __len__(self) -> int:
        return len(self.slots)

    def dims(self) -> int:
        return self.store.dim or 0

    # -- mutation ---------------------------------------------------------
    @_writes
    def add(self, key: Hashable, vector) -> None:
        """Insert one node; replaces an existing node with the same key
        (graph.go:437)."""
        vec = np.asarray(vector, np.float32)
        if key in self.slots:
            self.delete(key)
        slot, _ = self.slots.assign(key)
        self.store.put(slot, vec)
        self.host.insert_many([slot])
        self._mut_since_fit += 1
        self._dirty = True

    @_writes
    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        """Bulk insert (graph.go:942 BatchAdd semantics — sequential,
        duplicate keys replaced)."""
        vectors = np.asarray(vectors, np.float32)
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        if len(set(keys)) != len(keys):
            # duplicate-in-batch: sequential last-wins (graph.go:1016-1023)
            for k, v in zip(keys, vectors):
                self.add(k, v)
            return
        for k in keys:
            if k in self.slots:
                self.delete(k)
        slot_list = [self.slots.assign(k)[0] for k in keys]
        self.store.put_batch(np.asarray(slot_list, np.int64), vectors)
        self.host.insert_many(slot_list)
        self._mut_since_fit += len(slot_list)
        self._dirty = True

    @_writes
    def build(self, keys: Sequence[Hashable], vectors,
              wave: int = 1024, method: str = "auto",
              quant_descent: bool = False,
              block_m: Optional[int] = None,
              descent_dtype: str = "float32",
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 128,
              abort_deadline: Optional[float] = None) -> None:
        """Bulk construction. Existing keys are replaced; duplicate keys
        within the batch are an error.

        method:
          "device" — the wave builder on the graph's device
                     (core/build_device.bulk_insert_device)
          "host"   — the native C++ sequential builder
          "auto"   — host up to 1,000,000 vectors (when the native
                     engine is available), device above

        ``wave`` is the device builder's wave width (clamped to 16384);
        the host builder inserts in slices of ``checkpoint_every * wave``
        nodes when it checkpoints or has a deadline.

        ``quant_descent`` runs the device builder's descent over int8
        layer-0 neighbor blocks, narrowed to the first ``block_m`` edges
        of each row (None = full rows, auto-narrowed when full blocks
        would pass ~5 GB). ``descent_dtype="float16"`` keeps its device
        vector table in fp16. Edge selection scores f32 either way.

        ``checkpoint_path`` makes a build RESTARTABLE: every
        ``checkpoint_every`` waves (host: slices) the build syncs its
        state to the host arrays and atomically saves a full checkpoint
        (io.codec.save_graph), and the finished graph is saved there
        too. Resume with ``Graph.resume_build(checkpoint_path, ...)``.

        ``abort_deadline`` (absolute time.time()) bounds a build by wall
        clock: past it, the build syncs, checkpoints (when a path is
        given) and raises core.build_device.BuildDeadlineExceeded, whose
        ``graph`` attribute is this graph — ``mask_pending_for_serve``
        makes its inserted prefix servable.
        """
        descent_dtype = canonical_dtype(
            descent_dtype, ("float32", "float16"), "descent_dtype")
        if method not in ("auto", "host", "device"):
            raise ValueError(
                f"unknown build method {method!r}: auto|host|device")
        vectors = np.asarray(vectors, np.float32)
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        key_set = set(keys)
        if len(key_set) != len(keys):
            raise ValueError("duplicate keys in build batch")
        for k in (self.slots.key_to_slot.keys() & key_set):
            self.delete(k)
        slot_list = self.slots.assign_fresh_batch(list(keys))
        self.store.put_batch(slot_list, vectors)
        self._insert_stored(slot_list, _route(method, len(keys)), wave=wave,
                            quant_descent=quant_descent, block_m=block_m,
                            descent_dtype=descent_dtype,
                            checkpoint_path=checkpoint_path,
                            checkpoint_every=checkpoint_every,
                            abort_deadline=abort_deadline)
        if checkpoint_path is not None:
            from hnsw_tpu_torch.io import codec
            codec.save_graph(self, checkpoint_path)
        self._block_fit_cache = None   # bulk data change: re-check fit
        self._mut_since_fit = 0
        self._dirty = True

    def _insert_stored(self, slots, method: str, *, wave, quant_descent,
                       block_m, descent_dtype, checkpoint_path,
                       checkpoint_every, abort_deadline) -> None:
        """Insert slots whose vectors are already stored, by the "host" or
        "device" builder, with build()'s checkpoint and deadline
        contract."""
        from hnsw_tpu_torch.core.build_device import (BuildDeadlineExceeded,
                                                      bulk_insert_device)
        from hnsw_tpu_torch.io import codec
        if method == "host":
            sl = [int(s) for s in slots]
            step = (max(1, checkpoint_every) * max(1, wave)
                    if checkpoint_path is not None
                    or abort_deadline is not None else len(sl) or 1)
            for c0 in range(0, len(sl), step):
                self.host.insert_many(sl[c0:c0 + step])
                if c0 + step >= len(sl):
                    break
                if checkpoint_path is not None:
                    self._dirty = True
                    codec.save_graph(self, checkpoint_path)
                if abort_deadline is not None \
                        and time.time() >= abort_deadline:
                    hint = ("; resume with Graph.resume_build"
                            if checkpoint_path is not None else
                            " (no checkpoint_path: not resumable)")
                    err = BuildDeadlineExceeded(
                        f"host build deadline: {c0 + step}/{len(sl)}"
                        f" inserted{hint}")
                    err.graph = self   # servable partial prefix
                    raise err
            return
        on_ckpt = None
        if checkpoint_path is not None:
            def on_ckpt(done, _p=checkpoint_path):
                codec.save_graph(self, _p)
            on_ckpt.checkpoint_path = checkpoint_path
        try:
            bulk_insert_device(self.host, slots, wave=wave,
                               quant_descent=quant_descent,
                               block_m=block_m, descent_dtype=descent_dtype,
                               on_checkpoint=on_ckpt,
                               checkpoint_every=checkpoint_every,
                               abort_deadline=abort_deadline,
                               device=self.device)
        except BuildDeadlineExceeded as e:
            # host arrays were synced (and the checkpoint written) before
            # the raise: the caller can serve the inserted prefix
            e.graph = self
            raise

    @classmethod
    def resume_build(cls, checkpoint_path: str,
                     wave: int = 1024,
                     method: str = "device",
                     quant_descent: bool = False,
                     block_m: Optional[int] = None,
                     descent_dtype: str = "float32",
                     checkpoint_every: int = 128,
                     abort_deadline: Optional[float] = None,
                     device=None) -> "Graph":
        """Resume a crashed, killed or deadline-aborted
        ``build(checkpoint_path=...)`` into a Graph on ``device``
        (default: the CUDA device; raises without one, pass
        ``device="cpu"`` for the CPU).

        The checkpoint stores every assigned key + vector; nodes the
        build had not yet inserted are exactly those with level < 0.
        Loads the snapshot, inserts the pending slots only (fresh level
        sampling — same geometric law), and keeps checkpointing to the
        same path. ``method`` follows build(): "device" (default),
        "host" (native sequential), or "auto" (host while pending <=
        1M). Returns the completed Graph; a finished checkpoint simply
        loads. Checkpoints written by the JAX package resume here too.
        """
        if method not in ("auto", "host", "device"):
            raise ValueError(
                f"unknown build method {method!r}: auto|host|device")
        descent_dtype = canonical_dtype(
            descent_dtype, ("float32", "float16"), "descent_dtype")
        from hnsw_tpu_torch.io import codec
        g = codec.load_graph(checkpoint_path, device=device)
        assigned = np.fromiter(g.slots.key_to_slot.values(), np.int64,
                               len(g.slots.key_to_slot))
        pending = np.sort(assigned[g.host.levels[assigned] < 0])
        if len(pending):
            g._insert_stored(pending, _route(method, len(pending)),
                             wave=wave, quant_descent=quant_descent,
                             block_m=block_m, descent_dtype=descent_dtype,
                             checkpoint_path=checkpoint_path,
                             checkpoint_every=checkpoint_every,
                             abort_deadline=abort_deadline)
            codec.save_graph(g, checkpoint_path)
            g._block_fit_cache = None
            g._mut_since_fit = 0
            g._dirty = True
        return g

    def mask_pending_for_serve(self) -> int:
        """Make a deadline-aborted build's inserted PREFIX servable.

        A bulk build assigns every key a slot (and stores its vector) up
        front; ``BuildDeadlineExceeded`` leaves the never-inserted tail
        marked ``level < 0`` with no in-edges — graph traversal cannot
        reach it, but exact scans read ``store.alive``. Tombstone that
        tail IN MEMORY ONLY (the on-disk checkpoint keeps its level < 0
        markers, so ``Graph.resume_build`` can still finish later) and
        return the servable node count.
        """
        cap = min(len(self.store.alive) if self.store.alive is not None
                  else 0, len(self.host.levels))
        if cap:
            pending = self.host.levels[:cap] < 0
            if pending.any():
                self.store.alive[:cap] &= ~pending
                self._dirty = True
        return int(self.store.alive[:cap].sum()) if cap else 0

    @_writes
    def refine(self, wave: int = 2048, slots=None,
               local: bool = False) -> None:
        """Second-pass edge refinement against the final graph, on the
        graph's device — recovers the recall that batched wave
        construction loses on early nodes
        (core/build_device.refine_device). ``slots`` scopes the pass
        (post-delete repair); a scoped pass narrows the wave to the
        affected-set size (pow2, min 256). ``local`` re-selects layer-0
        rows from a short beam seeded with each node's neighbors."""
        from hnsw_tpu_torch.core.build_device import refine_device
        if slots is not None and len(slots):
            wave = min(wave, bucket_pow2(len(slots), 256))
        refine_device(self.host, wave=wave, slots=slots, local=local,
                      device=self.device)
        self._dirty = True

    @_writes
    def delete(self, key: Hashable) -> bool:
        """Remove a node and repair its neighborhood
        (graph.go:843 Delete + isolate/replenish)."""
        slot = self.slots.slot_of(key)
        if slot is None:
            return False
        self.host.delete_many([slot])
        self.store.kill(slot)
        self.slots.release(key)
        self._mut_since_fit += 1
        self._dirty = True
        return True

    @_writes
    def batch_delete(self, keys: Sequence[Hashable],
                     refine: bool = False) -> List[bool]:
        """graph.go:869 BatchDelete: per-key success flags; one in-edge
        sweep + repair pass for the whole batch.

        ``refine=True`` additionally re-selects the layer-0 edges of the
        neighborhoods the deletes touched (the nodes with an edge to a
        deleted one) with a local repair pass on the device, recovering
        the recall that replenish-only repair loses on delete-heavy
        workloads."""
        oks, slots = [], []
        for k in keys:
            s = self.slots.slot_of(k)
            if s is None:
                oks.append(False)
                continue
            oks.append(True)
            slots.append(s)
            self.store.kill(s)
            self.slots.release(k)
        if slots:
            affected = None
            if refine:
                dslots = np.asarray(slots, np.int64)
                touched = np.isin(self.host.neighbors, dslots).any(
                    axis=(0, 2))
                touched[dslots[dslots < len(touched)]] = False
                affected = np.flatnonzero(touched)
            self.host.delete_many(slots)
            self._mut_since_fit += len(slots)
            self._dirty = True
            if affected is not None and len(affected):
                self.refine(slots=affected, local=True)
        return oks

    @_reads
    def lookup(self, key: Hashable) -> Optional[np.ndarray]:
        """O(1) vector fetch (graph.go:898 Lookup)."""
        s = self.slots.slot_of(key)
        return None if s is None else np.array(self.store.get(s))

    # -- device sync ------------------------------------------------------
    @_reads
    def device_graph(self) -> DeviceGraph:
        if self._dirty or self._dev is None:
            self._pivot_cache = None
            # free the old layout before building the new one; the new one
            # is returned from the local, so a concurrent reader never
            # sees the None
            self._dev = None
            n = self.slots.capacity_used
            cap = bucket_pow2(max(n, 1), 8)
            nb, levels, entry, _ = self.host.arrays()
            use = min(nb.shape[1], cap)
            sd = self.cfg.store_dtype
            if self._hbm_mode == "float16":
                sd = "float16"
            vecs = (self.store.vectors[:use]
                    if self.store.vectors is not None
                    else np.zeros((0, 1), np.float32))
            sqs = (self.store.sq_norms[:use]
                   if self.store.sq_norms is not None
                   else np.zeros((0,), np.float32))
            if self.metric == "cosine" and vecs.size:
                # pre-normalized store: cosine distances are invariant,
                # and hops skip the per-candidate norm gather entirely
                vecs = vecs / np.sqrt(np.maximum(sqs, 1e-30))[:, None]
                sqs = np.ones_like(sqs)
            split = self.split_layers
            if split == "auto":
                # compact upper layers once the dense stack passes 1 GB
                dense_bytes = nb.shape[0] * cap * nb.shape[2] * 4
                split = "compact" if dense_bytes > (1 << 30) else False
            dev = from_host(
                vecs, sqs, nb[:, :use], levels[:use],
                (self.store.alive[:use] if self.store.alive is not None
                 else np.zeros((0,), bool)),
                entry, cap_pad=cap, store_dtype=sd,
                quantize=self._hbm_mode == "quantized",
                hbm_vectors=self._hbm_mode != "quantized",
                block_layout=self._block_layout,
                block_m=self.block_m,
                block_dtype=self._resolve_block_dtype(n),
                metric=self.metric,
                split_layers=split,
                upper_m=self.cfg.m,
                device=self.device)
            self._dev = dev
            self._dirty = False
            return dev
        return self._dev

    # -- search -----------------------------------------------------------
    @_reads
    @annotate("hnsw.search")
    def batch_search_slots(self, queries: np.ndarray, k: int,
                           ef: Optional[int] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        with span("hnsw.prepare"):
            if k <= 0:
                raise ValueError(f"k must be greater than 0, got {k}")
            queries = np.atleast_2d(np.asarray(queries, np.float32))
            nq = queries.shape[0]
            if len(self.slots) == 0:
                return (np.full((nq, k), INF_DIST, np.float32),
                        np.full((nq, k), -1, np.int64))
            self.store.ensure_dim(queries.shape[-1])
            ef = ef if ef is not None else self.ef_search
            native = 0 < nq <= self.native_serve_max_batch
            if not native:
                g, queries = self._device_batch(queries)
        if native:
            res = self._native_search(queries, k, ef)
            if res is not None:
                return res
            with span("hnsw.prepare"):
                g, queries = self._device_batch(queries)
        # no host sync before the results are read: a pageable copy that
        # PyTorch need not wait for (the CUDA runtime stages it at once)
        with span("hnsw.query_copy"):
            q = torch.from_numpy(queries).to(self.device, non_blocking=True)
        pool = max(ef, k)
        expand = self.cfg.search_expand
        hops = max(self.cfg.max_hops, -(-2 * pool // expand))
        seed_ids = None
        if self._entry_mode == "pivots":
            with span("hnsw.pivot_seeds"):
                pids, pvecs, psq = self._pivot_arrays()
                seed_ids = pivot_seeds(q, pvecs, psq, pids,
                                       s=min(self.seed_width, pool),
                                       metric=self.metric,
                                       fast_math=self.fast_math)
        # the results and the hop counts come off the card in one copy
        # (results_to_host), with no host sync before it on K5's path;
        # the hop counts are reduced only when last_search_hops is read
        stats: dict = {}
        kw = dict(ef=ef, metric=self.metric, max_hops=hops, expand=expand,
                  fast_math=self.fast_math, seed_ids=seed_ids,
                  merge=self.merge_strategy,
                  store_normalized=self.metric == "cosine", stats=stats)
        capacity = self._hbm_mode in ("quantized", "float16")
        # traversal-ordered pool head off the device; exact f32 rerank
        # on the host against the store
        R = min(max(2 * k, 32), max(pool, k)) if capacity else k
        out = search_graph(g, q, k=R, device_rerank=not capacity, **kw)
        with span("hnsw.results"):
            d, i = results_to_host(*out, stats, hops=False)
            self._last_hops = stats.get("hops", stats.get("hops_by_query"))
            if capacity:
                return self._host_rerank(queries[:nq], i[:nq], k)
            return d[:nq], i[:nq].astype(np.int64)

    def _device_batch(self, queries: np.ndarray
                      ) -> Tuple[DeviceGraph, np.ndarray]:
        """The device graph, and the batch padded to its bucket."""
        g = self.device_graph()
        nq = queries.shape[0]
        q_pad = bucket_pow2(nq)
        if q_pad != nq:
            queries = np.pad(queries, ((0, q_pad - nq), (0, 0)))
        return g, queries

    def _pivot_slots_host(self) -> np.ndarray:
        """Host-side pivot subset for the native engine's seeded entry:
        ~4*sqrt(N) stride-sampled live slots, cached on a (capacity,
        mutations) stamp."""
        stamp = (self.slots.capacity_used, self._mut_since_fit)
        c = self._pivot_host_cache
        if c is not None and c[0] == stamp:
            return c[1]
        used = stamp[0]
        alive = np.flatnonzero(self.store.alive[:used])
        n_piv = int(min(1024, max(16, 4.0 * np.sqrt(max(len(alive), 1)))))
        stride = max(1, len(alive) // n_piv)
        sel = np.ascontiguousarray(alive[::stride][:n_piv], np.int64)
        self._pivot_host_cache = (stamp, sel)
        return sel

    def _native_search(self, queries: np.ndarray, k: int, ef: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Serve a small batch from the native C++ engine over the host
        graph arrays (same HNSW semantics as the device path);
        entry_mode="pivots" carries over as a SIMD pivot scan seeding the
        layer-0 beam. Returns None when the library or metric is
        unsupported — callers fall through to the device path."""
        from hnsw_tpu_torch import native
        pivots = None
        if self._entry_mode == "pivots":
            pivots = self._pivot_slots_host()
        with span("hnsw.native_search"):
            res = native.search_batch(self.host, queries, k, ef,
                                      pivots=pivots,
                                      n_seed=min(self.seed_width, 8))
        if res is None:
            return None
        d, i = res
        return d.astype(np.float32, copy=False), \
            i.astype(np.int64, copy=False)

    def _host_rerank(self, queries: np.ndarray, cand: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact f32 rerank of per-query candidate slots against the host
        store (one batched fetch — the GetVectorsBatch role,
        parquet/vector_ops.go:321-432)."""
        from hnsw_tpu_torch.utils.rerank import host_rerank
        with span("hnsw.host_rerank"):
            return host_rerank(self.store, self.metric, queries, cand, k)

    @_reads
    def batch_search(self, queries, k: int, ef: Optional[int] = None
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        """graph.go:1047 BatchSearch: (keys [Q][k], dists [Q,k])."""
        d, i = self.batch_search_slots(queries, k, ef)
        with span("hnsw.keys"):
            keys = [self.slots.keys_for(row) for row in i]
        return keys, d

    # -- ef calibration ---------------------------------------------------
    def _host_oracle_slots(self, queries: np.ndarray, k: int,
                           chunk: int = 1 << 20) -> np.ndarray:
        """Exact top-k SLOT ids for ``queries`` via a chunked host BLAS
        scan of the live store — the calibration ground truth, valid in
        every mode."""
        cap = self.slots.capacity_used
        live = np.flatnonzero(self.store.alive[:cap])
        qf = np.atleast_2d(np.asarray(queries, np.float32))
        q_sq = np.sum(qf * qf, axis=-1)
        best_d = [np.empty((qf.shape[0], 0), np.float32)]
        best_i = [np.empty((qf.shape[0], 0), np.int64)]
        for lo in range(0, len(live), chunk):
            sl = live[lo:lo + chunk]
            rows = self.store.get_batch(sl).astype(np.float32)
            qv = qf @ rows.T
            c_sq = self.store.sq_norms[sl]
            d = np_gram_epilogue(qv, q_sq[:, None], c_sq[None, :],
                                 self.metric)
            kk = min(k, d.shape[1])
            part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
            best_d.append(np.take_along_axis(d, part, axis=1))
            best_i.append(sl[part])
        d_all = np.concatenate(best_d, axis=1)
        i_all = np.concatenate(best_i, axis=1)
        kk = min(k, d_all.shape[1])
        part = np.argpartition(d_all, kk - 1, axis=1)[:, :kk]
        return np.take_along_axis(i_all, part, axis=1)

    @_reads
    def calibrate_ef(self, target_recall: float, k: int = 10,
                     sample: int = 64, seed: int = 0,
                     ladder: Sequence[int] = (20, 40, 64, 96, 128, 192,
                                              256, 384, 512, 768, 1024),
                     probe_queries=None) -> Tuple[int, float]:
        """Self-tuning ef: install the smallest ``ef`` of ``ladder`` whose
        measured recall@k against the exact host oracle meets
        ``target_recall`` as the default ``ef_search``, and return
        ``(ef, measured_recall)``. If no rung meets the target, the
        best-measured one is installed.

        Probes are ``probe_queries`` (a sample of the real workload, when
        there is one) or off-node 0.85/0.15 mixes of two live members.
        Results are cached per (k, target) and reused while the graph
        stays within 25% of the size they were measured at (not when
        ``probe_queries`` is given).
        """
        if not ladder:
            raise ValueError("ladder must be non-empty")
        key = (int(k), round(float(target_recall), 3))
        n_now = len(self)
        cached = self._ef_calib.get(key)
        if probe_queries is None and cached is not None \
                and cached["n"] > 0 \
                and abs(n_now - cached["n"]) <= 0.25 * cached["n"]:
            self.ef_search = cached["ef"]
            return cached["ef"], cached["recall"]
        cap = self.slots.capacity_used
        live = np.flatnonzero(self.store.alive[:cap])
        if len(live) == 0:
            return self.ef_search, 1.0
        rng = np.random.default_rng(seed)
        if probe_queries is not None:
            queries = np.atleast_2d(
                np.asarray(probe_queries, np.float32))[:sample]
        else:
            probe = rng.choice(live, size=min(sample, len(live)),
                               replace=False)
            mix = rng.choice(live, size=len(probe))
            bad = mix == probe
            if bad.any() and len(live) > 1:
                pos = {int(v): i for i, v in enumerate(live)}
                mix[bad] = live[(np.array([pos[int(v)]
                                           for v in probe[bad]]) + 1)
                                % len(live)]
            queries = (0.85 * self.store.get_batch(probe)
                       .astype(np.float32)
                       + 0.15 * self.store.get_batch(mix)
                       .astype(np.float32))
        gt = self._host_oracle_slots(queries, k)
        gts = [set(map(int, row)) for row in gt]
        total = sum(len(s) for s in gts) or 1
        best_ef, best_rec = None, -1.0
        for ef in sorted({max(int(e), k) for e in ladder}):
            _, ii = self.batch_search_slots(queries, k, ef=ef)
            hits = sum(len({int(s) for s in row if s >= 0} & gts[qi])
                       for qi, row in enumerate(ii))
            rec = hits / total
            if rec > best_rec:
                best_ef, best_rec = ef, rec
            if rec >= target_recall:
                best_ef, best_rec = ef, rec
                break
        self._ef_calib[key] = {"ef": best_ef, "recall": best_rec,
                               "n": n_now}
        self.ef_search = best_ef
        return best_ef, best_rec

    def calibration_state(self) -> dict:
        """JSON-able snapshot of calibrate_ef's results and the installed
        default, so a reopened index need not re-pay the oracle scan.
        Entries carry the index size they were measured at."""
        return {
            "ef_calib": [[kk, tt, c["ef"], c["recall"], c["n"]]
                         for (kk, tt), c in self._ef_calib.items()],
            "ef_default": self._ef_default,
        }

    def restore_calibration(self, state: Optional[dict]) -> None:
        """Inverse of calibration_state (no-op on None/empty)."""
        if not state:
            return
        for kk, tt, ef, rec, n in state.get("ef_calib", []):
            self._ef_calib[(int(kk), round(float(tt), 3))] = {
                "ef": int(ef), "recall": float(rec), "n": int(n)}
        if state.get("ef_default") is not None:
            self._ef_default = int(state["ef_default"])

    @_reads
    def search(self, query, k: int, ef: Optional[int] = None
               ) -> List[Tuple[Any, float]]:
        """graph.go:534 Search: [(key, dist)] best-first."""
        d, i = self.batch_search_slots(np.asarray(query, np.float32)[None],
                                       k, ef)
        return [(self.slots.key_of(int(s)), float(dd))
                for dd, s in zip(d[0], i[0]) if s >= 0]

    # -- negative-example search (graph.go:1116-1377) ---------------------
    def _rescore_negative(self, cand_slots: np.ndarray,
                          cand_dists: np.ndarray, query: np.ndarray,
                          negatives: np.ndarray, k: int,
                          neg_weight: float) -> List[Tuple[Any, float]]:
        """Over-fetched candidates -> combined score -> top-k.

        score = (1 - d_query) - neg_weight * avg(1 - d_neg), with the
        reference's special cases (exact match -> 2.0; any negative
        within 0.1 -> strong penalty). graph.go:1299-1353, minus the
        key-specific test boost (deliberately omitted)."""
        valid = cand_slots >= 0
        slots = cand_slots[valid]
        if len(slots) == 0:
            return []
        vecs = self.store.vectors[slots]
        qd = np_pairwise_dist(query[None], vecs, self.metric)[0]
        nd = np_pairwise_dist(negatives, vecs, self.metric)  # [Nneg, C]
        q_sim = 1.0 - qd
        neg_sim = 1.0 - nd
        avg_neg_sim = neg_sim.mean(axis=0)
        very_close = (nd < 0.1).any(axis=0)
        score = q_sim - neg_weight * avg_neg_sim
        score = np.where(very_close, q_sim - neg_weight * 2.0, score)
        score = np.where(qd < 0.001, 2.0, score)
        order = np.argsort(-score, kind="stable")[:k]
        return [(self.slots.key_of(int(slots[o])), float(score[o]))
                for o in order]

    @_reads
    def search_with_negative(self, query, negative, k: int,
                             neg_weight: float = 0.5
                             ) -> List[Tuple[Any, float]]:
        return self.search_with_negatives(query, [negative], k, neg_weight)

    @_reads
    def search_with_negatives(self, query, negatives, k: int,
                              neg_weight: float = 0.5
                              ) -> List[Tuple[Any, float]]:
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        if not (0.0 <= neg_weight <= 1.0):
            raise ValueError(
                f"negWeight must be between 0.0 and 1.0, got {neg_weight}")
        query = np.asarray(query, np.float32)
        negatives = np.atleast_2d(np.asarray(negatives, np.float32))
        if negatives.shape[0] == 0:
            return self.search(query, k)
        if len(self.slots) == 0:
            return []
        if self.store.dim is not None and negatives.shape[1] != self.store.dim:
            raise ValueError(
                f"negative embedding dimension mismatch: "
                f"{self.store.dim} != {negatives.shape[1]}")
        expanded_k = max(3 * k, 10)  # graph.go:1149-1152
        d, i = self.batch_search_slots(query[None], expanded_k)
        return self._rescore_negative(i[0], d[0], query, negatives, k,
                                      neg_weight)

    @_reads
    def batch_search_with_negatives(self, queries, negatives_per_query,
                                    k: int, neg_weight: float = 0.5
                                    ) -> List[List[Tuple[Any, float]]]:
        """graph.go:1382 BatchSearchWithNegatives — one batched search
        for the over-fetch, host re-scoring per query."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if len(negatives_per_query) != queries.shape[0]:
            raise ValueError("negatives list length must match queries")
        if len(self.slots) == 0:
            return [[] for _ in range(queries.shape[0])]
        expanded_k = max(3 * k, 10)
        d, i = self.batch_search_slots(queries, expanded_k)
        out = []
        for qi in range(queries.shape[0]):
            negs = np.atleast_2d(np.asarray(negatives_per_query[qi],
                                            np.float32))
            if negs.size == 0:
                out.append([(self.slots.key_of(int(s)), float(dd))
                            for dd, s in zip(d[qi][:k], i[qi][:k])
                            if s >= 0])
            else:
                out.append(self._rescore_negative(i[qi], d[qi], queries[qi],
                                                  negs, k, neg_weight))
        return out

    @_reads
    def parallel_search(self, query, k: int, num_workers: int = 0,
                        ef: Optional[int] = None
                        ) -> List[Tuple[Any, float]]:
        """API parity with graph.go:631 ParallelSearch: the batched
        lockstep search is the parallel path; ``num_workers`` is accepted
        and ignored."""
        del num_workers
        return self.search(query, k, ef)

    # -- misc -------------------------------------------------------------
    def keys(self) -> List[Any]:
        return list(self.slots.key_to_slot.keys())

    @property
    def num_layers(self) -> int:
        return self.host.top + 1
