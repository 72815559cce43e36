"""dryrun_multichip: every multi-device path of the port on one mesh, each
checked against the exact oracle (the port's counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``, same data and checks).

    python3 -c "from hnsw_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(8)"
    python3 -c "from hnsw_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(8, device='cpu')"

The first runs eight shards round-robin on the visible CUDA devices (all
eight on one card when there is one) and raises without CUDA; the second
runs them on the CPU.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _recall(found: np.ndarray, truth: np.ndarray) -> float:
    hits = sum(len(set(map(int, f)) & set(map(int, t)))
               for f, t in zip(found, truth))
    return hits / truth.size


def dryrun_multichip(n_devices: int = 8, device=None) -> Dict[str, float]:
    """Run the 8 sharded paths at 4,096 rows x 64 (seed 0) on an
    ``n_devices``-shard mesh and assert what the JAX dryrun asserts:
    partitioned, data-parallel, int8 capacity + rerank, fp16 graph and
    row-sharded graph recall >= 0.9; row-sharded exact ids == the oracle;
    block-sharded IVF == the oracle at nprobe = P; a 2-slice
    MultiHostIndex over TCP at recall 1.0. Prints one line and returns the
    recalls by path."""
    from hnsw_tpu_torch import ExactIndex, Graph, IVFIndex
    from hnsw_tpu_torch.core.state import DeviceGraph
    from hnsw_tpu_torch.ops.topk import np_exact_topk
    from hnsw_tpu_torch.parallel.multihost import MultiHostIndex
    from hnsw_tpu_torch.parallel.partitioned import _pad_graph
    from hnsw_tpu_torch.parallel.rowsharded import (make_row_shards,
                                                    rowsharded_graph_search)
    from hnsw_tpu_torch.parallel.rpc import SliceServer, SocketTransport
    from hnsw_tpu_torch.parallel.sharded import (
        default_mesh, partitioned_graph_search, sharded_exact_topk,
        sharded_graph_search, sharded_ivf_candidates,
        sharded_quantized_candidates)

    mesh = default_mesh(n_devices, device=device)
    dev = mesh.devices[0]
    rng = np.random.default_rng(0)
    d = 64
    n_per = max(64, 4096 // n_devices)

    # --- expert-parallel analogue: one sub-graph per shard ---------------
    parts = [rng.standard_normal((n_per, d)).astype(np.float32)
             for _ in range(n_devices)]
    graphs = []
    for p in parts:
        gg = Graph(m=8, seed=0, ef_construction=60, device=dev)
        gg.build(list(range(n_per)), p, wave=256)
        graphs.append(gg.device_graph())
    cap = max(g.cap for g in graphs)
    L = max(g.num_layers for g in graphs)
    padded = [_pad_graph(g, cap, L, dev) for g in graphs]
    stacked = DeviceGraph(*(torch.stack(xs)
                            for xs in zip(*(g[:6] for g in padded))))
    k = 5
    allv = np.concatenate(parts)
    q_np = rng.standard_normal((16, d)).astype(np.float32)
    queries = torch.from_numpy(q_np).to(dev)
    _, gt_i = np_exact_topk(q_np, allv, k, "cosine")
    _, ik = partitioned_graph_search(stacked, queries, k=k, ef=64,
                                     metric="cosine", mesh=mesh)
    ik = ik.cpu().numpy()
    _check(ik.shape == (16, k), f"partitioned ids {ik.shape}")
    part_ids, local = np.divmod(ik, cap)
    rec_part = _recall(part_ids * n_per + local, gt_i)
    _check(rec_part >= 0.9, f"partitioned recall {rec_part:.3f} < 0.9")

    # --- data-parallel: replicated graph, sharded queries ----------------
    # served from the compact upper layout, so the dryrun also runs the
    # large-scale storage schema under query sharding
    g_all = Graph(m=8, seed=0, ef_construction=60, device=dev)
    g_all.build(list(range(len(allv))), allv, wave=512)
    g_all.split_layers = "compact"
    g_all._dirty = True
    nq = 8 * n_devices
    qb_np = rng.standard_normal((nq, d)).astype(np.float32)
    qb = torch.from_numpy(qb_np).to(dev)
    _, i2 = sharded_graph_search(g_all.device_graph(), qb, k=k, ef=160,
                                 metric="cosine", mesh=mesh)
    i2 = i2.cpu().numpy()
    _check(i2.shape == (nq, k), f"data-parallel ids {i2.shape}")
    _, gt2_i = np_exact_topk(qb_np, allv, k, "cosine")
    rec_dp = _recall(i2, gt2_i)
    _check(rec_dp >= 0.9, f"data-parallel recall {rec_dp:.3f} < 0.9")

    # --- row-sharded exact with global top-k merge -----------------------
    n_rows = n_per * n_devices
    vecs = torch.from_numpy(allv).to(dev)
    sq = torch.sum(vecs * vecs, dim=1)
    valid = torch.ones((n_rows,), dtype=torch.bool, device=dev)
    _, i3 = sharded_exact_topk(queries, vecs, sq, valid, k=k, metric="l2",
                               mesh=mesh)
    _, gt3_i = np_exact_topk(q_np, allv, k, "l2")
    _check(np.array_equal(i3.cpu().numpy(), gt3_i),
           "sharded exact mismatch")

    # --- row-sharded CAPACITY mode: int8 shards + exact f32 rerank -------
    amax = np.max(np.abs(allv), axis=1)
    scl = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    v8 = np.clip(np.rint(allv / scl[:, None]), -127, 127).astype(np.int8)
    sq64 = np.sum(allv.astype(np.float64) * allv, axis=1).astype(np.float32)
    _, i4 = sharded_quantized_candidates(
        queries, torch.from_numpy(v8).to(dev), torch.from_numpy(scl).to(dev),
        torch.from_numpy(sq64).to(dev), valid, kk=k + 16, metric="cosine",
        mesh=mesh)
    i4 = i4.cpu().numpy()
    picked = []
    for r in range(i4.shape[0]):
        cand = i4[r][i4[r] >= 0]
        qv, cv = q_np[r], allv[cand]
        dist = 1.0 - (cv @ qv) / (np.linalg.norm(cv, axis=1)
                                  * np.linalg.norm(qv) + 1e-30)
        picked.append(cand[np.argsort(dist)[:k]])
    rec_cap = _recall(picked, gt_i)
    _check(rec_cap >= 0.9, f"capacity-mode recall {rec_cap:.3f} < 0.9")

    # --- fp16 graph CAPACITY mode under query sharding -------------------
    g_all.hbm_mode = "float16"
    g_all._dirty = True
    dev16 = g_all.device_graph()
    _check(dev16.vectors.dtype == torch.float16,
           f"fp16 store is {dev16.vectors.dtype}")
    _, i5 = sharded_graph_search(dev16, qb, k=k, ef=160, metric="cosine",
                                 mesh=mesh)
    rec_fp16 = _recall(i5.cpu().numpy(), gt2_i)
    _check(rec_fp16 >= 0.9, f"fp16 graph recall {rec_fp16:.3f} < 0.9")

    # --- block-sharded IVF: probe-routed masked scan + global merge ------
    ivf = IVFIndex(num_partitions=16, nprobe=16, metric="cosine", seed=0,
                   device=dev)
    ivf.build(list(range(len(allv))), allv)
    blocks, block_sq, block_valid, block_slot, cents, part_blocks = \
        ivf._sync()
    NB = blocks.shape[0]
    nb_pad = -(-NB // n_devices) * n_devices
    bpart = np.full(nb_pad, -1, np.int32)
    for p, bl in enumerate(part_blocks):
        bpart[bl] = p
    padb = nb_pad - NB
    F = torch.nn.functional
    _, i6 = sharded_ivf_candidates(
        queries, cents, F.pad(blocks, (0, 0, 0, 0, 0, padb)),
        F.pad(block_sq, (0, 0, 0, padb)), F.pad(block_valid, (0, 0, 0, padb)),
        torch.from_numpy(bpart).to(dev), nprobe=16, k=k, metric="cosine",
        mesh=mesh)
    i6 = i6.cpu().numpy()
    flat_slot = np.pad(block_slot, ((0, padb), (0, 0)),
                       constant_values=-1).reshape(-1)
    slots6 = np.where(i6 >= 0, flat_slot[np.clip(i6, 0, None)], -1)
    _check(np.array_equal(slots6, gt_i), "sharded IVF != oracle")
    ivf.close()

    # --- ONE graph, layer-0 rows sharded over the mesh -------------------
    shards8 = make_row_shards(g_all, n_devices)
    _, i8 = rowsharded_graph_search(shards8, queries, k=k, ef=160, seeds=16,
                                    expand=2, mesh=mesh)
    rec_row = _recall(i8.cpu().numpy(), gt_i)
    _check(rec_row >= 0.9, f"row-sharded graph recall {rec_row:.3f} < 0.9")

    # --- 2-slice MultiHostIndex over real TCP sockets --------------------
    servers = [SliceServer(ExactIndex(metric="cosine", device=dev))
               for _ in range(2)]
    tr = SocketTransport([s.start() for s in servers], request_timeout=60.0)
    try:
        mh = MultiHostIndex(tr, replicas=1)
        try:
            mh.batch_add(list(range(len(allv))), allv)
            mkeys, _ = mh.batch_search(q_np, k)
        finally:
            mh.close()
        rec_mh = _recall(mkeys, gt_i)
        _check(rec_mh == 1.0, f"multihost exact recall {rec_mh:.3f} != 1")
    finally:
        tr.close()
        for s in servers:
            s.shutdown()

    print(f"dryrun_multichip({n_devices}): {n_rows} rows x {d}d on "
          f"{n_devices} shards of {mesh} — partitioned recall "
          f"{rec_part:.3f}, data-parallel recall {rec_dp:.3f}, row-sharded "
          f"exact == oracle, int8 capacity+rerank recall {rec_cap:.3f}, fp16 "
          f"graph capacity mode recall {rec_fp16:.3f}, block-sharded IVF == "
          f"oracle, row-sharded SINGLE graph (psum frontier exchange) recall "
          f"{rec_row:.3f}, 2-slice MultiHostIndex over TCP recall "
          f"{rec_mh:.3f}; all 8 paths executed and recall-checked OK",
          flush=True)
    return {"partitioned": rec_part, "data_parallel": rec_dp,
            "int8_capacity": rec_cap, "fp16_graph": rec_fp16,
            "row_sharded_graph": rec_row, "multihost": rec_mh}
