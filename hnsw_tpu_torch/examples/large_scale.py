"""Large-scale serving: the exact tier, IVF and the capacity ladder on
200,000 x 128 clustered rows.

    python3 -m hnsw_tpu_torch.examples.large_scale [--cpu] [--small]

On the card the float32 exact tier runs the hand-written screen kernel
(K1, ``csrc/exact_screen.cu``) at this size, IVF scans its probed
partitions as batched products, and ``hbm_dtype="auto"`` walks the
capacity ladder (int8 -> bf16 -> fp16 -> f32) against this data, so
tight clusters never silently lose recall. Very long device builds are
restartable: ``Graph.build(..., checkpoint_path="ckpt.npz")`` and
``Graph.resume_build("ckpt.npz")``.
"""

import time

import numpy as np

from hnsw_tpu_torch import ExactIndex, IVFIndex
from hnsw_tpu_torch.examples import check, cli
from hnsw_tpu_torch.ops.topk import np_exact_topk


def _recall(keys, truth) -> float:
    hits = sum(len({x for x in keys[i] if x is not None} &
                   {int(x) for x in truth[i]}) for i in range(len(truth)))
    return hits / (10 * len(truth))


def main(device=None, small=False):
    rng = np.random.default_rng(0)
    n, d, parts, n_c = ((8000, 32, 32, 25) if small
                        else (200_000, 128, 256, 200))
    print(f"dataset: {n} x {d} (clustered)")
    centers = rng.standard_normal((n_c, d)).astype(np.float32) * 4
    data = (centers[rng.integers(0, n_c, n)]
            + 0.5 * rng.standard_normal((n, d)).astype(np.float32))
    queries = (centers[rng.integers(0, n_c, 1024)]
               + 0.5 * rng.standard_normal((1024, d)).astype(np.float32))

    # exact tier (K1 on the card at this size)
    ex = ExactIndex(metric="cosine", device=device)
    ex.batch_add(np.arange(n), data)
    ex.batch_search(queries, 10)  # warm
    t0 = time.perf_counter()
    gt_keys, _ = ex.batch_search(queries, 10)
    dt = time.perf_counter() - t0
    print(f"exact:  {1024 / dt:.0f} qps")
    _, oracle = np_exact_topk(queries[:32], data, 10, "cosine")
    check(_recall(gt_keys[:32], oracle) == 1.0,
          "exact recall@10 is 1.0 against numpy on 32 queries")

    # IVF partition scans (clustered data is its home ground)
    ivf = IVFIndex(num_partitions=parts, nprobe=16, kmeans_iters=6,
                   device=device)
    try:
        t0 = time.perf_counter()
        ivf.build(list(range(n)), data)
        print(f"ivf build: {time.perf_counter() - t0:.0f}s")
        ivf.batch_search(queries, 10)  # warm
        t0 = time.perf_counter()
        keys, _ = ivf.batch_search(queries, 10)
        dt = time.perf_counter() - t0
        rec = _recall(keys, gt_keys)
        print(f"ivf:    {1024 / dt:.0f} qps recall@10={rec:.3f}")
        check(rec >= 0.8, f"IVF recall@10 {rec:.3f} >= 0.8 at nprobe 16")
    finally:
        ivf.close()

    # capacity mode: a reduced-precision device table + f32 host rerank,
    # the rung chosen against this data
    cap = ExactIndex(metric="cosine", hbm_dtype="auto", device=device)
    cap.batch_add(np.arange(n), data)
    cap.batch_search(queries, 10)  # warm + resolve the rung
    t0 = time.perf_counter()
    keys, _ = cap.batch_search(queries, 10)
    dt = time.perf_counter() - t0
    rec = _recall(keys, gt_keys)
    print(f"capacity[{cap._resolved_hbm}]: {1024 / dt:.0f} qps "
          f"recall@10={rec:.3f}")
    check(rec >= 0.99, f"the capacity rung's recall@10 {rec:.3f} >= 0.99")


if __name__ == "__main__":
    cli(main, __doc__)
