"""Serving operations: search under concurrent mutation, capacity arms
of the adaptive engine, and calibration that persists.

    python3 -m hnsw_tpu_torch.examples.serving_ops [--cpu] [--small]

* the RWMutex contract (reference graph.go:328): reader threads keep
  serving while a writer mutates;
* ``AdaptiveConfig.capacity_arms``: reduced-precision table rungs as
  bandit arms, demoted by the quality floor when the workload breaks
  them (reference adaptive.go:196-241, extended to capacity);
* calibration persistence: calibrate once, reopen and serve without
  paying for the oracle scan again.
"""

import os
import tempfile
import threading

import numpy as np

from hnsw_tpu_torch import AdaptiveConfig, AdaptiveHybridIndex, Graph
from hnsw_tpu_torch.examples import check, cli
from hnsw_tpu_torch.io.codec import load_graph, save_graph


def main(device=None, small=False):
    rng = np.random.default_rng(0)
    n, d, k = (1000 if small else 2000), 32, 5
    extra = n // 4
    data = rng.standard_normal((n + extra, d)).astype(np.float32)

    # --- 1. concurrent search while another thread mutates --------------
    g = Graph(metric="cosine", seed=0, device=device)
    g.batch_add(list(range(n)), data[:n])
    served, errors = [], []
    stop = threading.Event()

    def reader():
        r = np.random.default_rng(threading.get_ident() % (1 << 32))
        while not stop.is_set():
            try:
                served.append(len(g.search(data[r.integers(0, n)], k)))
            except Exception as e:   # reported below, never swallowed
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        g.batch_add(list(range(n, n + extra)), data[n:])   # bulk insert
        g.batch_delete(list(range(100)))                   # bulk delete
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    print(f"served {len(served)} searches concurrently with bulk "
          f"mutations; index now holds {len(g)} vectors")
    check(not errors and not any(t.is_alive() for t in threads)
          and len(g) == n + extra - 100,
          "readers ran without errors and stopped; the count is right")

    # --- 2. capacity arms under the quality floor -------------------------
    # tight clusters break int8 ranking; the bandit's oracle probe
    # measures it and the champion serves instead
    centers = rng.standard_normal((20, d)).astype(np.float32) * 5
    clustered = (centers[rng.integers(0, 20, n)]
                 + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    eng = AdaptiveHybridIndex(adaptive_config=AdaptiveConfig(
        capacity_arms=("int8", "fp16"), recall_probe_interval=1,
        recall_target=0.95, exploration_factor=0.2), device=device)
    try:
        eng.batch_add(list(range(n)), clustered)
        q = (centers[rng.integers(0, 20, 16)]
             + 0.3 * rng.standard_normal((16, d)).astype(np.float32))
        for arm in ("exact_int8", "exact_fp16"):
            eng.selector.explore = (arm,)     # pin exploration for the demo
            for _ in range(2):                # warm + one probed batch
                eng.batch_search(q, k)
        stats = eng.get_stats()["strategies"]
        for arm in ("exact_int8", "exact_fp16"):
            st = stats.get(arm, {})
            print(f"{arm}: measured recall {st.get('avg_recall')} (demoted "
                  f"by quality floor: {eng._backstop_arm(arm) is not None})")
        check(all(arm in stats for arm in ("exact_int8", "exact_fp16")),
              "both capacity arms served and were measured")
    finally:
        eng.close()

    # --- 3. calibration persists across reopen ----------------------------
    g2 = Graph(metric="cosine", seed=0, device=device)
    g2.batch_add(list(range(n)), data[:n])
    ef, rec = g2.calibrate_ef(0.9, k=k)
    print(f"calibrated: ef={ef} at recall {rec:.3f}")
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "g.npz")
        save_graph(g2, p)
        g3 = load_graph(p, device=device)
        ef3, rec3 = g3.calibrate_ef(0.9, k=k)   # cached: no oracle scan
        print(f"reopened: ef={ef3} served from the persisted calibration")
        check((ef3, rec3) == (ef, rec),
              "the reopened graph serves the persisted calibration")


if __name__ == "__main__":
    cli(main, __doc__)
