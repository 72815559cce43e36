"""tools/bench of the port: a small run on the CPU prints one JSON line
with every key bench.py prints plus the port's four (``package``,
``platform``, ``device``, ``power_limit_w``); its exact tier's ids over
the graph's device table equal JAX ``exact_topk``'s on bench.py's data
(same seed, same graph configuration); without CUDA and without
``--device cpu`` it exits with an error instead of running on the CPU."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from hnsw_tpu import Graph as JGraph  # noqa: E402
from hnsw_tpu.ops.topk import exact_topk as jexact_topk  # noqa: E402

from hnsw_tpu_torch.tools import bench  # noqa: E402

#: the keys bench.py prints (its final json.dumps, lat_fields included)
BENCH_PY_KEYS = {
    "metric", "value", "unit", "vs_baseline", "recall", "exact_fast_qps",
    "exact_fast_recall", "hnsw_qps_at_recall>=0.95", "hnsw_recall",
    "hnsw_qps_at_recall>=0.98", "hnsw_recall@0.98_point",
    "hnsw_vs_baseline_at_0.98", "exact_qps_spread", "exact_fast_qps_spread",
    "hnsw_qps_spread", "build_seconds", "platform",
    "adaptive_engine_mean_ms", "adaptive_engine_p50_ms",
    "adaptive_engine_recall", "single_query_p50_ms", "single_query_mean_ms",
    "single_query_recall", "single_query_tier", "latency_vs_baseline"}
PORT_KEYS = {"package", "platform", "device", "power_limit_w"}


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


def test_small_bench_on_the_cpu_prints_one_line(capsys):
    rec = bench.main(["--device", "cpu"], n=1000, n_q=128, reps=1)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    assert set(rec) == BENCH_PY_KEYS | PORT_KEYS
    assert rec["package"] == "hnsw_tpu_torch"
    assert (rec["platform"], rec["device"], rec["power_limit_w"]) == \
        ("cpu", "cpu", None)
    assert rec["recall"] == 1.0 and rec["exact_fast_recall"] >= 0.999
    assert "# hnsw graph ef=192: hops by layer" in out.err


def test_exact_ids_equal_jax_exact_topk():
    n, n_q = 1000, 64
    data, queries = bench.make_data(n, n_q)
    want_data = np.random.default_rng(0).standard_normal((n, 128)).astype(
        np.float32)
    assert np.array_equal(data, want_data)
    dev = bench.build_graph(data, device="cpu").device_graph()
    got = bench.exact_ids(dev, torch.from_numpy(queries)).numpy()

    jg = JGraph(m=16, ef_search=20, metric="cosine", seed=0)
    jg.build(list(range(n)), data, wave=2048)
    jg.fast_math = True
    jdev = jg.device_graph()
    _, want = jexact_topk(jnp.asarray(queries), jdev.vectors, jdev.sq_norms,
                          jdev.alive, k=10, metric="cosine")
    assert np.array_equal(got, np.asarray(want))


def test_without_cuda_the_bench_refuses_to_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        bench.main([], n=100, n_q=8, reps=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench.run(None, n=100, n_q=8, reps=1)
