"""tools/sweep of the port against benchmarks/sweep.py.

Each configuration of the port's ``--small`` sweep on the CPU gives the
rows the JAX ``--small`` sweep prints for it, in its order, identified
by config, strategy, metric, tier, rows, target and ef (the list below
is read off benchmarks/sweep.py: running the JAX sweep on the CPU takes
minutes). An autoscaled row's ef is the calibration's result, not its
identity, so it is left out. Every exact row's recall@10 is 1.0. The
``--big`` ladder (config 8) runs at full size only; its logic is run
here at a small number of rows.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu_torch.tools import sweep  # noqa: E402

C1 = "cosine_10kx128"
JAX_SMALL_ROWS = {
    "config1": [{"config": C1, "metric": "bulk_build_seconds"}]
    + [{"config": C1, "strategy": "hnsw", "ef": ef}
       for ef in (96, 192, 256, 320, 384)]
    + [{"config": C1, "strategy": "hnsw_block_piv", "ef": ef}
       for ef in (192, 256, 384)]
    + [{"config": C1, "strategy": "hnsw_autoef", "target": t}
       for t in (0.9, 0.95)]
    + [{"config": C1, "strategy": s} for s in
       ("exact", "exact_fast", "ivf_p32_probe8", "ivf_p32_auto")],
    "config2": [{"config": f"{m}_angular_10kx100", "strategy": "hnsw",
                 "ef": ef} for m in ("l2", "dot") for ef in (20, 64, 128)],
    "config3": [{"config": "batch_delete", "metric": m} for m in (
        "delete_repair_seconds", "recall_after_delete",
        "delete_refine_seconds", "recall_after_refine",
        "delete_refine_seconds_warm")],
    "config4": [{"config": "adaptive_hybrid"}]
    + [{"config": "single_query_latency", "tier": "graph_native", "ef": ef}
       for ef in (20, 64, 96, 192)]
    + [{"config": "single_query_latency", "tier": "adaptive"}]
    + [{"config": "adaptive_reference_table", "rows": r}
       for r in ("800x32_random", "800x32_clustered")]
    + [{"config": f"target_recall_{kind}", "target": t}
       for kind in ("random", "clustered") for t in (0.9, 0.95, 0.99)],
    "config5": [{"config": "faceted", "metric": m} for m in (
        "filtered_batch64_seconds", "exact_filtered_batch64_seconds")]
    + [{"config": "negative", "metric": "negative_batch64_seconds"}],
    "config6": [{"config": "disk_parquet"}, {"config": "disk_arrow"},
                {"config": "appender"}],
    "config7": [{"config": "surface_overhead"}],
    "config8": [],
}
ID_KEYS = ("config", "strategy", "metric", "tier", "rows", "target", "ef")


def _identity(row: dict) -> tuple:
    keys = ID_KEYS[:-1] if row.get("strategy") == "hnsw_autoef" else ID_KEYS
    return tuple(row.get(k) for k in keys)


def _expected(name: str) -> list:
    rows = JAX_SMALL_ROWS[name]
    if name == "config6":
        try:
            import pyarrow  # noqa: F401
        except ImportError:   # the port's tables fall back to npz
            rows = [{"config": "disk_npz"}]
    return [_identity(r) for r in rows]


@pytest.fixture(scope="module")
def small():
    return sweep.Sweep(small=True, device="cpu")


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


def test_the_small_sweep_has_the_jax_sweeps_47_rows():
    assert sum(len(v) for v in JAX_SMALL_ROWS.values()) == 47
    assert list(JAX_SMALL_ROWS) == list(sweep.Sweep.CONFIGS)


@pytest.mark.parametrize("name", sweep.Sweep.CONFIGS)
def test_config_rows_match_the_jax_small_sweep(small, name):
    rows = getattr(small, name)()
    assert [_identity(r) for r in rows] == _expected(name)
    assert all(r["platform"] == "cpu" for r in rows)
    for r in rows:
        if r.get("strategy") == "exact":
            assert r["recall@10"] == 1.0, r
            assert "mfu" not in r and r["floor_frac"] > 0


def test_the_ladder_logic_at_a_small_size(monkeypatch):
    sw = sweep.Sweep(small=True, device="cpu", big=True)
    assert sw.config8() == []          # --small never runs the ladder
    sw.small = False
    monkeypatch.setattr(sw, "BIG_ROWS", (40_000, 50_000))
    monkeypatch.setattr(sw, "BIG_QUERIES", 96)
    rows = sw.config8()
    assert [(r["config"], r["strategy"], r["n"]) for r in rows] == [
        ("exact_roofline_0m", "exact", 40_000),
        ("exact_roofline_0m", "exact_fast", 40_000),
        ("exact_roofline_0m", "exact_fast", 50_000)]
    assert rows[0]["ids_equal_plain"] is True
    assert rows[2]["f32_ids_equal_plain"] is True
    assert "f32_ids_equal_plain" not in rows[1]
    for r in rows:
        assert r["recall@10"] == 1.0 and r["checked_queries"] == 96
        assert "floor_frac" in r and "mfu" not in r


def _plain(nq=4, k=5):
    d = torch.arange(nq * k, dtype=torch.float32).reshape(nq, k) * 1e-2
    return d, torch.arange(nq * k).reshape(nq, k)


@pytest.mark.parametrize("case,ok,n_diff", [
    ("equal", True, 0),
    ("tie_swap", True, 2),       # ranks 1, 2 of row 0 swapped at a tie
    ("far_neighbour", False, 1),  # rank 4 of row 3 a row 1e-3 farther
    ("duplicate", False, 1),      # one id twice
    ("miss", False, 1),           # -1 in place of a neighbour
])
def test_plain_agreement_passes_ties_only(case, ok, n_diff):
    """Held to the plain scan, an exact scan may differ only where two
    rows tie to f32 rounding (TIE_TOL); a farther row, a repeated id or
    a miss fails."""
    gd, gi = _plain()
    kd, ki = gd.clone(), gi.clone()
    if case == "tie_swap":
        gd[0, 2] = gd[0, 1] + sweep.TIE_TOL / 2
        kd[0, 1], kd[0, 2] = gd[0, 1], gd[0, 2]
        ki[0, 1], ki[0, 2] = gi[0, 2], gi[0, 1]
    elif case == "far_neighbour":
        kd[3, 4], ki[3, 4] = gd[3, 4] + 1e-3, 999
    elif case == "duplicate":
        ki[2, 3] = ki[2, 2]
    elif case == "miss":
        ki[1, 0] = -1
    assert sweep.plain_agreement((kd, ki), (gd, gi)) == (ok, n_diff)


def test_without_cuda_the_sweep_refuses_to_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        sweep.main(["--small"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sweep.Sweep(small=True)
