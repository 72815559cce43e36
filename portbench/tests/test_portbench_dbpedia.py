"""The 1,536-wide cell ``dbpedia1536-cos.b8192.ef64``: found by name with
its configuration, traffic, limits and readers; the configuration as its
source states it; its own reader's number on a small trace, reckoned by
hand, and nothing where the copy is missing."""

import json

import pytest

from portbench import cells, trace

from .test_portbench_spans import program_trace
from .test_portbench_trace import _x, recorded_trace

CELL = "dbpedia1536-cos.b8192.ef64"
#: the cell's per-layer metrics: every accepted one, and its own
READERS = ("launches_per_batch", "syncs_per_batch", "k5_us_per_query",
           "k5_roofline", "device_idle_share", "build_vps.setup",
           "host_us_before_k5", "host_us_after_k5", "query_copy_us")


def _load(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(events))
    return trace.load(str(path))


def test_the_cell_loads_with_its_files_and_readers():
    cell = cells.load(CELL)
    assert cell.config["name"] == "dbpedia-openai1536-cos-hnsw"
    assert cell.traffic == cells.load("sift1m-l2.b8192.ef64").traffic
    assert set(cell.limits) == {"invalid_answers", "dist_err", "walk_diff",
                                "recall_miss", "graph_faults"}
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert {m["name"] for m in cell.end_to_end} == {
        "qps", "p95_ms", "recall_at_10", "setup_s"}
    for m in READERS:
        assert callable(cells.reader(m))
    assert cell.chips == 1


def test_the_configuration_is_the_published_shape():
    """ANN-Benchmarks' dbpedia-openai-1000k-angular: 990,000 base rows of
    1,536 (ada-002 embeddings), 10,000 queries, angular (the port's
    cosine); nothing reduced."""
    conf = cells.load(CELL).config
    assert (conf["rows"], conf["dim"], conf["queries"]) == (990_000, 1536,
                                                           10_000)
    assert conf["metric"] == "cosine" and conf["reduced"] == []
    assert conf["generator"]["subspace"] >= 32
    spec = json.load(open(f"{cells.ROOT}/BENCHMARK.json"))
    entry = {c["name"]: c for c in spec["configs"]}[conf["name"]]
    assert "dbpedia-openai-1000k-angular" in entry["source"]
    assert entry["file"].endswith("dbpedia-openai1536-cos-hnsw.json")


def test_query_copy_us_reads_each_calls_first_copy(tmp_path):
    """The recorded trace's two calls each begin with a 10 us
    ``cudaMemcpyAsync`` (the queries' copy); the program's trace, given a
    runtime call inside each ``hnsw.query_copy`` span and a later one for
    the answers, reads the first alone."""
    read = cells.reader("query_copy_us")
    tr = _load(tmp_path, recorded_trace())
    assert read(dict(trace=tr, calls=2)) == pytest.approx(10.0)
    extra = []
    for c0 in (1000.0, 2500.0):
        extra += [_x("cuda_runtime", "cudaMemcpyAsync", c0 + 45, 50.0),
                  _x("cuda_runtime", "cudaMemcpyAsync", c0 + 800, 90.0)]
    tr = _load(tmp_path, program_trace(extra=extra))
    assert read(dict(trace=tr, calls=2)) == pytest.approx(50.0)
    assert read(dict(trace=tr, calls=4)) == pytest.approx(25.0)


def test_query_copy_us_finds_nothing_without_a_copy(tmp_path):
    read = cells.reader("query_copy_us")
    assert read(dict(trace=_load(tmp_path, program_trace()), calls=2)) \
        is None
    assert read(dict(trace=None, calls=2)) is None
    tr = _load(tmp_path, recorded_trace())
    assert read(dict(trace=tr, calls=0)) is None
