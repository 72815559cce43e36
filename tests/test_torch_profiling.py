"""utils/profiling of the port: ``device_trace`` writes a Chrome trace
holding the names that ``span`` and ``annotate`` give the program's work
(here the CPU activity only), ``span`` records nothing while no profiler
session does, and the program's spans of a search call, a keyed search
and a device build wave nest as they are documented.
"""

import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from hnsw_tpu_torch import Graph  # noqa: E402
from hnsw_tpu_torch.utils import profiling  # noqa: E402


def _spans(tmp_path, fn):
    """Run ``fn`` inside ``device_trace`` and return the trace's
    ``record_function`` ranges as (name, start us, end us), in order."""
    with profiling.device_trace(str(tmp_path / "spans")):
        fn()
    (path,) = glob.glob(os.path.join(tmp_path, "spans", "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                  for e in events if e.get("cat") == "user_annotation")


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _of(spans, name):
    return [s for s in spans if s[0] == name]


@pytest.fixture(scope="module")
def graph():
    """A 1,200-row L2 graph on the CPU, built by the native engine, and
    a batch of queries larger than the native engine's."""
    rng = np.random.default_rng(3)
    g = Graph(m=8, metric="l2", seed=0, device="cpu")
    g.build(list(range(1200)), rng.standard_normal((1200, 16))
            .astype(np.float32), method="host")
    return g, rng.standard_normal((48, 16)).astype(np.float32)


def test_span_records_nothing_without_a_profiler(monkeypatch, graph):
    """With no profiler session recording, ``span``, ``annotate`` and a
    whole search call make no ``record_function`` range; inside one, each
    span makes one."""
    made = []
    real = torch.profiler.record_function

    def counted(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    g, q = graph
    with profiling.span("port_span"):
        pass
    assert profiling.annotate("port_fn")(lambda x: x + 1)(1) == 2
    g.batch_search_slots(q, 5)
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("port_span"):
            pass
        g.batch_search_slots(q, 5)
    assert made[0] == "port_span" and "hnsw.search" in made


def test_span_names_its_block_in_a_cpu_trace(tmp_path):
    def work():
        with profiling.span("port_outer"):
            with profiling.span("port_inner"):
                torch.ones((4, 4)).sum()

    spans = _spans(tmp_path, work)
    (outer,), (inner,) = _of(spans, "port_outer"), _of(spans, "port_inner")
    assert _inside(inner, outer)


def test_a_search_call_nests_its_spans(tmp_path, graph):
    """``hnsw.search`` holds the preparation, the query copy and the
    results (with their copy) in that order; the read hold is taken
    before it opens (``hnsw.lock``, which ends before it)."""
    g, q = graph
    spans = _spans(tmp_path, lambda: g.batch_search_slots(q, 5))
    (search,) = _of(spans, "hnsw.search")
    parts = [_of(spans, n) for n in ("hnsw.prepare", "hnsw.query_copy",
                                     "hnsw.results", "hnsw.results.copy")]
    assert [len(p) for p in parts] == [1, 1, 1, 1]
    (prep,), (copy,), (results,), (out,) = parts
    assert all(_inside(s, search) for s in (prep, copy, results))
    assert prep[2] <= copy[1] and copy[2] <= results[1]
    assert _inside(out, results)
    lock = _of(spans, "hnsw.lock")[0]
    assert lock[2] <= search[1]
    assert not _of(spans, "hnsw.native_search")


@pytest.mark.parametrize("case", ["native", "capacity"])
def test_the_other_routes_name_their_work(tmp_path, graph, case):
    """A batch the native engine serves is ``hnsw.native_search`` inside
    ``hnsw.search`` with no query copy; the capacity modes' host rerank is
    ``hnsw.host_rerank`` inside ``hnsw.results``."""
    g, q = graph
    if case == "native":
        spans = _spans(tmp_path, lambda: g.batch_search_slots(q[:8], 5))
        (search,), (native,) = (_of(spans, "hnsw.search"),
                                _of(spans, "hnsw.native_search"))
        assert _inside(native, search)
        assert not _of(spans, "hnsw.query_copy")
        return
    g.hbm_mode = "quantized"
    try:
        spans = _spans(tmp_path, lambda: g.batch_search_slots(q, 5))
    finally:
        g.hbm_mode = "full"
    (results,), (rerank,) = (_of(spans, "hnsw.results"),
                             _of(spans, "hnsw.host_rerank"))
    assert _inside(rerank, results)


def test_batch_search_adds_the_key_span(tmp_path, graph):
    g, q = graph
    got = []
    spans = _spans(tmp_path, lambda: got.append(g.batch_search(q, 5)))
    (search,), (keys,) = _of(spans, "hnsw.search"), _of(spans, "hnsw.keys")
    assert search[2] <= keys[1]
    assert len(got[0][0]) == len(q)


def test_a_device_build_names_each_wave(tmp_path):
    """Each wave of the device builder is one ``build.wave`` holding its
    descent, a selection and a reverse update for each layer the wave
    reaches, and its commit; the write hold is taken before the build."""
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((700, 8)).astype(np.float32)
    g = Graph(m=4, metric="l2", seed=1, device="cpu")
    spans = _spans(tmp_path, lambda: g.build(list(range(700)), rows,
                                             method="device", wave=256))
    waves = _of(spans, "build.wave")
    assert len(waves) >= 2
    for name in ("build.descent", "build.commit"):
        inner = _of(spans, name)
        assert len(inner) == len(waves)
        assert all(_inside(s, w) for s, w in zip(inner, waves))
    selects = _of(spans, "build.select")
    updates = _of(spans, "build.update")
    assert len(selects) == len(updates) >= len(waves)
    assert all(any(_inside(s, w) for w in waves)
               for s in selects + updates)
    assert _of(spans, "hnsw.lock")[0][2] <= waves[0][1]
    assert g.search(rows[5], 1)[0][0] == 5


def test_device_trace_holds_the_annotated_name(tmp_path):
    @profiling.annotate("port_scan_span")
    def scan(a, b):
        return (a @ b.T).amax(dim=1)

    assert scan.__name__ == "scan"
    a, b = torch.ones((8, 4)), torch.ones((16, 4))
    with profiling.device_trace(str(tmp_path / "trace")):
        out = scan(a, b)
    assert torch.equal(out, torch.full((8,), 4.0))
    files = glob.glob(os.path.join(tmp_path, "trace", "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "port_scan_span" in names


def test_kernel_events_counts_the_kernel_category(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "k1"}, {"cat": "cpu_op", "name": "mm"},
        {"cat": "kernel", "name": "k2"}, {"name": "meta"}]}))
    assert profiling.kernel_events(str(path)) == 2


def test_device_events_lists_kernels_copies_and_sets(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "k1", "dur": 2.5},
        {"cat": "cpu_op", "name": "mm", "dur": 9},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 1},
        {"cat": "gpu_memset", "name": "Memset", "dur": 0.5},
        {"name": "meta"}]}))
    assert profiling.device_events(str(path)) == [
        ("kernel", "k1", 2.5), ("gpu_memcpy", "Memcpy DtoH", 1.0),
        ("gpu_memset", "Memset", 0.5)]


def test_host_syncs_counts_stream_synchronize_calls(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize"},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel"},
        {"cat": "cuda_runtime", "name": "cudaDeviceSynchronize"},
        {"cat": "cpu_op", "name": "cudaStreamSynchronize"},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize"}]}))
    assert profiling.host_syncs(str(path)) == 2


def test_trace_summary_splits_one_call(monkeypatch):
    """trace_summary: one call in device_trace, the device ms of its
    kernels, copies and sets by name, its kernel launches and copies by
    name, the host's syncs and the idle share of its wall time (the
    trace's device events scripted here)."""
    calls = []
    monkeypatch.setattr(profiling, "device_events", lambda path: [
        ("kernel", "k", 1000.0), ("kernel", "k", 500.0),
        ("gpu_memcpy", "Memcpy DtoH", 250.0)])
    ticks = iter([10.0, 10.004])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    s = profiling.trace_summary(lambda: calls.append(1))
    assert calls == [1]
    assert s["by_name"] == {"k": 1.5, "Memcpy DtoH": 0.25}
    assert s["launches"] == 2 and s["device_ms"] == 1.75
    assert s["launches_by_name"] == {"k": 2}
    assert s["copies"] == {"Memcpy DtoH": 1} and s["syncs"] == 0
    assert s["wall_ms"] == pytest.approx(4.0)
    assert s["idle_share"] == pytest.approx(1 - 1.75 / 4.0)


def test_trace_summary_is_none_when_the_card_recorded_nothing(monkeypatch):
    """A trace without kernel events gives no split: trace_summary returns
    None where device_trace raises for it, and lets any other error up."""
    class Raising:
        def __init__(self, exc):
            self.exc = exc

        def __enter__(self):
            return None

        def __exit__(self, *a):
            raise self.exc

    monkeypatch.setattr(profiling, "device_trace", lambda td: Raising(
        RuntimeError("device_trace: x holds no CUDA kernel event; ...")))
    assert profiling.trace_summary(lambda: None) is None
    monkeypatch.setattr(profiling, "device_trace",
                        lambda td: Raising(RuntimeError("other")))
    with pytest.raises(RuntimeError, match="other"):
        profiling.trace_summary(lambda: None)


def test_device_trace_raises_when_the_card_recorded_nothing(
        tmp_path, monkeypatch):
    """With the CUDA activity asked for (a card present) and no kernel
    event in the trace, device_trace raises instead of leaving a trace
    that reads as zero device time. Here no card runs the block."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA kernel event"):
        with profiling.device_trace(str(tmp_path / "trace")):
            torch.ones((4, 4)) @ torch.ones((4, 4))


def test_trace_skew_needs_the_card(monkeypatch):
    from hnsw_tpu_torch.tools import trace_skew
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        trace_skew.main(["--seconds", "1"])
