"""The readers of the host's time around K5 (``host_us_before_k5``,
``host_us_after_k5``) on small traces in the format ``torch.profiler``'s
``export_chrome_trace`` writes: each call's K5 paired with its spans and
bounded by them, and nothing where they do not pair."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import cells, spans, trace

from .test_portbench_trace import K5, _x, recorded_trace

READERS = ("host_us_before_k5", "host_us_after_k5")


def program_trace(shift_start=0.0, shift_end=0.0, drop=None, extra=None):
    """Two calls of 1,000 us in a window of 3,000 us, each with the
    program's spans: ``hnsw.search`` from 5 to 995 us into the call,
    ``k5.launch`` at 190 us, K5 from 200 to 800 us, ``hnsw.results.copy``
    from 795 to 900 us. The second call's K5 is moved by ``shift_start``
    (its start) and ``shift_end`` (its end); ``drop`` leaves out the
    second call's span of that name; ``extra`` adds those events."""
    ev = [_x("user_annotation", trace.WINDOW, 1000.0, 3000.0)]
    for n, c0 in enumerate((1000.0, 2500.0)):
        k0, k1 = c0 + 200, c0 + 800
        if n:
            k0, k1 = k0 + shift_start, k1 + shift_end
        named = [("hnsw.search", c0 + 5, 990.0),
                 ("hnsw.prepare", c0 + 10, 30.0),
                 ("hnsw.query_copy", c0 + 40, 60.0),
                 ("k5.prepare", c0 + 110, 70.0),
                 ("k5.launch", c0 + 190, 8.0),
                 ("hnsw.results", c0 + 790, 200.0),
                 ("hnsw.results.copy", c0 + 795, 105.0)]
        ev += [_x("user_annotation", trace.CALL, c0, 1000.0),
               _x("kernel", K5, k0, k1 - k0),
               _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)",
                  c0 + 60, 50.0)]
        ev += [_x("user_annotation", name, ts, dur)
               for name, ts, dur in named if not (n and name == drop)]
    return {"traceEvents": ev + list(extra or [])}


def _load(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(events))
    return trace.load(str(path))


def _read(tr):
    return {m: cells.reader(m)(dict(trace=tr, calls=2)) for m in READERS}


def test_each_call_read_between_its_spans_and_its_k5(tmp_path):
    got = _read(_load(tmp_path, program_trace()))
    # 200 - 5 us before K5, 995 - 800 us after it, in both calls
    assert got["host_us_before_k5"] == pytest.approx(195.0)
    assert got["host_us_after_k5"] == pytest.approx(195.0)


def test_a_k5_placed_before_its_launch_starts_at_the_launch(tmp_path):
    """The second K5 sits 50 us before its ``k5.launch`` span on the
    trace's clock: it is read as starting when the launch did."""
    tr = _load(tmp_path, program_trace(shift_start=-60.0))
    c = spans.calls(tr)[1]
    assert c.k5_start == pytest.approx(c.launch - 50e-6)
    assert c.k5_bounded[0] == c.launch
    got = _read(tr)
    assert got["host_us_before_k5"] == pytest.approx((195.0 + 185.0) / 2)
    assert got["host_us_after_k5"] == pytest.approx(195.0)


def test_a_k5_ending_after_its_copy_ends_with_the_copy(tmp_path):
    """The second K5 ends 50 us after its ``hnsw.results.copy`` span: it
    is read as ending when the copy did."""
    tr = _load(tmp_path, program_trace(shift_end=150.0))
    c = spans.calls(tr)[1]
    assert c.k5_end == pytest.approx(c.copied + 50e-6)
    assert c.k5_bounded[1] == c.copied
    got = _read(tr)
    assert got["host_us_before_k5"] == pytest.approx(195.0)
    assert got["host_us_after_k5"] == pytest.approx((195.0 + 95.0) / 2)


@pytest.mark.parametrize("case", [
    dict(drop="k5.launch"), dict(drop="hnsw.results.copy"),
    dict(drop="hnsw.search"),
    dict(extra=[_x("kernel", K5, 3700.0, 100.0)])])
def test_spans_and_kernels_that_do_not_pair_read_nothing(tmp_path, case):
    tr = _load(tmp_path, program_trace(**case))
    assert spans.calls(tr) is None
    assert _read(tr) == dict.fromkeys(READERS)


def test_no_trace_or_no_k5_reads_nothing(tmp_path):
    assert _read(None) == dict.fromkeys(READERS)
    ev = program_trace()
    ev["traceEvents"] = [e for e in ev["traceEvents"]
                         if e["cat"] != "kernel"]
    assert _read(_load(tmp_path, ev)) == dict.fromkeys(READERS)


def test_a_program_without_the_spans_is_read_between_the_call_ranges(
        tmp_path):
    """The trace of a program older than the spans: each call's
    ``portbench.call`` range stands for its spans (K5 from 200 to 800 us
    of a 1,000 us call)."""
    got = _read(_load(tmp_path, recorded_trace()))
    assert got["host_us_before_k5"] == pytest.approx(200.0)
    assert got["host_us_after_k5"] == pytest.approx(200.0)


def test_every_accepted_cell_reports_both():
    for w in json.load(open(os.path.join(cells.ROOT,
                                         "BENCHMARK.json")))["workloads"]:
        names = {m["name"] for m in cells.load(w["name"]).per_layer}
        assert set(READERS) <= names, w["name"]


def test_the_program_names_its_spans_as_the_readers_do(tmp_path):
    """A CPU trace of the program's search holds one ``hnsw.search`` and
    one ``hnsw.results.copy`` span a call; the launch's span is named in
    K5's wrapper (the CPU runs the plain version, not K5)."""
    from hnsw_tpu_torch import Graph
    from hnsw_tpu_torch.ops import graph_search
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((400, 8)).astype(np.float32)
    g = Graph(metric="l2", device="cpu")
    g.build(list(range(400)), rows, method="device", wave=256)
    q = rng.standard_normal((40, 8)).astype(np.float32)
    path = str(tmp_path / "p.json")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for _ in range(3):
                with torch.profiler.record_function(trace.CALL):
                    g.batch_search_slots(q, 5)
    prof.export_chrome_trace(path)
    tr = trace.load(path)
    assert len(tr.calls) == 3
    assert len(spans._named(tr, spans.SEARCH)) == 3
    assert len(spans._named(tr, spans.COPY)) == 3
    with open(graph_search.__file__) as f:
        assert f'span("{spans.LAUNCH}")' in f.read()
