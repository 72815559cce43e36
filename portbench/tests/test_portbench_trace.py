"""The trace reader and the per-layer readers on a small trace in the
format ``torch.profiler``'s ``export_chrome_trace`` writes."""

import json

import pytest

from portbench import cells, trace

K5 = ("void graph_search_kernel<0, 0, 4>(GraphArgs, "
      "(anonymous namespace)::Ref const*)")


def _x(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur, "args": {}, **kw}


def recorded_trace():
    """Two calls of 1,000 us in a window of 3,000 us (microseconds, as the
    profiler writes them): each a copy in, two small kernels, K5, a copy
    out and one sync; a pad on each side holds work that never counts."""
    ev = [_x("kernel", K5, 10.0, 400.0),                  # in the pad
          _x("user_annotation", trace.WINDOW, 1000.0, 3000.0),
          _x("gpu_user_annotation", trace.WINDOW, 1000.0, 3000.0)]
    for c0 in (1000.0, 2500.0):
        ev += [_x("user_annotation", trace.CALL, c0, 1000.0),
               _x("cpu_op", "aten::to", c0 + 10, 100.0),
               _x("cuda_runtime", "cudaMemcpyAsync", c0 + 20, 10.0),
               _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)",
                  c0 + 50, 50.0),
               _x("kernel", "void at::native::vectorized_elementwise_kernel"
                  "<4, float>(int, float)", c0 + 150, 10.0),
               _x("kernel", "void at::native::reduce_kernel<512, 1>(int)",
                  c0 + 170, 10.0),
               _x("cuda_runtime", "cudaLaunchKernel", c0 + 190, 5.0),
               _x("kernel", K5, c0 + 200, 600.0),
               _x("cpu_op", "aten::copy_", c0 + 195, 700.0),
               _x("cuda_runtime", "cudaStreamSynchronize", c0 + 800, 110.0),
               _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
                  c0 + 810, 20.0)]
    ev.append(_x("cuda_runtime", "cudaDeviceSynchronize", 4500.0, 5.0))
    return {"traceEvents": ev + [{"ph": "M", "name": "process_name"}]}


@pytest.fixture
def tr(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(recorded_trace()))
    return trace.load(str(path))


def test_window_busy_and_idle(tr):
    assert tr.window_s == pytest.approx(3000e-6)
    assert len(tr.calls) == 2
    assert len(tr.kernels()) == 6
    assert len(tr.kernels("graph_search_kernel")) == 2
    assert tr.syncs == 2
    # 50 + 10 + 10 + 600 + 20 us a call
    assert tr.busy_s() == pytest.approx(2 * 690e-6)
    ops = dict(tr.device_ops())
    assert ops["graph_search_kernel"] == pytest.approx(1200e-6)
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(3000e-6 - 2 * 690e-6)
    assert gaps[trace.CALL] > 0          # between the calls' pieces


def test_short_name():
    assert trace.short_name(K5) == "graph_search_kernel"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") \
        == "Memcpy HtoD"


def test_readers(tr):
    ctx = dict(trace=tr, calls=2, queries=2 * 8192, call_batches=[0, 1],
               bound_batch=1, bound_s=30e-6, bound_by="bytes", rows=1000,
               build_s=0.5)
    read = {m: cells.reader(m)(ctx) for m in (
        "launches_per_batch", "syncs_per_batch", "k5_us_per_query",
        "k5_roofline", "device_idle_share", "build_vps.setup")}
    assert read["build_vps.setup"] == 2000
    assert read["launches_per_batch"] == 3
    assert read["syncs_per_batch"] == 1
    assert read["k5_us_per_query"] == pytest.approx(1200.0 / 16384)
    assert read["k5_roofline"] == pytest.approx(5.0)
    assert read["device_idle_share"] == pytest.approx(1 - 1380 / 3000)


def test_readers_find_nothing_without_a_trace_or_k5(tr):
    for m in ("launches_per_batch", "syncs_per_batch", "k5_us_per_query",
              "k5_roofline", "device_idle_share"):
        assert cells.reader(m)(dict(trace=None, calls=2, queries=10)) is None
    ctx = dict(trace=tr, calls=3, queries=10, call_batches=[0, 1, 0],
               bound_batch=0, bound_s=1.0)
    assert cells.reader("k5_roofline")(ctx) is None  # 2 launches, 3 calls


def test_a_listed_metric_that_reads_nothing_fails_the_run(tr, tmp_path):
    """A per-layer metric that the cell lists and whose reader finds
    nothing is a fault of the run, never a metric left out."""
    from portbench import run

    from .conftest import make_root
    root = make_root(tmp_path, "tiny.easy")
    cell = cells.load("tiny.easy", root)
    ctx = dict(trace=tr, calls=2, queries=2 * 8192, call_batches=[0, 1],
               bound_batch=1, bound_s=30e-6, rows=1000, build_s=0.5)
    assert set(run.read_per_layer(cell, ctx, root)) == {
        m["name"] for m in cell.per_layer}
    with pytest.raises(run.NotRunnable, match="k5_roofline"):
        run.read_per_layer(cell, dict(ctx, call_batches=[0, 0]), root)
    with pytest.raises(run.NotRunnable, match="launches_per_batch"):
        run.read_per_layer(cell, dict(ctx, trace=None), root)
