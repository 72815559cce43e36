"""utils/profiling of the port against hnsw_tpu/utils/profiling.py.

``Timer.report()`` equals JAX's for the same sections, with
``time.perf_counter`` replaced in both modules by the same scripted
clock; ``device_trace`` writes a Chrome trace holding the name that
``annotate`` gave a function (here the CPU activity only).
"""

import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.utils import profiling as jprof  # noqa: E402

from hnsw_tpu_torch.utils import profiling  # noqa: E402

#: (section, start, end) in clock seconds
SECTIONS = [("scan", 0.0, 0.0123), ("merge", 1.0, 1.5), ("scan", 2.0, 2.2),
            ("rerank", 3.0, 3.00001), ("scan", 4.0, 4.0)]


def _report(mod, monkeypatch):
    ticks = iter(t for _, a, b in SECTIONS for t in (a, b))
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
    timer = mod.Timer()
    for name, _, _ in SECTIONS:
        with timer.section(name):
            pass
    return timer.report()


def test_timer_report_equals_jax(monkeypatch):
    got = _report(profiling, monkeypatch)
    want = _report(jprof, monkeypatch)
    assert got == want
    assert got["scan"]["count"] == 3


def test_timer_counts_a_section_that_raises():
    timer = profiling.Timer()
    with pytest.raises(ValueError):
        with timer.section("boom"):
            raise ValueError
    assert timer.report()["boom"]["count"] == 1


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
