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
