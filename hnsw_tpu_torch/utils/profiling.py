"""Profiling and tracing hooks (port of hnsw_tpu/utils/profiling.py).

Device traces come from ``torch.profiler`` (Chrome trace files, viewable
in Perfetto or chrome://tracing). The program names its own work in them
with ``span``: a ``record_function`` range while a profiler session
records, on the trace's host clock (the clock the trace places the
card's kernels on), and nothing at all otherwise.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import json
import os
import tempfile
import time
from typing import Dict, Iterator, Optional

import torch


#: idle seconds a CUDA trace keeps before and after its block. After a
#: short profiler session (one with no device work above all), the next
#: short session's kernel records reach the trace late or not at all,
#: and that lasts until a session runs for a few seconds; a session of
#: about four seconds or more kept them (``tools/trace_skew.py`` opens
#: such an empty session before each padded trace and counts what the
#: trace kept). The profiler also places kernels on the host clock with
#: a skew of milliseconds, which the pad covers too.
PAD_S = 2.5


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (CPU activity, plus the
    CUDA activity when a card is present) and write a Chrome trace,
    ``trace_<pid>_<ns>.json``, into ``log_dir``. On the card the window
    is padded by ``PAD_S`` on both sides. Raises RuntimeError when the
    CUDA activity was asked for and the trace holds no kernel event: an
    empty device trace would read as zero device time."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            time.sleep(PAD_S)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
                time.sleep(PAD_S)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if cuda and not kernel_events(path):
        raise RuntimeError(f"device_trace: {path} holds no CUDA kernel "
                           f"event; the profiler recorded no device work")


#: the Chrome trace categories of device work: kernels, copies, sets
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(path: str) -> list:
    """The device work in a Chrome trace ``device_trace`` wrote, as
    (category, name, microseconds) in trace order."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [(e["cat"], e.get("name", ""), float(e.get("dur", 0)))
            for e in events if e.get("cat") in DEVICE_CATEGORIES]


def host_syncs(path: str) -> int:
    """The host's waits for the card in a Chrome trace ``device_trace``
    wrote: its ``cudaStreamSynchronize`` runtime calls (every ``.cpu()``,
    ``.item()`` or ``int()`` of a card tensor; ``trace_summary``'s own
    ``torch.cuda.synchronize`` is a ``cudaDeviceSynchronize`` and is not
    counted)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(e.get("cat") == "cuda_runtime"
               and e.get("name") == "cudaStreamSynchronize" for e in events)


def kernel_events(path: str) -> int:
    """The CUDA kernel events in a Chrome trace ``device_trace`` wrote."""
    return sum(cat == "kernel" for cat, _, _ in device_events(path))


def trace_summary(fn) -> Optional[dict]:
    """One call of ``fn`` inside ``device_trace`` (a temporary directory):
    its wall ms on the host clock (to the card's sync), the device ms of
    its kernels, copies and sets, its kernel launches, the device's idle
    share of the wall, the device ms by event name (``by_name``), the
    kernel launches by name (``launches_by_name``), the copies and sets by
    name (``copies``) and the host's waits for the card (``syncs``,
    ``host_syncs``). None when the card recorded no kernel event
    (``device_trace`` raised): a trace that lost its events would give a
    false split."""
    cuda = torch.cuda.is_available()
    with tempfile.TemporaryDirectory() as td:
        try:
            with device_trace(td):
                t0 = time.perf_counter()
                fn()
                if cuda:
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        except RuntimeError as e:
            if "no CUDA kernel event" not in str(e):
                raise
            return None
        paths = sorted(glob.glob(os.path.join(td, "*.json")))
        events = [e for path in paths for e in device_events(path)]
        syncs = sum(host_syncs(path) for path in paths)
    by_name: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    copies: Dict[str, int] = {}
    for cat, name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
        counts = launches if cat == "kernel" else copies
        counts[name] = counts.get(name, 0) + 1
    device_ms = sum(by_name.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "launches": sum(launches.values()),
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms) if wall_ms
            else 0.0, "by_name": by_name, "launches_by_name": launches,
            "copies": copies, "syncs": syncs}


#: what ``span`` returns while no profiler session records: one shared,
#: reusable context that does nothing
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that names its block ``name`` in a ``torch.profiler``
    trace: ``record_function(name)`` while a session records, else a
    shared do-nothing context. The gate is the profiler's own flag, so a
    span costs a function call and one check with the profiler off (a
    bare ``record_function`` enters the dispatcher even then). Spans keep
    no time of their own: their times are the trace's."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def annotate(name: str):
    """Decorator that runs a function inside ``span(name)``: the name
    shows up as a range in ``device_trace`` profiles."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with span(name):
                return fn(*a, **k)
        return wrapper

    return deco
