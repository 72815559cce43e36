"""The device trace of a window, and what is read from it.

``device_trace`` is a frozen copy of the program's
``utils/profiling.device_trace``: ``torch.profiler`` with the CPU and CUDA
activities, padded by ``PAD_S`` idle seconds on both sides. The pad is
there because after a short profiler session the next short session's
kernel records reach the trace late or not at all, until a session has
run for a few seconds; and because the profiler places kernels on the host
clock with a skew of milliseconds. The window itself is marked in the
trace by a ``record_function`` range (``WINDOW``), so every reading below
is taken inside it and the pads never count.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

PAD_S = 2.5
#: the ranges that mark the measured window, each call, and the client's
#: own work between calls
WINDOW = "portbench.window"
CALL = "portbench.call"
CLIENT = "portbench.client"
#: the Chrome trace categories of device work: kernels, copies, sets
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the runtime calls in which the host waits for the card
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
#: host-side categories that say what the host was doing during a gap
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")
#: host events searched back from a gap's middle for one that spans it
_LOOK_BACK = 512


@contextlib.contextmanager
def device_trace(path: str) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (CPU and, on a card,
    CUDA activity), padded by ``PAD_S`` on both sides on a card, and
    write the Chrome trace to ``path``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            time.sleep(PAD_S)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
                time.sleep(PAD_S)
    prof.export_chrome_trace(path)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters: ``graph_search_kernel``."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.rsplit("::", 1)[-1].strip() or name


class Trace:
    """The events of one window of a Chrome trace. Times in seconds on the
    trace's clock. ``device``: (start, end, category, short name) of each
    kernel, copy and set; ``host``: (start, end, name) of each host-side
    event; ``calls``: (start, end) of each ``CALL`` range; ``syncs``: the
    runtime calls in which the host waited for the card."""

    def __init__(self, events: List[dict]):
        spans = [e for e in events if e.get("ph") == "X"]
        win = [e for e in spans if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if len(win) != 1:
            raise ValueError(f"the trace holds {len(win)} window ranges")
        self.t0 = float(win[0]["ts"]) / 1e6
        self.t1 = self.t0 + float(win[0]["dur"]) / 1e6

        def inside(e):
            s = float(e["ts"]) / 1e6
            return self.t0 <= s <= self.t1

        def span(e):
            s = float(e["ts"]) / 1e6
            return s, s + float(e.get("dur", 0)) / 1e6

        self.device = sorted((*span(e), e["cat"], short_name(e["name"]))
                             for e in spans
                             if e.get("cat") in DEVICE_CATEGORIES
                             and inside(e))
        self.host = [(*span(e), e["name"]) for e in spans
                     if e.get("cat") in HOST_CATEGORIES and inside(e)
                     and e["name"] != WINDOW]
        self.calls = sorted(span(e) for e in spans if e.get("name") == CALL
                            and e.get("cat") == "user_annotation"
                            and inside(e))
        self.syncs = sum(e.get("cat") == "cuda_runtime"
                         and e.get("name") in SYNCS and inside(e)
                         for e in spans)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernels(self, name: Optional[str] = None) -> List[Tuple]:
        return [e for e in self.device if e[2] == "kernel"
                and (name is None or e[3] == name)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events' intervals, clipped to the
        window, in order."""
        out: List[List[float]] = []
        for s, e, _, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_ops(self, top: int = 10) -> List[List]:
        """[[name, seconds], ...]: the device operations that took most
        time in the window, by short name."""
        by: Dict[str, float] = {}
        for s, e, _, name in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[[name, seconds], ...]: the window's idle time on the device
        (no kernel, copy or set) by what the host was doing then: each
        gap is named by the innermost host event that spans its middle
        ("host" where none does), and the seconds are summed by name."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by: Dict[str, float] = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            name = "host"
            # host events nest, so the innermost one that spans the middle
            # is the latest to start; look a bounded way back for it
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - _LOOK_BACK), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            by[name] = by.get(name, 0.0) + (e - s)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]


def load(path: str) -> Trace:
    with open(path) as f:
        return Trace(json.load(f).get("traceEvents", []))


def remove(path: str) -> None:
    with contextlib.suppress(FileNotFoundError):
        os.remove(path)
