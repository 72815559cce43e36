"""Each call's K5 in a window's trace, bounded by the program's own spans.

The program names its work with ``torch.profiler`` ranges
(``hnsw_tpu_torch/utils/profiling.span``), on the trace's host clock:
``SEARCH`` is the whole of ``Graph.batch_search_slots``, ``LAUNCH`` the
one call that launches K5, ``COPY`` the one device-to-host copy in which
the host waits for K5. The profiler places the card's kernels on that
clock with a skew of up to milliseconds, so a kernel can appear to start
before the call that launched it or to end after the copy that waited
for it. ``calls`` matches the i-th ``SEARCH`` span of the window with
the i-th ``graph_search_kernel`` (the run refuses a window where a call
did not launch K5 exactly once) and bounds that kernel by causality: it
starts no earlier than its ``LAUNCH`` span and ends no later than its
``COPY`` span.

A program without these spans (one older than them) is read between the
benchmark's own ``trace.CALL`` ranges: the call's range stands for all
three spans.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

SEARCH = "hnsw.search"
LAUNCH = "k5.launch"
COPY = "hnsw.results.copy"
KERNEL = "graph_search_kernel"


class Call(NamedTuple):
    """One call, in seconds on the trace's clock: its ``SEARCH`` span,
    the start of its ``LAUNCH`` span, the end of its ``COPY`` span, and
    its K5 as the trace places it."""
    start: float
    end: float
    launch: float
    copied: float
    k5_start: float
    k5_end: float

    @property
    def k5_bounded(self):
        """(start, end) of K5, bounded by ``launch`` and ``copied``."""
        return max(self.k5_start, self.launch), min(self.k5_end, self.copied)


def _named(tr, name: str) -> List[tuple]:
    return sorted((s, e) for s, e, n in tr.host if n == name)


def calls(tr) -> Optional[List[Call]]:
    """The window's calls in order, or None where there is no K5, or the
    numbers of ``SEARCH``, ``LAUNCH`` and ``COPY`` spans and of K5's
    kernels differ."""
    if tr is None:
        return None
    ks = tr.kernels(KERNEL)
    search = _named(tr, SEARCH)
    if search:
        launch, copy = _named(tr, LAUNCH), _named(tr, COPY)
    else:
        search = launch = copy = list(tr.calls)
    if not ks or not len(ks) == len(search) == len(launch) == len(copy):
        return None
    return [Call(s[0], s[1], la[0], c[1], k[0], k[1])
            for s, la, c, k in zip(search, launch, copy, ks)]


def mean_us(values: List[float]) -> float:
    return sum(values) * 1e6 / len(values)
