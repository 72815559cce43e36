"""The host's time in a call before K5 starts: the start of the call's K5
(no earlier than its ``k5.launch`` span) less the start of its
``hnsw.search`` span, in microseconds, averaged over the window's calls
(search API layer; moves qps). It holds the checks, the query copy,
``q_sq`` and the launch: what the card waits through before the search.
Nothing where the spans and K5's kernels do not pair (``portbench.spans``).
"""

from portbench import spans


def read(ctx):
    cs = spans.calls(ctx.get("trace"))
    if not cs:
        return None
    return spans.mean_us([c.k5_bounded[0] - c.start for c in cs])
