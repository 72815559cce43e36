"""The host's time in a call after K5 ends: the end of the call's
``hnsw.search`` span less the end of its K5 (no later than its
``hnsw.results.copy`` span), in microseconds, averaged over the window's
calls (search API layer; moves qps). It holds the copy of the answers,
the numpy views and casts. Nothing where the spans and K5's kernels do
not pair (``portbench.spans``).
"""

from portbench import spans


def read(ctx):
    cs = spans.calls(ctx.get("trace"))
    if not cs:
        return None
    return spans.mean_us([c.end - c.k5_bounded[1] for c in cs])
