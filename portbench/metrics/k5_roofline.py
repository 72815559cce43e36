"""K5's share of its roofline, in %: the least time the H100 could take
for the search of one batch (``roofline.search_bound_s`` over the work
that the reference's own walk of that batch counts) over K5's mean device
time in the window's calls of that batch (K5 kernel layer; moves qps).

The i-th call's K5 time is its share of the ``graph_search_kernel``
events in order (the same number of launches a call). Nothing where K5
did not run or its launches do not divide among the calls."""

KERNEL = "graph_search_kernel"


def read(ctx):
    tr = ctx.get("trace")
    ks = [] if tr is None else tr.kernels(KERNEL)
    calls = ctx["calls"]
    if not ks or "bound_s" not in ctx or len(ks) % calls:
        return None
    per = len(ks) // calls
    times = [sum(e - s for s, e, _, _ in ks[i * per:(i + 1) * per])
             for i, b in enumerate(ctx["call_batches"])
             if b == ctx["bound_batch"]]
    if not times:
        return None
    return 100.0 * ctx["bound_s"] / (sum(times) / len(times))
