"""K5's device time a query: the ``graph_search_kernel`` events of the
window summed, in microseconds, over the queries answered (K5 kernel
layer; moves qps). Nothing where K5 did not run."""

KERNEL = "graph_search_kernel"


def read(ctx):
    tr = ctx.get("trace")
    ks = [] if tr is None else tr.kernels(KERNEL)
    if not ks or not ctx["queries"]:
        return None
    return sum(e - s for s, e, _, _ in ks) * 1e6 / ctx["queries"]
