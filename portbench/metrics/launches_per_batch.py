"""Kernel launches a call: the trace's kernel events in the window over
the calls (search API layer; moves qps)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx["calls"] or not tr.kernels():
        return None
    return len(tr.kernels()) / ctx["calls"]
