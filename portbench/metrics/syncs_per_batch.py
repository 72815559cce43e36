"""The host's waits for the card a call: ``cudaStreamSynchronize`` and
``cudaDeviceSynchronize`` runtime calls in the window over the calls
(search API layer; moves qps)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx["calls"] or not tr.kernels():
        return None
    return tr.syncs / ctx["calls"]
