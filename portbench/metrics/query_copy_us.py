"""The host's time a call in the runtime call that copies the call's
queries to the card (8,192 x 1,536 float32 = 50.3 MB in the 1,536-wide
cell; pageable, so the host is held while the runtime stages it), in
microseconds, averaged over the window's calls (search API layer; moves
qps).

The copy is the first ``cudaMemcpyAsync`` runtime call inside each of the
benchmark's own ``trace.CALL`` ranges: the program copies the queries
before any other work on the card (inside its ``hnsw.query_copy`` span),
and the answers come back after the search. Nothing where no call holds
such a copy."""

COPY_CALL = "cudaMemcpyAsync"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx["calls"]:
        return None
    copies = sorted((s, e) for s, e, n in tr.host if n == COPY_CALL)
    firsts = []
    for c0, c1 in tr.calls:
        inside = [(s, e) for s, e in copies if c0 <= s <= c1]
        if inside:
            firsts.append(inside[0])
    if not firsts:
        return None
    return sum(e - s for s, e in firsts) * 1e6 / ctx["calls"]
