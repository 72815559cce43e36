"""The wave builder's rate in set-up: the configuration's rows over the
wall seconds of ``Graph.build(method="device")``, the card synchronised
before and after (build layer; moves setup_s). Its spread over runs is
too wide for an end-to-end bound (PERF.md), so it is read here."""


def read(ctx):
    if not ctx.get("build_s"):
        return None
    return ctx["rows"] / ctx["build_s"]
