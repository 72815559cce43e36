"""The share of the measured window (the trace's pads left out) in which
no kernel, copy or set ran on the card (device layer; moves qps)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.kernels() or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s() / tr.window_s
