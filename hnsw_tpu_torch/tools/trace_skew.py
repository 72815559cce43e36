"""How far torch.profiler misplaces the card's kernels, and what a trace
loses (the reason for ``utils/profiling.PAD_S``).

    python3 -m hnsw_tpu_torch.tools.trace_skew [--seconds 60]

Rounds until ``--seconds`` have passed: one K1 exact scan (1,000
queries over 1,048,576 x 128 rows) to keep the card busy, then two
traces of one 512 x 512 product: a bare ``torch.profiler`` session that
starts the product at once, and, right after an empty session (no device
work: the kind after which a short session loses its kernel records),
``utils/profiling.device_trace`` (padded by ``PAD_S``). Prints, for
each, the share of traces that kept the product's kernel, and the
kernel's start minus its ``aten::mm`` op's start (min / median / max
microseconds): a launch on an idle card starts within
tens of microseconds, so the rest is the skew. Then the same, a line for
each minute of the run, to show how the skew moves as the process ages.
Needs the CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch


def _skew_us(path: str):
    """(kernel events, first kernel start - first aten::mm start in us or
    None) of a Chrome trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kern = [e["ts"] for e in events if e.get("cat") == "kernel"]
    mm = [e["ts"] for e in events if e.get("name") == "aten::mm"]
    return len(kern), (min(kern) - min(mm) if kern and mm else None)


def main(argv=None) -> int:
    from hnsw_tpu_torch.ops.exact_screen import exact_scan
    from hnsw_tpu_torch.utils.profiling import PAD_S, device_trace
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=60.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_skew: no CUDA device is available")
    gen = torch.Generator(device="cuda").manual_seed(0)
    v = torch.randn((1 << 20, 128), generator=gen, device="cuda")
    q = torch.randn((1000, 128), generator=gen, device="cuda")
    sq, ok = (v * v).sum(1), torch.ones(1 << 20, dtype=torch.bool,
                                        device="cuda")
    x = torch.randn((512, 512), generator=gen, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # (minute of the run, trace kind, kept the kernel, skew us or None)
    seen = []
    rounds = 0
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            exact_scan(q, v, sq, ok, k=10, metric="cosine")
            torch.cuda.synchronize()
            bare = os.path.join(td, "bare.json")
            with torch.profiler.profile(activities=acts) as prof:
                x @ x
                torch.cuda.synchronize()
            prof.export_chrome_trace(bare)
            with torch.profiler.profile(activities=acts):
                pass
            padded = os.path.join(td, "padded")
            try:
                with device_trace(padded):
                    x @ x
            except RuntimeError:
                pass                      # no kernel event: counted lost
            minute = int((time.perf_counter() - t0) // 60)
            for name, path in (("bare", bare), ("device_trace", padded)):
                paths = ([path] if path.endswith(".json") else
                         [os.path.join(path, p) for p in os.listdir(path)])
                for p in paths:
                    n, skew = _skew_us(p)
                    seen.append((minute, name, n > 0, skew))
                    os.remove(p)
            rounds += 1
    print(f"# {torch.cuda.get_device_name(0)}; {rounds} rounds in "
          f"{args.seconds:g} s; PAD_S {PAD_S}")
    _report(seen, "all")
    for m in sorted({m for m, _, _, _ in seen}):
        _report([x for x in seen if x[0] == m], f"minute {m}")
    return 0


def _report(seen, label: str) -> None:
    """One line a trace kind: traces that kept the kernel, and the skew
    (min / median / max us) of those that did."""
    for name in ("bare", "device_trace"):
        mine = [(k, s) for _, n, k, s in seen if n == name]
        s = [x for _, x in mine if x is not None]
        spread = (f"{min(s):.1f} / {statistics.median(s):.1f} / "
                  f"{max(s):.1f}" if s else "n/a")
        print(f"  {label}, {name}: kept the kernel in "
              f"{sum(k for k, _ in mine)} of {len(mine)} traces; kernel "
              f"start - op start, us (min / median / max): {spread}",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
