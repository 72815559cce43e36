#!/usr/bin/env python3
"""Where the wgmma screen's time goes, on one NVIDIA GPU.

    python3 hnsw_tpu_torch/tools/screen_split.py [--out DIR]

Builds csrc/exact_screen.cu three more times with parts of
``screen_wgmma_kernel`` compiled out (``-DSPLIT_NO_SELECT``,
``-DSPLIT_NO_EPILOGUE``, ``-DSPLIT_NO_PRODUCT``: guards in the source),
and times each build's screen (Q=1024, k_sel=18, l2; median of 5
CUDA-event reps), f32 and fast_math, at two shapes (``SHAPES``): the
exact tier's (N=1,048,576, D=128) through the TMA producer (route
"wgmma"), and glove-50's (N=1,183,514, D=50) through the cp.async
producer (route "wgmma_cp"):

* full: the kernel as shipped;
* no selection: the epilogue still writes the distance tile;
* staging + product: no epilogue and no selection;
* staging: no epilogue, no selection and no wgmma (the copies, the
  conversion pass and the barriers alone).

The differences split the time into staging, product, epilogue and
selection. Each mode's bound (``utils/roofline.screen_bound_s``, the
smoke's) is printed beside the split. The variants' results are wrong
by design; only their times mean anything. Needs nvcc and a CUDA card;
the builds go to ``--out`` (default build/screen_split).
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from hnsw_tpu_torch.ops import exact_screen as es  # noqa: E402
from hnsw_tpu_torch.utils.roofline import screen_bound_s  # noqa: E402

#: variant -> the parts of screen_wgmma_kernel compiled out
VARIANTS = {"full": (), "no selection": ("SELECT",),
            "staging + product": ("SELECT", "EPILOGUE"),
            "staging": ("SELECT", "EPILOGUE", "PRODUCT")}
#: (label, N, D, route) of the timed screens, Q=1024 each
SHAPES = (("SIFT1M shape", 1 << 20, 128, "wgmma"),
          ("GloVe-50 shape", 1_183_514, 50, "wgmma_cp"))


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(es.BUILD_DIR), "screen_split"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("screen_split: needs a CUDA card", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(0)
    data = []
    print(f"# {torch.cuda.get_device_name(0)}; screen at Q=1024 k_sel=18 "
          f"l2, median of 5 reps")
    for label, n, d, route in SHAPES:
        v = torch.randn((n, d), generator=g, device="cuda")
        q = torch.randn((1024, d), generator=g, device="cuda")
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        data.append((label, route, q, v, (v * v).sum(-1), valid))
        for fast in (False, True):
            bound_s, by, _ = screen_bound_s(1024, n, d, 18, fast)
            print(f"  bound, {label} N={n} D={d} ({route}), "
                  f"{'fast_math' if fast else 'f32'}: "
                  f"{bound_s * 1e3:.3f} ms ({by})")
    for name, parts in VARIANTS.items():
        es.BUILD_DIR = os.path.join(
            args.out, name.replace(" ", "_").replace("+", ""))
        es._lib = None
        es.build(tuple(f"SPLIT_NO_{p}" for p in parts))
        lib = es._load()
        for label, route, q, v, sq, valid in data:
            row = []
            for fast in (False, True):
                ms = cuda_ms(lambda: es._screen_cuda(
                    q, v, sq, valid, 18, "l2", fast, route))
                per_sm = lib.exact_screen_blocks_per_sm(es.ROUTES[route],
                                                        18, int(fast))
                row.append(f"{'fast_math' if fast else 'f32'} {ms:.3f} ms "
                           f"({per_sm} blocks/SM)")
            print(f"  {name}, {label} ({route}): " + ", ".join(row),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
