#!/usr/bin/env python3
"""Where the exact and capacity screens' time goes, on one NVIDIA GPU.

    python3 hnsw_tpu_torch/tools/screen_split.py [--out DIR] [--capacity]
                                                 [--root OTHER_CHECKOUT]

Builds csrc/exact_screen.cu four times, at once (one nvcc each): as
shipped and with parts of the screens compiled out (``-DSPLIT_NO_SELECT``,
``-DSPLIT_NO_EPILOGUE``, ``-DSPLIT_NO_PRODUCT``: guards in the source, in
``screen_wgmma_kernel`` and in ``screen_ws_kernel``), and times each
build's screen (Q=1024, l2; median of 5 CUDA-event reps):

* full: the kernel as shipped;
* no selection: the epilogue still computes every distance (and, in
  ``screen_ws_kernel``, flags those at or below their row's worst);
* staging + product: no epilogue and no selection;
* staging: no epilogue, no selection and no wgmma (the copies, the
  conversion passes and the barriers alone).

The differences split the time into staging, product, epilogue and
selection, printed per case beside its bound (``utils/roofline.
screen_bound_s``, the smoke's).

Without ``--capacity`` the cases are K1's, f32 and fast_math at
k_sel = 18, at two shapes (``SHAPES``): the exact tier's (N=1,048,576,
D=128) through the TMA producer (route "wgmma"), and glove-50's
(N=1,183,514, D=50) through the cp.async producer ("wgmma_cp"). With
``--capacity``: K1 at the first shape only (the yardstick that another
checkout's K1 holds), then the capacity screen at the same shape
(``CAPACITY_CASES``: int8 at kk 26, bf16 and fp16 at 14, int8 at 150)
through every route the checkout has for it ("bf16_ws" where
``ws_applies``, and K1's kernel with the table's store, "wgmma"), with
ptxas's registers and spills of each screen instantiation and blocks an
SM at kk 14 / 26 / 150 / 256.

``--root``: time another checkout's kernels (e.g. a parent commit
unpacked with ``git archive`` into a gitignored directory): its package is
imported from there and its source built, through the interface both
share. The variants' results are wrong by design; only their times mean
anything. Needs nvcc and a CUDA card; the builds go to ``--out`` (default
build/screen_split).
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

#: variant -> the parts of the screens compiled out
VARIANTS = {"full": (), "no selection": ("SELECT",),
            "staging + product": ("SELECT", "EPILOGUE"),
            "staging": ("SELECT", "EPILOGUE", "PRODUCT")}
#: (label, N, D, route) of K1's timed screens, Q=1024 each
SHAPES = (("SIFT1M shape", 1 << 20, 128, "wgmma"),
          ("GloVe-50 shape", 1_183_514, 50, "wgmma_cp"))
#: (store, kk) of the capacity screen's timed cases at SHAPES[0]: the
#: k = 10 pools of the int8 and the 16-bit rungs, and int8 at k = 100
CAPACITY_CASES = (("int8", 26), ("bf16", 14), ("fp16", 14), ("int8", 150))
#: the kk at which blocks an SM are printed
OCCUPANCY_KK = (14, 26, 150, 256)
_KERNEL = re.compile(r"(screen_wgmma_kernel|screen_ws_kernel)ILi(\d)E"
                     r"(?:Li(\d)E)?")
_STORE_NAMES = ("float32", "fast_math", "int8", "bf16", "fp16")
_ROUTE_NAMES = {"1": "wgmma", "2": "wgmma_cp", "3": "wgmma_ld"}


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


def parse_ptxas(text: str) -> dict:
    """ptxas's ``-v`` report -> {"<store>/<route>": {"registers",
    "spill_stores", "spill_loads"}}, one entry a screen instantiation
    (screen_ws_kernel's route is "bf16_ws")."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            k = _KERNEL.search(m.group(1))
            name = None
            if k:
                route = ("bf16_ws" if k.group(1) == "screen_ws_kernel"
                         else _ROUTE_NAMES[k.group(3)])
                name = f"{_STORE_NAMES[int(k.group(2))]}/{route}"
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def _build(es, out_dir: str, parts) -> str:
    """nvcc of ``es``'s source with ``SPLIT_NO_<part>`` defined into
    ``out_dir`` (the flags of ``es.build``), unless a build there is newer
    than the source; returns ptxas's report."""
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libexact_screen.so")
    report = os.path.join(out_dir, "exact_screen.ptxas.txt")
    if (os.path.exists(so) and os.path.exists(report)
            and os.path.getmtime(so) >= os.path.getmtime(es.SOURCE)):
        with open(report) as f:
            return f.read()
    cmd = [es._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", *(f"-DSPLIT_NO_{p}" for p in parts), es.SOURCE,
           "-o", so]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    with open(report, "w") as f:
        f.write(res.stderr)
    return res.stderr


def _blocks(lib, route: int, d: int, kk: int, store: int) -> int:
    """Blocks an SM through either library interface (before the bf16_ws
    route the call took no D)."""
    if len(lib.exact_screen_blocks_per_sm.argtypes) == 4:
        return lib.exact_screen_blocks_per_sm(route, d, kk, store)
    return lib.exact_screen_blocks_per_sm(route, kk, store)


def _cap_tables(v: torch.Tensor) -> dict:
    """The capacity modes' tables of ``v``, as ExactIndex makes them."""
    amax = v.abs().amax(dim=1)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return {"int8": (torch.clamp(torch.round(v / s[:, None]), -127,
                                 127).to(torch.int8), s),
            "bf16": (v.to(torch.bfloat16), None),
            "fp16": (v.to(torch.float16), None)}


def _cases(es, capacity: bool, g) -> list:
    """[(label, route, kind, run, bound_ms)]: each timed screen."""
    from hnsw_tpu_torch.utils.roofline import screen_bound_s
    out = []
    for label, n, d, route in SHAPES[:1] if capacity else SHAPES:
        v = torch.randn((n, d), generator=g, device="cuda")
        q = torch.randn((1024, d), generator=g, device="cuda")
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        sq = (v * v).sum(-1)
        for fast in (False, True):
            bound = screen_bound_s(1024, n, d, 18, fast)[0] * 1e3
            out.append((f"{label}, {'fast_math' if fast else 'f32'} k_sel "
                        f"18", route, ("k1", int(fast), d, 18),
                        (lambda q=q, v=v, sq=sq, valid=valid, fast=fast,
                         route=route: es._screen_cuda(
                             q, v, sq, valid, 18, "l2", fast, route)),
                        bound))
        if not capacity:
            continue
        tables = _cap_tables(v)
        for store, kk in CAPACITY_CASES:
            t, s = tables[store]
            routes = [r for r in ("bf16_ws", "wgmma")
                      if r in es.CAPACITY_ROUTES and (
                          r != "bf16_ws" or es.ws_applies(d, kk, store))]
            bound = screen_bound_s(1024, n, d, kk, store=store)[0] * 1e3
            for r in routes:
                out.append((f"{label}, {store} kk {kk}", r,
                            ("cap", es.STORES[store], d, kk),
                            (lambda q=q, t=t, s=s, sq=sq, valid=valid,
                             kk=kk, r=r: es._capacity_cuda(
                                 q, t, s, sq, valid, kk, "l2", r)),
                            bound))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--capacity", action="store_true")
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    sys.path.insert(0, root)
    from hnsw_tpu_torch.ops import exact_screen as es
    if not torch.cuda.is_available():
        print("screen_split: needs a CUDA card", file=sys.stderr)
        return 2
    out = args.out or os.path.join(os.path.dirname(es.BUILD_DIR),
                                   "screen_split")
    dirs = {name: os.path.join(out, name.replace(" ", "_").replace("+", ""))
            for name in VARIANTS}
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        reports = dict(zip(VARIANTS, pool.map(
            lambda kv: _build(es, dirs[kv[0]], kv[1]), VARIANTS.items())))
    print(f"# {torch.cuda.get_device_name(0)}; screens of {es.SOURCE} at "
          f"Q=1024, l2, median of 5 CUDA-event reps", flush=True)
    for name, regs in sorted(parse_ptxas(reports["full"]).items()):
        print(f"  ptxas {name}: {regs.get('registers')} registers, "
              f"{regs.get('spill_stores', 0)} B spill stores, "
              f"{regs.get('spill_loads', 0)} B spill loads")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = _cases(es, args.capacity, g)
    ms = {}
    for name in VARIANTS:
        es.BUILD_DIR = dirs[name]
        es._lib = None
        lib = es._load()
        for label, route, kind, run, _ in cases:
            ms[name, label, route] = cuda_ms(run)
            blocks = ""
            if name == "full":
                code = (es.ROUTES if kind[0] == "k1"
                        else es.CAPACITY_ROUTES)[route]
                blocks = (f" ({_blocks(lib, code, kind[2], kind[3], kind[1])}"
                          f" blocks/SM)")
            print(f"  {name}, {label}, {route}: "
                  f"{ms[name, label, route]:.3f} ms{blocks}", flush=True)
        if name == "full" and args.capacity:
            for store in ("int8", "bf16", "fp16"):
                for route in ("bf16_ws", "wgmma"):
                    if route not in es.CAPACITY_ROUTES or (
                            route == "bf16_ws" and store == "fp16"):
                        continue
                    per = [_blocks(lib, es.CAPACITY_ROUTES[route], 128, kk,
                                   es.STORES[store]) for kk in OCCUPANCY_KK]
                    print(f"  blocks/SM at D=128, {store} {route}, kk "
                          f"{'/'.join(map(str, OCCUPANCY_KK))}: "
                          f"{'/'.join(map(str, per))}", flush=True)
    print("# split (ms): staging / product / epilogue / selection = full")
    for label, route, _, _, bound in cases:
        t = [ms[v, label, route] for v in VARIANTS]
        full, no_sel, stage_prod, stage = t
        print(f"  {label}, {route}: {stage:.3f} / "
              f"{stage_prod - stage:.3f} / {no_sel - stage_prod:.3f} / "
              f"{full - no_sel:.3f} = {full:.3f}; bound {bound:.3f} ms "
              f"({bound / full:.3f} of it)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
