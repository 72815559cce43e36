"""Runnable tours of the port (counterparts of the repo's ``examples/``).

    python3 -m hnsw_tpu_torch.examples.quickstart [--cpu] [--small]

and likewise ``hybrid_and_facets``, ``disk_and_scale``, ``serving_ops``,
``multichip`` and ``large_scale``. Each module's ``main(device=None,
small=False)`` runs on the CUDA card (or raises without one) unless
``device="cpu"``; ``small=True`` shrinks the data. Each prints what it
does and checks its answers: a failed check raises ``AssertionError``.
"""

from __future__ import annotations

import argparse


def check(ok: bool, what: str) -> None:
    """Print ``ok: what``, or raise when ``ok`` is false."""
    if not ok:
        raise AssertionError(f"check failed: {what}")
    print(f"ok: {what}", flush=True)


def cli(main, doc: str) -> None:
    """Run an example's ``main`` from the command line."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--small", action="store_true", help="smaller data")
    args = ap.parse_args()
    main(device="cpu" if args.cpu else None, small=args.small)
