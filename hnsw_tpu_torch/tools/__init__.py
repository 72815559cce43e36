"""Drivers that measure the port: ``python3 -m hnsw_tpu_torch.tools.bench``
(the headline JSON line), ``.sweep`` (the configuration sweep and K1's
roofline ladder), ``.entry`` (one graph-search step), ``.datasets`` (the
sweep's loaders) and ``screen_split.py`` (K1's time by part)."""
