"""Seeded synthetic graphs — a copy of ``powerlaw_graph`` from
``nebula_tpu/tools/scale_bench.py:35``, so the port's smoke run makes
its data from a seed without importing the reference."""
from __future__ import annotations

import numpy as np


def powerlaw_graph(n: int, m: int, alpha: float, max_deg: int, seed: int):
    """(src, dst) int64 arrays of vids 1..n: out-degrees ~ Zipf(alpha)
    capped at ``max_deg``, dst uniform.  Vectorized: sample a degree
    per vertex, trim/grow to m total, then np.repeat."""
    rng = np.random.default_rng(seed)
    deg = rng.zipf(alpha, n).astype(np.int64)
    deg = np.minimum(deg, max_deg)
    total = int(deg.sum())
    if total > m:       # trim uniformly
        drop = rng.choice(total, total - m, replace=False)
        src_all = np.repeat(np.arange(1, n + 1, dtype=np.int64), deg)
        src = np.delete(src_all, drop)
    else:               # top up with uniform extra edges
        src_all = np.repeat(np.arange(1, n + 1, dtype=np.int64), deg)
        extra = rng.integers(1, n + 1, m - total, dtype=np.int64)
        src = np.concatenate([src_all, extra])
    dst = rng.integers(1, n + 1, m, dtype=np.int64)
    return src, dst
