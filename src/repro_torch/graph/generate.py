"""Synthetic graph generators (paper Section 7, 'Synthetic data').

The paper's generator is controlled by |V|, |E| and |L|.  The same seed
gives the same graph as the reference package's generator.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph


def erdos_renyi(n: int, m: int, n_labels: int = 8, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    labels = rng.integers(0, n_labels, size=n).astype(np.int32)
    return Graph(n, src, dst, labels)
