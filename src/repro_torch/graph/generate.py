"""Synthetic graph generators (paper Section 7, 'Synthetic data').

The paper's generator is controlled by |V|, |E| and |L|.  Erdos-Renyi
uniform graphs, preferential-attachment (power-law) graphs, and a planted
labelled chain in noise, whose queries have known answers and long finite
distances.  The same seed gives the same graph as the reference package's
generator, array for array.
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


def preferential_attachment(n: int, m_per: int = 4, n_labels: int = 8,
                            seed: int = 0) -> Graph:
    """Power-law-ish digraph: each new node links to m_per earlier nodes,
    preferring high in-degree (densification-style growth)."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    weights = np.ones(n, dtype=np.float64)
    for v in range(1, n):
        k = min(m_per, v)
        p = weights[:v] / weights[:v].sum()
        targets = rng.choice(v, size=k, replace=False, p=p)
        for t in targets:
            srcs.append(v)
            dsts.append(int(t))
            weights[t] += 1.0
    labels = rng.integers(0, n_labels, size=n).astype(np.int32)
    return Graph(n, np.array(srcs, dtype=np.int64),
                 np.array(dsts, dtype=np.int64), labels)


def labeled_chain_graph(n_chain: int, n_noise_nodes: int, n_noise_edges: int,
                        chain_label: int, n_labels: int = 8,
                        seed: int = 0) -> Graph:
    """A planted labelled chain 0 -> 1 -> ... -> n_chain-1 (every interior
    node labelled ``chain_label``) in random noise: regular path queries
    along it have a witness, and its ends are ``n_chain - 1`` hops apart
    unless the noise makes a shortcut."""
    rng = np.random.default_rng(seed)
    n = n_chain + n_noise_nodes
    src = list(range(n_chain - 1))
    dst = list(range(1, n_chain))
    src += list(rng.integers(0, n, size=n_noise_edges))
    dst += list(rng.integers(0, n, size=n_noise_edges))
    labels = rng.integers(0, n_labels, size=n).astype(np.int32)
    labels[1:n_chain - 1] = chain_label
    return Graph(n, np.array(src, dtype=np.int64),
                 np.array(dst, dtype=np.int64), labels)
