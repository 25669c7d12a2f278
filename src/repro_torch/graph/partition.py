"""Graph partitioners.

The paper imposes no constraints on fragmentation (Section 2.1) and its
experiments use random partitioning; partition quality only affects
|V_f|.  Random, hash and contiguous-block partitioners, and the greedy
BFS one, an edge-cut heuristic; :func:`cut_stats` measures a cut.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph, csr_from_coo


def random_partition(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=g.n).astype(np.int32)


def hash_partition(g: Graph, k: int) -> np.ndarray:
    """Multiplicative hash of the node id, modulo k."""
    return (np.arange(g.n, dtype=np.int64) * 2654435761 % 2**32
            % k).astype(np.int32)


def block_partition(g: Graph, k: int) -> np.ndarray:
    """Contiguous index blocks (good for generators that grow locally)."""
    return np.minimum(np.arange(g.n) * k // max(g.n, 1),
                      k - 1).astype(np.int32)


def bfs_partition(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    """Greedy BFS blocks: grow fragments along edges to shrink the cut."""
    rng = np.random.default_rng(seed)
    indptr, indices = csr_from_coo(g.n, g.src, g.dst)
    part = np.full(g.n, -1, dtype=np.int32)
    target = (g.n + k - 1) // k
    cur = 0
    count = 0
    order = rng.permutation(g.n)
    queue: list[int] = []
    oi = 0
    while cur < k:
        if not queue:
            while oi < g.n and part[order[oi]] >= 0:
                oi += 1
            if oi >= g.n:
                break
            queue.append(int(order[oi]))
        u = queue.pop(0)
        if part[u] >= 0:
            continue
        part[u] = cur
        count += 1
        if count >= target:
            cur, count, queue = cur + 1, 0, []
            continue
        for v in indices[indptr[u] : indptr[u + 1]]:
            if part[v] < 0:
                queue.append(int(v))
    part[part < 0] = k - 1
    return part


def cut_stats(g: Graph, part: np.ndarray) -> dict:
    """Cross edges of the cut, and the distinct in-nodes they land on
    (``in_nodes`` and ``v_f``, |V_f| before any spare slots)."""
    cross = part[g.src] != part[g.dst]
    v_f = int(np.unique(g.dst[cross]).size)
    return {"cross_edges": int(cross.sum()), "in_nodes": v_f, "v_f": v_f}
