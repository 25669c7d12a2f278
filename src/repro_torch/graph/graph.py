"""Host-side graph substrate (numpy).

Node-labelled directed graphs in COO form, per the paper (Section 2.1),
plus the BFS oracles that check answers on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Graph:
    """A node-labeled directed graph G = (V, E, L) in COO form."""

    n: int
    src: np.ndarray  # [E] int64 edge sources
    dst: np.ndarray  # [E] int64 edge targets
    labels: np.ndarray  # [n] int32 node labels (ids into label_names)
    label_names: Optional[Sequence[str]] = None

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int64)
        self.dst = np.asarray(self.dst, dtype=np.int64)
        self.labels = np.asarray(self.labels, dtype=np.int32)
        if self.src.shape != self.dst.shape:
            raise ValueError(f"src {self.src.shape} and dst {self.dst.shape} "
                             "differ in shape")
        if self.labels.shape != (self.n,):
            raise ValueError(f"labels must be [{self.n}], got "
                             f"{self.labels.shape}")
        if self.n and max(self.src.max(initial=-1),
                          self.dst.max(initial=-1)) >= self.n:
            raise ValueError(f"edge endpoint out of range (n={self.n})")

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    def size(self) -> int:
        """|G| = |V| + |E| (the paper's fragment-size measure)."""
        return self.n + self.m

    def label_of(self, name: str) -> int:
        if self.label_names is None:
            raise ValueError("graph has no label names")
        return list(self.label_names).index(name)


def csr_from_coo(n: int, src: np.ndarray, dst: np.ndarray):
    """Build CSR (indptr, indices) sorted by source node."""
    order = np.argsort(src, kind="stable")
    s, d = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, s + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, d


def out_degrees(g: Graph) -> np.ndarray:
    """[n] int64 out-degree of every node."""
    return np.bincount(g.src, minlength=g.n).astype(np.int64)


def reverse(g: Graph) -> Graph:
    """The graph with every edge turned around (labels kept)."""
    return Graph(g.n, g.dst.copy(), g.src.copy(), g.labels.copy(),
                 g.label_names)


def bfs_reachable(g: Graph, s: int) -> np.ndarray:
    """Host BFS oracle: boolean reachability from s (includes s)."""
    indptr, indices = csr_from_coo(g.n, g.src, g.dst)
    seen = np.zeros(g.n, dtype=bool)
    seen[s] = True
    frontier = [s]
    while frontier:
        nxt = []
        for u in frontier:
            for v in indices[indptr[u] : indptr[u + 1]]:
                if not seen[v]:
                    seen[v] = True
                    nxt.append(int(v))
        frontier = nxt
    return seen


def bfs_distances(g: Graph, s: int) -> np.ndarray:
    """Host BFS oracle: unit-weight distances from s (unreachable = -1)."""
    indptr, indices = csr_from_coo(g.n, g.src, g.dst)
    dist = np.full(g.n, -1, dtype=np.int64)
    dist[s] = 0
    frontier = [s]
    d = 0
    while frontier:
        nxt = []
        d += 1
        for u in frontier:
            for v in indices[indptr[u] : indptr[u + 1]]:
                if dist[v] < 0:
                    dist[v] = d
                    nxt.append(int(v))
        frontier = nxt
    return dist
