"""The plain reference agrees with a brute-force closure, and the
comparison reads an answer as the reference's only when it is equal."""
from __future__ import annotations

import numpy as np
import pytest

from bench import correctness
from bench.data.generate import Read
from bench.reference import bfs


def _closure_distances(n, edges):
    """Hop distances by repeated relaxation of a dense matrix."""
    inf = 10 ** 9
    d = np.full((n, n), inf, dtype=np.int64)
    np.fill_diagonal(d, 0)
    for u, v in edges:
        if u != v:
            d[u, v] = min(d[u, v], 1)
    for k in range(n):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    return np.where(d >= inf, -1, d)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bfs_matches_closure_with_deltas(seed):
    """Insertions and deletions (one occurrence of a multi-edge each)."""
    rng = np.random.default_rng(seed)
    n, m = 40, 60
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    edges = list(zip(src.tolist(), dst.tolist()))
    versions_edges = [list(edges)]
    deltas = []
    for _ in range(4):
        ins = [(int(u), int(v)) for u, v in rng.integers(0, n, (3, 2))]
        live = versions_edges[-1] + ins
        dels = [live[int(i)] for i in rng.choice(len(live), 3,
                                                 replace=False)]
        nxt = list(live)
        for e in dels:
            nxt.remove(e)
        deltas.append((ins, dels))
        versions_edges.append(nxt)
    reads = [Read("dist", int(s), int(t)) for s, t in rng.integers(0, n,
                                                                   (80, 2))]
    versions = [int(v) for v in rng.integers(0, len(deltas) + 1, 80)]
    got = bfs.distances(n, src, dst, deltas, reads, versions, "cpu")
    for v, live in enumerate(versions_edges):
        want = _closure_distances(n, live)
        for r, ver, g in zip(reads, versions, got):
            if ver == v:
                assert g == want[r.s, r.t]


def test_a_deleted_multi_edge_keeps_its_other_copy():
    src, dst = np.array([0, 0, 1]), np.array([1, 1, 2])
    reads = [Read("reach", 0, 2)]
    one = [([], [(0, 1)])]
    both = [([], [(0, 1), (0, 1)])]
    assert bfs.distances(3, src, dst, one, reads, [1], "cpu") == [2]
    assert bfs.distances(3, src, dst, both, reads, [1], "cpu") == [-1]


def test_depth_cap_and_unknown_version():
    n = 6
    src, dst = np.arange(5), np.arange(1, 6)          # a chain 0 -> 5
    reads = [Read("reach", 0, 5), Read("reach", 0, 2)]
    assert bfs.distances(n, src, dst, [], reads, [0, 0], "cpu") == [5, 2]
    assert bfs.distances(n, src, dst, [], reads, [0, 0], "cpu",
                         max_depth=4) == [-1, 2]
    assert bfs.distances(n, src, dst, [], reads, [1, 0], "cpu") == [None, 2]


def test_answers_and_their_comparison():
    assert bfs.answer("reach", -1, 0) is False
    assert bfs.answer("dist", 3, 0) == 3 and bfs.answer("dist", -1, 0) is None
    assert bfs.answer("bounded", 6, 6) and not bfs.answer("bounded", 7, 6)
    assert correctness.same("dist", 3, 3) and correctness.same("dist", None,
                                                               None)
    assert not correctness.same("dist", True, 1)
    assert not correctness.same("dist", None, 0)
    assert correctness.same("reach", True, True)
    assert not correctness.same("reach", 1, True)
