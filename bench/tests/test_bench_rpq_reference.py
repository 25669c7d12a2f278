"""The plain reference of a regular path query agrees with a brute-force
enumeration of label paths, checked by Python's own regular expressions,
and with the program's one-shot answer on a small fragmented graph."""
from __future__ import annotations

import re

import numpy as np
import pytest

from bench import harness
from bench.data import generate as gen
from bench.data.generate import Read
from bench.reference import bfs, rpq

#: single-digit labels, so that a word is a string Python's ``re`` reads;
#: ``2*`` and ``(0|1)?`` hold the empty word, ``2`` and ``0 1+`` do not
REGEXES = ["(0|1)* 2* 3*", "(0|1|2)* 3*", "2*", "0 1+", "(0|1)? 2", "2",
           "(0 | 1 2)* 1?", ". 0*", "eps"]


def _python_regex(regex: str) -> str:
    return regex.replace(" ", "").replace("eps", "")


def _brute_force(n, edges, labels, s, t, regex, depth):
    """The least number of edges, at most ``depth``, of a walk from ``s``
    to ``t`` whose inner labels spell a word of ``regex``: every walk
    enumerated as ``(node, inner word)``, each word checked by ``re``; -1
    where there is none."""
    if s == t:
        return 0 if re.fullmatch(_python_regex(regex), "") else -1
    pattern = re.compile(_python_regex(regex))
    out = [[] for _ in range(n)]
    for u, v in edges:
        out[u].append(v)
    walks = {(s, "")}
    for length in range(1, depth + 1):
        nxt = set()
        for u, word in walks:
            for v in out[u]:
                if v == t and pattern.fullmatch(word):
                    return length
                nxt.add((v, word + str(labels[v])))
        walks = nxt
    return -1


def _tiny_graph(seed, n=6, m=11, n_labels=4):
    g = np.random.default_rng(seed)
    src, dst = g.integers(0, n, m), g.integers(0, n, m)
    return src, dst, g.integers(0, n_labels, n)


@pytest.mark.parametrize("regex", REGEXES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_brute_force(regex, seed):
    """Every pair of a tiny graph, ``s == t`` among them, up to walks of
    six edges."""
    n, depth = 6, 6
    src, dst, labels = _tiny_graph(seed, n)
    edges = list(zip(src.tolist(), dst.tolist()))
    pairs = [(s, t) for s in range(n) for t in range(n)]
    reads = [Read("rpq", s, t, regex=regex) for s, t in pairs]
    got = rpq.lengths(n, src, dst, labels, [], reads, [0] * len(reads),
                      "cpu", max_depth=depth)
    want = [_brute_force(n, edges, labels.tolist(), s, t, regex, depth)
            for s, t in pairs]
    assert got == want


def test_direct_edge_unreachable_pair_and_self():
    """A direct edge spells the empty word; a pair with no path at all is
    False under a regex that holds the empty word."""
    src, dst = np.array([0, 1, 2]), np.array([1, 2, 3])
    labels = np.array([5, 0, 1, 7])
    reads = [Read("rpq", 0, 1, regex="2*"), Read("rpq", 0, 1, regex="2"),
             Read("rpq", 0, 3, regex="0 1"), Read("rpq", 0, 3, regex="0* 2"),
             Read("rpq", 3, 0, regex="2*"), Read("rpq", 2, 2, regex="2*"),
             Read("rpq", 2, 2, regex="2")]
    got = rpq.lengths(4, src, dst, labels, [], reads, [0] * len(reads), "cpu")
    assert got == [1, -1, 3, -1, -1, 0, -1]
    capped = rpq.lengths(4, src, dst, labels, [], reads[2:3], [0], "cpu",
                         max_depth=2)
    assert capped == [-1]


def test_versions_take_the_deltas():
    """A delta's insertion adds a path and its deletion takes one away, one
    copy of a multi-edge at a time, as the hop reference has them."""
    src, dst = np.array([0, 0, 1]), np.array([1, 1, 2])
    labels = np.array([0, 3, 0])
    deltas = [([(1, 2)], []), ([], [(0, 1), (0, 1)])]
    reads = [Read("rpq", 0, 2, regex="3")] * 3
    assert rpq.lengths(3, src, dst, labels, deltas, reads, [0, 1, 2],
                       "cpu") == [2, 2, -1]
    assert rpq.lengths(3, src, dst, labels, deltas, reads[:1], [3],
                       "cpu") == [None]
    hops = bfs.distances(3, src, dst, deltas, [Read("reach", 0, 2)] * 3,
                         [0, 1, 2], "cpu")
    assert hops == [2, 2, -1]


@pytest.mark.parametrize("word", ["", "0", "3", "012", "0123", "33", "30",
                                  "0121233", "1113", "2020203333", "4",
                                  "0142"])
def test_automaton_accepts_what_python_accepts(word):
    regex = "(0|1|2)* 3*"
    nfa = rpq.automaton(regex)
    assert rpq.accepts(nfa, [int(c) for c in word]) == bool(
        re.fullmatch(_python_regex(regex), word))
    assert nfa.k == 5 and nfa.nullable


@pytest.mark.parametrize("bad", ["(0|1", "0|*", ")", "0 a"])
def test_a_regex_it_cannot_read_raises(bad):
    with pytest.raises(ValueError):
        rpq.automaton(bad)


@pytest.mark.parametrize("regex", ["(0|1|2)* 3*", "(0|1)* 2* 3*"])
def test_reference_agrees_with_the_program(regex):
    """The program's one-shot ``exec_rpq`` on the CPU, on a small graph cut
    into four fragments, answers every pair as the reference does, pairs
    with ``s == t`` and with a direct edge among them."""
    from repro_torch import Rpq, connect
    config = {"generator": "erdos_renyi", "n_nodes": 192, "n_edges": 768,
              "n_labels": 8, "partitioner": "random_partition",
              "n_fragments": 4, "graph_seed": 0}
    g = gen.make_graph(config, 7)
    session = connect(harness.build_fragments(config, g), cache="none",
                      device="cpu")
    pick = np.random.default_rng(3)
    pairs = [tuple(int(x) for x in p) for p in pick.integers(0, g.n, (40, 2))]
    pairs += [(5, 5), (int(g.src[0]), int(g.dst[0])),
              (int(g.src[1]), int(g.dst[1]))]
    got = [r.answer for r in session.run([Rpq(s, t, regex=regex)
                                          for s, t in pairs])]
    reads = [Read("rpq", s, t, regex=regex) for s, t in pairs]
    want = rpq.lengths(g.n, g.src, g.dst, g.labels, [], reads,
                       [0] * len(reads), "cpu")
    assert got == [d >= 0 for d in want]
    assert 0 < sum(got) < len(got)
