"""The rest of the port's host substrate against the JAX package, and the
session, one-shot and incremental parity on the reference's other graphs.

Generators and partitioners must be equal array for array at the same
seeds; the helpers (``Graph.size``/``reverse``/``out_degrees``,
``fragment_of``, ``traffic_bits_reach``, ``closure_answers``, the
batch-of-one cached wrappers) equal too.  Then the session (amortized and
``cache="none"``) and the incremental repair run on a planted labelled
chain and on a power-law graph cut into contiguous blocks: long chains
give large finite distances through the min-plus closure and evalDG.
Booleans and int32 must be equal exactly (tolerance zero: these semirings
do not round).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import Dist as JDist
from repro.core import GraphDelta as JDelta
from repro.core import Reach as JReach
from repro.core import Rpq as JRpq
from repro.core import apply_delta as j_apply
from repro.core import bes as j_bes
from repro.core import build_query_automaton as j_automaton
from repro.core import cache as j_cache
from repro.core import fragment_graph as j_fragment
from repro.core import prepare_rvset_cache as j_prepare
from repro.graph import generate as j_generate
from repro.graph import graph as j_graph
from repro.graph import partition as j_partition
from repro_torch import Dist, GraphDelta, Reach, Rpq
from repro_torch.core import bes, cache
from repro_torch.core.automaton import build_query_automaton
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import (block_partition, cut_stats, hash_partition,
                               labeled_chain_graph, out_degrees,
                               preferential_attachment, random_partition,
                               reverse)

from oracles import oracle_dist, oracle_reach, oracle_rpq

RESERVE = dict(reserve_boundary=8, reserve_edges=24, reserve_stubs=12)
CACHE_TENSORS = ("bl_frontier", "closure", "bl_dist", "dist_closure")


def _graphs(name, seed):
    """(JAX graph, port graph, JAX part, port part, k) of one generator."""
    if name == "chain":
        args = (40, 14, 30)
        kw = dict(chain_label=2, n_labels=3, seed=seed)
        jg = j_generate.labeled_chain_graph(*args, **kw)
        tg = labeled_chain_graph(*args, **kw)
        k = 4
        return (jg, tg, j_partition.random_partition(jg, k, seed),
                random_partition(tg, k, seed), k)
    jg = j_generate.preferential_attachment(48, 2, n_labels=3, seed=seed)
    tg = preferential_attachment(48, 2, n_labels=3, seed=seed)
    k = 4
    return (jg, tg, j_partition.block_partition(jg, k),
            block_partition(tg, k), k)


def _fragmentations(name, seed, **reserve):
    jg, tg, jp, tp, k = _graphs(name, seed)
    return j_fragment(jg, jp, k, **reserve), fragment_graph(tg, tp, k,
                                                            **reserve)


GRAPHS = [("chain", 0), ("chain", 3), ("powerlaw", 1), ("powerlaw", 7)]
# one of each for the tests that run the JAX engines (compiles dominate)
ONE_EACH = GRAPHS[::2]


# ---------------------------------------------------------------------------
# generators, partitioners, graph helpers
# ---------------------------------------------------------------------------

def _same_graph(jg, tg):
    assert tg.n == jg.n and tg.m == jg.m
    for name in ("src", "dst", "labels"):
        a, b = getattr(jg, name), getattr(tg, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 9])
@pytest.mark.parametrize("n,m_per", [(1, 4), (2, 4), (30, 1), (60, 3)])
def test_preferential_attachment_matches_reference(n, m_per, seed):
    _same_graph(j_generate.preferential_attachment(n, m_per, 5, seed),
                preferential_attachment(n, m_per, 5, seed))


@pytest.mark.parametrize("seed", [0, 1, 9])
@pytest.mark.parametrize("args", [(12, 30, 80, 2, 4), (8, 10, 20, 1, 3),
                                  (2, 0, 0, 0, 2)], ids=str)
def test_labeled_chain_graph_matches_reference(args, seed):
    jg = j_generate.labeled_chain_graph(*args, seed=seed)
    tg = labeled_chain_graph(*args, seed=seed)
    _same_graph(jg, tg)
    n_chain, label = args[0], args[3]
    assert (tg.labels[1:n_chain - 1] == label).all()


@pytest.mark.parametrize("k", [1, 3, 8])
def test_partitioners_and_cut_stats_match_reference(k):
    jg = j_generate.preferential_attachment(50, 3, seed=4)
    tg = preferential_attachment(50, 3, seed=4)
    for jpart, tpart in [(j_partition.hash_partition(jg, k),
                          hash_partition(tg, k)),
                         (j_partition.block_partition(jg, k),
                          block_partition(tg, k))]:
        assert tpart.dtype == jpart.dtype == np.int32
        np.testing.assert_array_equal(tpart, jpart)
        assert cut_stats(tg, tpart) == j_partition.cut_stats(jg, jpart)
    empty = j_generate.erdos_renyi(0, 0, seed=0)
    assert block_partition(empty, k).shape == (0,)


def test_graph_helpers_match_reference():
    jg = j_generate.labeled_chain_graph(9, 5, 20, 1, seed=2)
    tg = labeled_chain_graph(9, 5, 20, 1, seed=2)
    assert tg.size() == jg.size() == tg.n + tg.m
    np.testing.assert_array_equal(out_degrees(tg), j_graph.out_degrees(jg))
    assert out_degrees(tg).dtype == np.int64
    jr, tr = j_graph.reverse(jg), reverse(tg)
    _same_graph(jr, tr)
    assert tr.src is not tg.dst and tr.labels is not tg.labels


@pytest.mark.parametrize("name,seed", GRAPHS)
def test_fragment_helpers_match_reference(name, seed):
    jfr, tfr = _fragmentations(name, seed)
    assert tfr.traffic_bits_reach() == jfr.traffic_bits_reach() == \
        tfr.B * tfr.B
    for v in range(tfr.g.n):
        assert tfr.fragment_of(v) == jfr.fragment_of(v) == int(tfr.part[v])


def test_closure_answers_matches_reference():
    rng = np.random.default_rng(5)
    A = rng.random((9, 9)) < 0.3
    rows, cols = rng.integers(0, 9, 12), rng.integers(0, 9, 12)
    want = np.asarray(j_bes.closure_answers(jnp.asarray(A), rows, cols))
    got = bes.closure_answers(torch.tensor(A), torch.tensor(rows),
                              torch.tensor(cols))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,seed", ONE_EACH)
def test_cached_single_query_wrappers_match_reference(name, seed):
    jfr, tfr = _fragmentations(name, seed)
    jqa, tqa = j_automaton("2*", int), build_query_automaton("2*", int)
    pairs = [(0, tfr.g.n - 1), (5, 0), (3, 3)]
    if name == "chain":
        pairs.append((0, 39))                  # the whole planted chain
    for s, t in pairs:
        assert cache.reach_cached(tfr, s, t, "cpu") == \
            j_cache.reach_cached(jfr, s, t) == oracle_reach(tfr.g, s, t)
        assert cache.dist_cached(tfr, s, t, "cpu") == \
            j_cache.dist_cached(jfr, s, t) == oracle_dist(tfr.g, s, t)
        assert cache.rpq_cached(tfr, s, t, tqa, "cpu") == \
            j_cache.rpq_cached(jfr, s, t, jqa)
    if name == "chain":
        assert cache.rpq_cached(tfr, 0, 39, tqa, "cpu")
        assert cache.dist_cached(tfr, 0, 39, "cpu") == \
            oracle_dist(tfr.g, 0, 39)


# ---------------------------------------------------------------------------
# session, one-shot and incremental parity on chains and power laws
# ---------------------------------------------------------------------------

REGEXES = ["2*", "(0|1)* 2"]


def _mixed_rows(n, seed):
    """(kind, s, t, bound, regex) rows: long-range pairs between the
    lowest node ids and the upper half (the chain runs up from node 0; a
    power-law node links down to older ones), random pairs and s == t."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(24):
        if i % 6 == 0:
            s, t = int(rng.integers(0, 4)), int(rng.integers(n // 2, n))
        elif i % 6 == 3:
            s, t = int(rng.integers(n // 2, n)), int(rng.integers(0, 4))
        else:
            s, t = (int(x) for x in rng.integers(0, n, 2))
        if i == 5:
            t = s
        rows.append((i % 4, s, t, int(rng.integers(-1, 30)), REGEXES[i % 2]))
    return rows


def _queries(rows, reach, dist, rpq):
    return [reach(s, t) if kind == 0 else
            dist(s, t, bound=None if b < 0 else b) if kind == 1 else
            rpq(s, t, regex=rx) for kind, s, t, b, rx in rows]


def _check_oracles(g, queries, results):
    for q, r in zip(queries, results):
        if isinstance(q, Reach):
            assert r.answer == oracle_reach(g, q.s, q.t), q
        elif isinstance(q, Dist):
            d = oracle_dist(g, q.s, q.t)
            ok = d is not None and (q.bound is None or d <= q.bound)
            assert (r.answer, r.distance) == (ok, d if ok else None), q
        else:
            assert r.answer == oracle_rpq(g, q.s, q.t,
                                          j_automaton(q.regex, int)), q


@pytest.mark.parametrize("cache_mode", ["amortized", "none"])
@pytest.mark.parametrize("name,seed", ONE_EACH)
def test_session_matches_reference_on_chains_and_power_laws(name, seed,
                                                           cache_mode):
    jfr, tfr = _fragmentations(name, seed)
    rows = _mixed_rows(tfr.g.n, seed)
    want = repro.connect(jfr, backend="vmap", cache=cache_mode).run(
        _queries(rows, JReach, JDist, JRpq))
    queries = _queries(rows, Reach, Dist, Rpq)
    got = repro_torch.connect(tfr, device="cpu", cache=cache_mode).run(queries)
    for q, r, w in zip(queries, got, want):
        assert (r.answer, r.distance) == (w.answer, w.distance), q
        assert tuple(r.stats) == tuple(w.stats), q
        assert r.cache_version == w.cache_version, q
    _check_oracles(tfr.g, queries, got)
    # far finite distances pass through the closures and evalDG
    longest = max((r.distance or 0) for r in got)
    assert longest >= (6 if name == "chain" else 2), longest


@pytest.mark.parametrize("name,seed", ONE_EACH)
def test_delta_stream_matches_reference_on_chains_and_power_laws(name, seed):
    """Inserts inside one fragment, a cross insert, deletions and an
    overflow: UpdateStats, host arrays and every cache tensor equal the
    JAX package's after each delta, and the answers the oracles'."""
    jfr, tfr = _fragmentations(name, seed, **RESERVE)
    j_prepare(jfr, with_dist=True)
    sess = repro_torch.connect(tfr, device="cpu").warm(with_dist=True)
    rng = np.random.default_rng(seed + 11)
    part, n = tfr.part, tfr.g.n
    f = int(part[0])
    mine, other = np.nonzero(part == f)[0], np.nonzero(part != f)[0]
    e = rng.choice(tfr.g.m, size=2, replace=False)
    stream = [
        ([(int(rng.choice(mine)), int(rng.choice(mine))) for _ in range(2)],
         []),
        ([(int(rng.choice(mine)), int(rng.choice(other)))], []),
        ([], [(int(tfr.g.src[i]), int(tfr.g.dst[i])) for i in e]),
        ([(int(rng.choice(mine)), int(rng.choice(other)))
          for _ in range(tfr.e_max)], []),
    ]
    modes = []
    for adds, dels in stream:
        kw = dict(add_src=[u for u, _ in adds], add_dst=[v for _, v in adds],
                  del_src=[u for u, _ in dels], del_dst=[v for _, v in dels])
        want, got = j_apply(jfr, JDelta(**kw)), sess.apply(GraphDelta(**kw))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        modes.append(got.mode)
        for name_, arr in jfr.arrays.items():
            np.testing.assert_array_equal(tfr.arrays[name_], arr)
        jc, tc = jfr.rvset_cache, tfr.rvset_cache
        assert tc.version == jc.version
        for t_name in CACHE_TENSORS:
            np.testing.assert_array_equal(
                getattr(tc, t_name).numpy(),
                np.asarray(getattr(jc, t_name)), err_msg=t_name)
        pairs = [(0, int(x)) for x in rng.integers(0, n, 3)] + \
            [tuple(int(x) for x in rng.integers(0, n, 2)) for _ in range(3)]
        queries = [Reach(s, t) for s, t in pairs] + \
            [Dist(s, t) for s, t in pairs]
        _check_oracles(tfr.g, queries, sess.run(queries))
    assert modes[-1] == "rebuild" and "recompute" in modes, modes
