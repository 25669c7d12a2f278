"""The port's host substrate (graphs, fragmentation, automata, planner) vs
the JAX package's: the same inputs must give equal arrays and groups."""
import numpy as np
import pytest

from repro.core import build_query_automaton as j_automaton
from repro.core import fragment_graph as j_fragment
from repro.core import plan as jplan
from repro.core import query_slots as j_slots
from repro.core.automaton import accepts as j_accepts
from repro.graph import bfs_partition as j_bfs_partition
from repro.graph import erdos_renyi as j_er
from repro.graph import random_partition as j_random_partition
from repro_torch.core import automaton as tauto
from repro_torch.core import fragments as tfrag
from repro_torch.core import plan as tplan
from repro_torch.graph import bfs_partition, erdos_renyi, random_partition

# (n, m, k, seed, partitioner, reserve_boundary, reserve_edges)
CASES = [(24, 70, 3, 0, "random", 0, 0), (36, 110, 4, 11, "random", 0, 0),
         (30, 90, 5, 3, "bfs", 0, 0), (40, 120, 4, 7, "random", 3, 5),
         (12, 30, 1, 2, "random", 0, 0), (10, 0, 3, 1, "random", 0, 0)]
REGEXES = ["0* 1*", "(0|1)* 2", "0 . 1", "(0 1)+ | 2?", "eps", ". *"]


def _pair(case):
    n, m, k, seed, how, rb, re = case
    jg, tg = j_er(n, m, n_labels=4, seed=seed), erdos_renyi(n, m, 4, seed)
    if how == "random":
        jp, tp = j_random_partition(jg, k, seed), random_partition(tg, k, seed)
    else:
        jp, tp = j_bfs_partition(jg, k, seed), bfs_partition(tg, k, seed)
    np.testing.assert_array_equal(tp, jp)
    for name in ("src", "dst", "labels"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
    jfr = j_fragment(jg, jp, k, reserve_boundary=rb, reserve_edges=re)
    tfr = tfrag.fragment_graph(tg, tp, k, reserve_boundary=rb,
                               reserve_edges=re)
    return jfr, tfr


@pytest.mark.parametrize("case", CASES)
def test_fragment_graph_matches_reference(case):
    jfr, tfr = _pair(case)
    assert jfr.arrays.keys() == tfr.arrays.keys()
    for name, arr in jfr.arrays.items():
        np.testing.assert_array_equal(tfr.arrays[name], arr, err_msg=name)
        assert tfr.arrays[name].dtype == arr.dtype, name
    for name in ("k", "n_max", "e_max", "s_max", "nb_cap", "B", "n_boundary",
                 "nb_active", "S_ROW", "T_COL", "arrays_version"):
        assert getattr(tfr, name) == getattr(jfr, name), name
    for name in ("part", "bnodes", "b_index", "frag_sizes", "owner_local",
                 "n_edges", "src_fill"):
        np.testing.assert_array_equal(getattr(tfr, name), getattr(jfr, name))
    assert tfr.stubs == jfr.stubs and tfr.reserve == jfr.reserve
    assert tfr.largest_fragment() == jfr.largest_fragment()
    np.testing.assert_array_equal(tfr.boundary_owner(), jfr.boundary_owner())
    np.testing.assert_array_equal(tfr.boundary_local(), jfr.boundary_local())
    np.testing.assert_array_equal(tfr.slot_index(), jfr.slot_index())
    for kind in ("reach", "dist", "bounded", "rpq"):
        for states in (1, 4):
            for batch in (None, 8, 16):
                assert (tfr.traffic_bits(kind, states=states, batch=batch)
                        == jfr.traffic_bits(kind, states=states, batch=batch))
    for s, t in [(0, 1), (tfr.g.n - 1, 0), (2, 2)]:
        js, ts = j_slots(jfr, s, t), tfrag.query_slots(tfr, s, t)
        for name in js:
            np.testing.assert_array_equal(ts[name], js[name])


def test_from_numpy_copies_the_fields():
    jfr, _ = _pair(CASES[3])
    g = jfr.g
    fields = dict(n=g.n, src=g.src, dst=g.dst, labels=g.labels,
                  part=jfr.part, k=jfr.k, bnodes=jfr.bnodes,
                  b_index=jfr.b_index, n_max=jfr.n_max, e_max=jfr.e_max,
                  s_max=jfr.s_max, arrays=jfr.arrays,
                  frag_sizes=jfr.frag_sizes, owner_local=jfr.owner_local,
                  nb_cap=jfr.nb_cap)
    assert tfrag.Fragmentation.from_numpy(fields).arrays_version == 0
    fr = tfrag.Fragmentation.from_numpy(dict(fields, arrays_version=3))
    assert fr.arrays_version == 3
    assert fr.B == jfr.B and fr.nb_active == jfr.nb_active
    for name, arr in jfr.arrays.items():
        np.testing.assert_array_equal(fr.arrays[name], arr)
        assert not np.shares_memory(fr.arrays[name], arr), name
    assert not np.shares_memory(fr.g.src, g.src)
    np.testing.assert_array_equal(fr.slot_index(), jfr.slot_index())


def test_from_numpy_takes_the_dynamic_bookkeeping():
    """A fragmentation carried over with its delta bookkeeping (n_edges,
    src_fill, stubs, reserve) takes the same delta as the JAX original,
    array for array, and owns copies of what it was given."""
    from repro.core import GraphDelta as JDelta
    jfr, _ = _pair(CASES[3])
    g = jfr.g
    fields = dict(n=g.n, src=g.src, dst=g.dst, labels=g.labels,
                  part=jfr.part, k=jfr.k, bnodes=jfr.bnodes,
                  b_index=jfr.b_index, n_max=jfr.n_max, e_max=jfr.e_max,
                  s_max=jfr.s_max, arrays=jfr.arrays,
                  frag_sizes=jfr.frag_sizes, owner_local=jfr.owner_local,
                  nb_cap=jfr.nb_cap, n_edges=jfr.n_edges,
                  src_fill=jfr.src_fill, stubs=jfr.stubs,
                  reserve=jfr.reserve)
    fr = tfrag.Fragmentation.from_numpy(fields)
    assert not np.shares_memory(fr.n_edges, jfr.n_edges)
    assert fr.stubs == jfr.stubs and fr.stubs[0] is not jfr.stubs[0]
    other = np.nonzero(jfr.part != jfr.part[0])[0]
    edges = [(0, int(other[0])), (1, 2), (int(g.src[0]), int(g.dst[0]))]
    kw = dict(add_src=[u for u, _ in edges[:2]],
              add_dst=[v for _, v in edges[:2]],
              del_src=[edges[2][0]], del_dst=[edges[2][1]])
    want = jfr.apply_delta(JDelta(**kw))
    got = fr.apply_delta(tfrag.GraphDelta(**kw))
    np.testing.assert_array_equal(got.dirty, want.dirty)
    assert (got.new_boundary, got.n_add_intra, got.n_add_cross, got.n_del,
            got.rebuilt) == (want.new_boundary, want.n_add_intra,
                             want.n_add_cross, want.n_del, want.rebuilt)
    for name, arr in jfr.arrays.items():
        np.testing.assert_array_equal(fr.arrays[name], arr, err_msg=name)
    np.testing.assert_array_equal(fr.bnodes, jfr.bnodes)
    assert fr.stubs == jfr.stubs and fr.arrays_version == jfr.arrays_version


def test_fragment_graph_rejects_bad_partition():
    g = erdos_renyi(6, 10, seed=0)
    with pytest.raises(ValueError):
        tfrag.fragment_graph(g, np.zeros(5, np.int32), 1)
    with pytest.raises(ValueError):
        tfrag.fragment_graph(g, np.full(6, 2, np.int32), 2)


@pytest.mark.parametrize("regex", REGEXES)
def test_automaton_matches_reference(regex):
    ja, ta = j_automaton(regex, int), tauto.build_query_automaton(regex, int)
    assert ta.cache_key() == ja.cache_key()
    assert (ta.n_states, ta.start, ta.final, ta.nullable, ta.size()) == \
        (ja.n_states, ja.start, ja.final, ja.nullable, ja.size())
    rng = np.random.default_rng(len(regex))
    for _ in range(20):
        word = list(rng.integers(0, 3, size=rng.integers(0, 5)))
        assert tauto.accepts(ta, word) == j_accepts(ja, word)


@pytest.mark.parametrize("regex", ["(0 1", "0 )"])
def test_automaton_rejects_malformed_regex(regex):
    with pytest.raises(ValueError):
        tauto.build_query_automaton(regex, int)


def test_plan_groups_match_reference():
    rng = np.random.default_rng(5)
    spec = []
    for _ in range(40):
        s, t = (int(x) for x in rng.integers(0, 20, 2))
        kind = int(rng.integers(0, 4))
        spec.append((kind, s, t, int(rng.integers(-1, 4)),
                     REGEXES[int(rng.integers(0, 2))]))

    def build(mod, automaton):
        qs = []
        for kind, s, t, bound, rx in spec:
            if kind == 0:
                qs.append(mod.Reach(s, t))
            elif kind == 1:
                qs.append(mod.Dist(s, t, bound=None if bound < 0 else bound))
            else:
                qs.append(mod.Rpq(s, t, regex=rx))
        cache = {}

        def resolve(q):
            if q.regex not in cache:
                cache[q.regex] = automaton(q.regex, int)
            return cache[q.regex]
        return mod.plan_queries(qs, resolve)

    jp, tp = build(jplan, j_automaton), build(tplan, tauto.build_query_automaton)
    assert (tp.n_queries, tp.n_groups) == (jp.n_queries, jp.n_groups)
    assert tp.explain() == jp.explain()
    for jg, tg in zip(jp.groups, tp.groups):
        assert (tg.kind, tg.key, tg.indices, tg.n, tg.padded_size) == \
            (jg.kind, jg.key, jg.indices, jg.n, jg.padded_size)
        np.testing.assert_array_equal(tg.pairs(), jg.pairs())
    for n in (0, 1, 8, 9, 100):
        assert tplan.bucket_size(n) == jplan.bucket_size(n)
