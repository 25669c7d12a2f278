"""The port's dynamic graphs (``GraphDelta``, ``session.apply``, the
incremental repair of ``core.incremental``) vs the JAX package.

The same seeded delta streams go through a JAX and a port fragmentation,
each with a warm cache.  After every delta the host arrays and
bookkeeping, the ``UpdateStats`` and every cache tensor must be equal
(these semirings do not round, so the tolerance is zero), and the answers
must equal a freshly built fragmentation's and the oracles.  The named
cases of tests/test_incremental.py follow, then the rollback of a failed
delta, which must leave every tensor as it was.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import GraphDelta as JDelta
from repro.core import apply_delta as j_apply
from repro.core import build_query_automaton as j_automaton
from repro.core import fragment_graph as j_fragment
from repro.core import prepare_rvset_cache as j_prepare
from repro.core.incremental import REBUILD_DEBT
from repro.graph import erdos_renyi as j_er
from repro.graph import random_partition as j_random_partition

import repro_torch
from repro_torch import DeltaApplyFailed, Dist, GraphDelta, Reach, Rpq
from repro_torch.core import distributed as tdist
from repro_torch.core import incremental as tinc
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import Graph, erdos_renyi, random_partition

from oracles import oracle_dist, oracle_reach, oracle_rpq

RESERVE = dict(reserve_boundary=8, reserve_edges=24, reserve_stubs=12)
CACHE_TENSORS = ("bl_frontier", "closure", "closure_t", "bl_dist",
                 "dist_closure")


def _dynamic_case(n, m, k, seed, **reserve):
    """tests/test_incremental.py's generator in both packages."""
    kw = dict(RESERVE, **reserve)
    jg = j_er(n, m, n_labels=3, seed=seed)
    tg = erdos_renyi(n, m, n_labels=3, seed=seed)
    return (j_fragment(jg, j_random_partition(jg, k, seed), k, **kw),
            fragment_graph(tg, random_partition(tg, k, seed), k, **kw))


def _session(tfr, with_dist=True, **kw):
    return repro_torch.connect(tfr, device="cpu", **kw).warm(
        with_dist=with_dist)


def _deltas(edges_add, edges_del=()):
    add, rem = list(edges_add), list(edges_del)
    kw = dict(add_src=[u for u, _ in add], add_dst=[v for _, v in add],
              del_src=[u for u, _ in rem], del_dst=[v for _, v in rem])
    return JDelta(**kw), GraphDelta(**kw)


def _check_host_state(jfr, tfr):
    for name, arr in jfr.arrays.items():
        np.testing.assert_array_equal(tfr.arrays[name], arr, err_msg=name)
    for name in ("b_index", "bnodes", "n_edges", "src_fill", "frag_sizes",
                 "part"):
        np.testing.assert_array_equal(getattr(tfr, name),
                                      getattr(jfr, name), err_msg=name)
    assert (tfr.B, tfr.nb_active, tfr.arrays_version) == \
        (jfr.B, jfr.nb_active, jfr.arrays_version)
    assert tfr.stubs == jfr.stubs and tfr.reserve == jfr.reserve
    np.testing.assert_array_equal(tfr.g.src, jfr.g.src)
    np.testing.assert_array_equal(tfr.g.dst, jfr.g.dst)


def _check_cache(jfr, tfr):
    jc, tc = jfr.rvset_cache, tfr.rvset_cache
    assert (tc.version, tc.repair_debt) == (jc.version, jc.repair_debt)
    np.testing.assert_array_equal(tc.part_b, jc.part_b)
    want = {name: np.asarray(getattr(jc, name)) for name in
            ("bl_frontier", "closure", "bl_dist", "dist_closure")}
    want["closure_t"] = want["closure"].T
    for name in CACHE_TENSORS:
        np.testing.assert_array_equal(getattr(tc, name).numpy(), want[name],
                                      err_msg=name)
    for name, arr in tfr.arrays.items():
        np.testing.assert_array_equal(tc.arrays[name].numpy(), arr,
                                      err_msg=name)
        # uploads copy: the host arrays are mutated in place by deltas
        assert not np.shares_memory(tc.arrays[name].numpy(), arr), name


def _check_answers(tfr, sess, rng, n_pairs=6):
    """The maintained session == a session on a freshly built
    fragmentation == the oracles, for reach, dist and one RPQ."""
    n = tfr.g.n
    pairs = [(int(rng.integers(n)), int(rng.integers(n)))
             for _ in range(n_pairs)]
    queries = ([Reach(s, t) for s, t in pairs] + [Dist(s, t) for s, t in pairs]
               + [Dist(s, t, bound=2) for s, t in pairs]
               + [Rpq(s, t, regex="(0|1)* 2") for s, t in pairs[:3]])
    got = sess.run(queries)
    fresh = fragment_graph(tfr.g, tfr.part, tfr.k, **RESERVE)
    want = repro_torch.connect(fresh, device="cpu").run(queries)
    assert [(r.answer, r.distance) for r in got] == \
        [(r.answer, r.distance) for r in want]
    qa = j_automaton("(0|1)* 2", int)
    for q, r in zip(queries, got):
        if isinstance(q, Reach):
            assert r.answer == oracle_reach(tfr.g, q.s, q.t), q
        elif isinstance(q, Dist):
            d = oracle_dist(tfr.g, q.s, q.t)
            ok = d is not None and (q.bound is None or d <= q.bound)
            assert (r.answer, r.distance) == (ok, d if ok else None), q
        else:
            assert r.answer == oracle_rpq(tfr.g, q.s, q.t, qa), q
    assert {r.cache_version for r in got} == {sess.cache_version}


def _stream(fr, rng, steps):
    """A seeded delta stream that walks through the modes: inserts inside
    one fragment (repair), a cross insert (repair, often a new boundary
    node), inserts spread over most fragments (recompute), deletions
    (recompute), and last, more cross inserts out of one fragment than its
    edge reserve holds (rebuild)."""
    part, n = fr.part, fr.g.n
    for step in range(steps):
        f = int(rng.integers(fr.k))
        mine = np.nonzero(part == f)[0]
        other = np.nonzero(part != f)[0]
        phase = step % 4
        if step == steps - 1:
            yield [(int(rng.choice(mine)), int(rng.choice(other)))
                   for _ in range(fr.e_max)], []
        elif phase == 0:
            adds = [(int(rng.choice(mine)), int(rng.choice(mine)))
                    for _ in range(2)]
            yield adds, []
        elif phase == 1:
            yield [(int(rng.choice(mine)), int(rng.choice(other)))], []
        elif phase == 2:
            yield [(int(rng.integers(n)), int(rng.integers(n)))
                   for _ in range(2 * fr.k)], []
        else:
            e = rng.choice(fr.g.m, size=2, replace=False)
            yield [], [(int(fr.g.src[i]), int(fr.g.dst[i])) for i in e]


@pytest.mark.parametrize("case,steps", [((24, 60, 4, 0), 9),
                                        ((20, 50, 3, 5), 5)], ids=str)
def test_delta_stream_matches_reference(case, steps):
    """Every delta of the stream: host arrays, b_index, bnodes, n_edges,
    src_fill, stubs, UpdateStats and the cache tensors equal the JAX
    package's; answers equal a rebuilt fragmentation's and the oracles."""
    jfr, tfr = _dynamic_case(*case)
    j_prepare(jfr, with_dist=True)
    sess = _session(tfr)
    rng = np.random.default_rng(case[3])
    modes = []
    for adds, dels in _stream(jfr, rng, steps):
        jd, td = _deltas(adds, dels)
        want = j_apply(jfr, jd)
        got = sess.apply(td)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        modes.append(got.mode)
        _check_host_state(jfr, tfr)
        _check_cache(jfr, tfr)
        _check_answers(tfr, sess, rng)
    assert {"repair", "recompute", "rebuild"} <= set(modes), modes
    assert modes[-1] == "rebuild"
    assert sess.stats.updates == steps and sess.stats.rollbacks == 0


def test_repair_changes_rows_through_the_rank_update():
    """A one-fragment insert that changes D0 rows takes the rank-style
    update (changed_rows > 0), equal to the JAX package's."""
    jfr, tfr = _dynamic_case(24, 40, 4, 7)
    j_prepare(jfr, with_dist=True)
    sess = _session(tfr)
    cross = np.nonzero(tfr.part[tfr.g.src] != tfr.part[tfr.g.dst])[0]
    u = int(tfr.g.src[cross[0]])
    mine = np.nonzero(tfr.part == tfr.part[u])[0]
    v = int(next(x for x in mine if x != u))
    jd, td = _deltas([(v, u)])
    want, got = j_apply(jfr, jd), sess.apply(td)
    assert got.mode == "repair" and got.changed_rows > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    _check_cache(jfr, tfr)
    _check_answers(tfr, sess, np.random.default_rng(3))


# ---------------------------------------------------------------------------
# the named cases of tests/test_incremental.py
# ---------------------------------------------------------------------------

def test_cross_edge_landing_on_query_target():
    """A cross edge that lands on a query target t: t becomes a boundary
    in-node and its own column carries the answer (two fragments:
    0|1|2 and 3|4|5; t = 5 is reached only through the new edge 2 -> 5)."""
    g = Graph(6, np.array([0, 1, 3]), np.array([1, 2, 4]),
              np.zeros(6, np.int32))
    part = np.array([0, 0, 0, 1, 1, 1], np.int32)
    fr = fragment_graph(g, part, 2, reserve_boundary=4, reserve_edges=8,
                        reserve_stubs=4)
    sess = _session(fr)
    assert not sess.reach(0, 5)
    st1 = sess.apply(GraphDelta.insert([(2, 5)]))
    assert st1.new_boundary == 1
    assert sess.reach(0, 5) and sess.dist(0, 5).distance == 3
    st2 = sess.apply(GraphDelta.insert([(1, 5)]))
    assert st2.new_boundary == 0
    assert sess.dist(0, 5).distance == 2
    for s, t in [(0, 5), (5, 0), (3, 5), (0, 4)]:
        assert sess.reach(s, t) == oracle_reach(fr.g, s, t)
        assert sess.dist(s, t).distance == oracle_dist(fr.g, s, t)


def test_nonboundary_node_becomes_boundary_in_node():
    """Activating a spare boundary slot changes no tensor's shape and
    makes the new in-node's row live."""
    _, fr = _dynamic_case(18, 25, 3, seed=4)
    sess = _session(fr, with_dist=False)
    cache = fr.rvset_cache
    B0, shape, nb_active0 = fr.B, cache.closure.shape, fr.nb_active
    g, part = fr.g, fr.part
    cross_dst = set(g.dst[part[g.src] != part[g.dst]].tolist())
    w = next(v for v in range(g.n) if v not in cross_dst)
    u = next(u for u in range(g.n) if part[u] != part[w])
    st1 = sess.apply(GraphDelta.insert([(u, w)]))
    assert st1.new_boundary == 1 and fr.nb_active == nb_active0 + 1
    assert fr.b_index[w] == nb_active0 and fr.B == B0
    assert cache.closure.shape == cache.closure_t.shape == shape
    for s, t in [(u, w), (w, u)] + [(s, w) for s in range(0, g.n, 5)]:
        assert sess.reach(s, t) == oracle_reach(fr.g, s, t)


def test_empty_delta_is_noop_with_tensor_identity():
    _, fr = _dynamic_case(14, 20, 2, seed=6)
    sess = _session(fr)
    cache = fr.rvset_cache
    held = {name: getattr(cache, name) for name in CACHE_TENSORS}
    arrays, version = cache.arrays, cache.version
    assert sess.apply(GraphDelta()).mode == "noop"
    assert cache.arrays is arrays and cache.version == version
    for name, t in held.items():
        assert getattr(cache, name) is t, name
    assert fr.rvset_cache is cache and fr.arrays_version == 0


def test_deletions_recompute_then_debt_forces_rebuild():
    _, fr = _dynamic_case(20, 60, 3, seed=8)
    sess = _session(fr, with_dist=False)
    rng = np.random.default_rng(0)
    modes = []
    for _ in range(12):
        e = int(rng.integers(fr.g.m))
        stats = sess.apply(
            GraphDelta.delete([(int(fr.g.src[e]), int(fr.g.dst[e]))]))
        modes.append(stats.mode)
        if stats.mode == "rebuild":
            assert stats.reason == "repair debt"
            break
    assert modes[0] == "recompute" and "rebuild" in modes
    assert len(modes) <= int(REBUILD_DEBT / 0.5) + 1
    assert fr.rvset_cache.repair_debt == 0.0
    _check_answers(fr, sess, rng)


def test_capacity_overflow_falls_back_to_rebuild():
    _, fr = _dynamic_case(16, 30, 2, seed=3, reserve_boundary=0,
                          reserve_edges=0, reserve_stubs=0)
    sess = _session(fr, with_dist=False)
    version = sess.cache_version
    other = np.nonzero(fr.part != fr.part[0])[0]
    stats = sess.apply(GraphDelta.insert([(0, int(v)) for v in other[:3]] * 8))
    assert stats.mode == "rebuild" and stats.reason
    assert sess.cache_version == version + 1
    for s, t in [(0, int(other[0])), (3, 9)]:
        assert sess.reach(s, t) == oracle_reach(fr.g, s, t)


def test_changed_row_padding_buckets():
    _, fr = _dynamic_case(20, 50, 3, seed=1)
    dirty = np.zeros(fr.k, dtype=bool)
    dirty[0] = True
    rows = tinc.changed_row_ids(fr, dirty)
    assert set(fr.boundary_owner()[rows]) <= {0}
    padded = tinc.pad_row_ids(rows, pad=8)
    assert len(padded) % 8 == 0
    assert set(padded) == set(rows)       # padding repeats, never invents
    assert len(tinc.pad_row_ids(rows, cap=len(rows))) == len(rows)
    assert tinc.ROW_PAD == 64


# ---------------------------------------------------------------------------
# rollback: a failed delta leaves everything as it was
# ---------------------------------------------------------------------------

class _FailAt:
    """A fault injector: raises at one site."""

    def __init__(self, site):
        self.site, self.calls = site, 0

    def maybe_fail(self, site, pairs=None):
        self.calls += 1
        if site == self.site:
            raise RuntimeError(f"injected at {site}")


def _held(cache):
    """Clones of every cache tensor, with the objects themselves."""
    return {name: (getattr(cache, name), getattr(cache, name).clone())
            for name in CACHE_TENSORS}


def _check_held(cache, held):
    for name, (obj, copy) in held.items():
        assert getattr(cache, name) is obj, name
        assert torch.equal(obj, copy), f"{name} was written in place"


@pytest.mark.parametrize("fail", ["chaos", "rank_update", "bad_delete"])
def test_failed_delta_rolls_back(fail, monkeypatch):
    """A delta that fails after the host arrays mutated (an injected fault
    at delta.repair, or a failure inside the Boolean rank update after the
    frontiers and the distance closure were rebound), or before (a missing
    edge), is rolled back:
    arrays, bookkeeping, versions, the sharded upload memo and every cache
    tensor are as they were, and later answers are the pre-delta ones."""
    _, fr = _dynamic_case(24, 60, 4, seed=2)
    chaos = _FailAt("delta.repair") if fail == "chaos" else None
    sess = _session(fr, chaos=chaos)
    cache = fr.rvset_cache
    pairs = [(s, t) for s in range(0, 24, 5) for t in range(1, 24, 7)]
    before = [(r.answer, r.distance) for r in
              sess.run([Dist(s, t) for s, t in pairs])]
    fr.__dict__["_sharded_device_inputs"] = {"stale": True}
    snap_arrays = {k: v.copy() for k, v in fr.arrays.items()}
    bookkeeping = (fr.b_index.copy(), fr.bnodes.copy(), fr.n_edges.copy(),
                   fr.src_fill.copy(), [dict(m) for m in fr.stubs], fr.g)
    versions = (fr.arrays_version, sess.cache_version, cache.repair_debt)
    cache_arrays = dict(cache.arrays)
    held = _held(cache)
    f = int(fr.part[0])
    mine = np.nonzero(fr.part == f)[0]
    delta = GraphDelta.insert([(int(mine[0]), int(mine[-1])),
                               (int(mine[1]), int(mine[0]))])
    if fail == "rank_update":
        def broken(*args):
            raise RuntimeError("rank update failed")
        monkeypatch.setattr(tinc, "_rank_update_bool", broken)
        monkeypatch.setattr(tinc, "changed_row_ids",
                            lambda fr, dirty: np.arange(fr.nb_active))
    if fail == "bad_delete":
        present = set(zip(fr.g.src.tolist(), fr.g.dst.tolist()))
        missing = next((u, v) for u in range(24) for v in range(24)
                       if (u, v) not in present)
        delta = GraphDelta(add_src=delta.add_src, add_dst=delta.add_dst,
                           del_src=[missing[0]], del_dst=[missing[1]])
    with pytest.raises(DeltaApplyFailed) as err:
        sess.apply(delta)
    assert err.value.rolled_back
    assert sess.stats.rollbacks == 1 and sess.stats.updates == 1
    if fail == "bad_delete":
        assert isinstance(err.value.cause, ValueError)
    assert (fr.arrays_version, sess.cache_version,
            fr.rvset_cache.repair_debt) == versions
    assert fr.rvset_cache is cache
    for name, arr in snap_arrays.items():
        np.testing.assert_array_equal(fr.arrays[name], arr, err_msg=name)
    b_index, bnodes, n_edges, src_fill, stubs, g = bookkeeping
    np.testing.assert_array_equal(fr.b_index, b_index)
    np.testing.assert_array_equal(fr.bnodes, bnodes)
    np.testing.assert_array_equal(fr.n_edges, n_edges)
    np.testing.assert_array_equal(fr.src_fill, src_fill)
    assert fr.stubs == stubs and fr.g is g
    assert "_sharded_device_inputs" not in fr.__dict__
    assert cache.arrays == cache_arrays
    _check_held(cache, held)
    monkeypatch.undo()
    after = [(r.answer, r.distance) for r in
             sess.run([Dist(s, t) for s, t in pairs])]
    assert after == before
    # the same delta then applies cleanly, and writes into no old tensor
    sess.chaos = None
    if fail != "bad_delete":
        assert sess.apply(delta).mode == "repair"
        for name, (obj, copy) in held.items():
            assert torch.equal(obj, copy), f"{name} was written in place"
        _check_answers(fr, sess, np.random.default_rng(1))


def test_successful_repairs_write_into_no_old_tensor():
    """Each mode binds new tensors: the tensors the cache held before a
    delta keep their contents (what makes a snapshot of references
    sound)."""
    _, fr = _dynamic_case(24, 60, 4, seed=9)
    sess = _session(fr)
    rng = np.random.default_rng(9)
    for adds, dels in _stream(fr, rng, 6):
        cache = fr.rvset_cache
        held = {name: (getattr(cache, name), getattr(cache, name).clone())
                for name in CACHE_TENSORS}
        arrays = {k: (v, v.clone()) for k, v in cache.arrays.items()}
        sess.apply(_deltas(adds, dels)[1])
        for name, (obj, copy) in list(held.items()) + list(arrays.items()):
            assert torch.equal(obj, copy), f"{name} was written in place"


# ---------------------------------------------------------------------------
# apply on a shard_map session: the host path
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo_rank(tmp_path):
    """A one-rank gloo process group on a FileStore, destroyed after."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_apply_on_sharded_session(gloo_rank):
    """session.apply on backend='shard_map' repairs through the host path
    (the same UpdateStats as a vmap session on a twin fragmentation); the
    sharded batches then answer on the updated graph, their device uploads
    re-keyed by the bumped arrays_version."""
    _, fr = _dynamic_case(24, 60, 4, seed=4)
    _, twin = _dynamic_case(24, 60, 4, seed=4)
    sess = repro_torch.connect(fr, backend="shard_map", device="cpu")
    vmap = _session(twin)
    sess.warm(with_dist=True)
    assert sess.backend == "shard_map"
    rng = np.random.default_rng(4)
    pairs = [(int(rng.integers(24)), int(rng.integers(24)))
             for _ in range(8)]
    queries = [Reach(s, t) for s, t in pairs] + [Dist(s, t) for s, t in pairs]
    sess.run(queries)
    memo = set(fr.__dict__["_sharded_device_inputs"])
    for adds, dels in _stream(fr, rng, 4):
        td = _deltas(adds, dels)[1]
        got, want = sess.apply(td), vmap.apply(td)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        tdist.collectives = 0
        res = sess.run(queries)
        assert tdist.collectives == 2
        for q, r in zip(queries, res):
            if isinstance(q, Reach):
                assert r.answer == oracle_reach(fr.g, q.s, q.t), q
            else:
                assert r.distance == oracle_dist(fr.g, q.s, q.t), q
    assert set(fr.__dict__["_sharded_device_inputs"]) != memo
