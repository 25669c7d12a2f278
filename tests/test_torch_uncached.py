"""The port's one-shot algorithms (``connect(fr, cache="none")``, the
``core.api`` shims and the single-query sharded functions) vs the JAX
package: localEval row blocks, evalDG, answers, distances and QueryStats,
all bit-equal, and the answers equal to the host oracles.

Inputs are the generators of tests/test_core_reach.py (erdos_renyi over 4
labels, random partition, n <= 40, k <= 4), made from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro
import repro_torch
from repro.core import Dist as JDist
from repro.core import Reach as JReach
from repro.core import Rpq as JRpq
from repro.core import api as japi
from repro.core import build_query_automaton as j_automaton
from repro.core import engine as jengine
from repro.core import fragment_graph as j_fragment
from repro.core import query_slots as j_slots
from repro.core import session as jsession
from repro.graph import erdos_renyi as j_er
from repro.graph import random_partition as j_random_partition
from repro_torch import Dist, NoCudaDevice, Reach, Rpq, Status
from repro_torch.core import api as tapi
from repro_torch.core import automaton as tauto
from repro_torch.core import distributed as tdist
from repro_torch.core import engine as tengine
from repro_torch.core import session as tsession
from repro_torch.core.engine import INF
from repro_torch.core.fragments import fragment_graph, query_slots
from repro_torch.graph import erdos_renyi, random_partition
from repro_torch.kernels.bool_matmul import padded_zeros
from repro_torch.kernels.tropical_matmul import ROW_CAP
from repro_torch import tracing

from oracles import oracle_dist, oracle_reach, oracle_rpq

REGEXES = ["(0|1)* 2", "0* 1*"]
# (n, m, k, seed, reserve_boundary): test_core_reach's sizes, one case with
# spare boundary slots, and one fragment (no boundary at all).  The tests
# against the JAX package mostly share CASES[1:3], so that its compiled
# programs are reused within the module.
CASES = [(24, 70, 3, 0, 0), (36, 110, 4, 1, 0), (30, 90, 2, 2, 4),
         (16, 40, 1, 3, 0)]


def _fragmentations(case):
    n, m, k, seed, rb = case
    jg = j_er(n, m, n_labels=4, seed=seed)
    tg = erdos_renyi(n, m, n_labels=4, seed=seed)
    return (j_fragment(jg, j_random_partition(jg, k, seed), k,
                       reserve_boundary=rb),
            fragment_graph(tg, random_partition(tg, k, seed), k,
                           reserve_boundary=rb))


def _pairs(n, seed, count=6):
    rng = np.random.default_rng(seed + 100)
    p = rng.integers(0, n, size=(count, 2))
    p[0] = (p[0, 0], p[0, 0])                               # s == t
    return [(int(s), int(t)) for s, t in p]


def _scatter(rows, block, side, fill):
    """The row block written into a [side, side] matrix of ``fill``."""
    out = torch.full((side, side), fill, dtype=block.dtype)
    out[rows] = block
    return out.numpy()


def _tensors(fr, f):
    """Fragment ``f``'s arrays as [1, ...] tensors."""
    return {name: torch.tensor(v[f:f + 1]) for name, v in fr.arrays.items()}


# ---------------------------------------------------------------------------
# localEval: row blocks against the JAX per-fragment matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=str)
def test_local_eval_reach_and_dist_match_reference(case):
    """Each fragment's (rows, block), scattered into a zero [B, B] matrix,
    equals JAX's local_eval_reach; the tropical block, scattered into INF,
    equals JAX's local_eval_dist exact and capped."""
    jfr, tfr = _fragmentations(case)
    B, n_max = tfr.B, tfr.n_max
    for s, t in _pairs(tfr.g.n, case[3], 3):
        js, ts = j_slots(jfr, s, t), query_slots(tfr, s, t)
        for f in range(tfr.k):
            a = tfr.arrays
            jargs = [jnp.asarray(a[name][f]) for name in
                     ("esrc", "edst", "src_local", "src_row", "tgt_local")]
            jst = (jnp.int32(js["s_local"][f]), jnp.int32(js["t_local"][f]))
            ta = _tensors(tfr, f)
            targs = [ta[name] for name in
                     ("esrc", "edst", "src_local", "src_row", "tgt_local")]
            tst = (torch.tensor(ts["s_local"][f:f + 1]),
                   torch.tensor(ts["t_local"][f:f + 1]))
            want = jengine.local_eval_reach(*jargs, *jst, n_max=n_max, B=B)
            rows, block = tengine.local_eval_reach(*targs, *tst, n_max=n_max,
                                                   B=B)
            assert bool((rows < B).all())
            np.testing.assert_array_equal(_scatter(rows, block, B, False),
                                          np.asarray(want))
            for cap in (INF, 0, 1, 3):
                want = jengine.local_eval_dist(*jargs, *jst, jnp.int32(cap),
                                               n_max=n_max, B=B)
                rows, block = tengine.local_eval_dist(*targs, *tst, cap,
                                                      n_max=n_max, B=B)
                np.testing.assert_array_equal(
                    _scatter(rows, block, B, INF), np.asarray(want),
                    err_msg=f"cap {cap}")


@pytest.mark.parametrize("case", CASES[1:2], ids=str)
def test_capped_propagation_matches_reference(case):
    """The repaired ``_propagate_dist(cap=...)``: a capped all-sources
    fixpoint snaps every entry above the cap to INF after each step, entry
    for entry as JAX's, and the default cap keeps the uncapped fixpoint."""
    jfr, tfr = _fragmentations(case)
    n_max = tfr.n_max
    a = tfr.arrays
    esrc, edst = torch.tensor(a["esrc"]), torch.tensor(a["edst"])
    start = torch.full((tfr.k, tfr.s_max, n_max + 1), INF, dtype=torch.int32)
    start.scatter_(2, torch.tensor(a["src_local"]).long()[:, :, None], 0)
    start[:, :, n_max] = INF
    for cap in (INF, 0, 1, 2, 5):
        got = tengine._propagate_dist(esrc, edst, start, cap)
        for f in range(tfr.k):
            want = jengine._propagate_dist(
                jnp.asarray(a["esrc"][f]), jnp.asarray(a["edst"][f]),
                jnp.asarray(start[f].numpy()), jnp.int32(cap))
            np.testing.assert_array_equal(got[f].numpy(), np.asarray(want),
                                          err_msg=f"cap {cap}")
    assert torch.equal(tengine._propagate_dist(esrc, edst, start),
                       tengine._propagate_dist(esrc, edst, start, INF))


@pytest.mark.parametrize("regex", REGEXES)
@pytest.mark.parametrize("case", CASES[1:3], ids=str)
def test_local_eval_regular_matches_reference(case, regex):
    """Product rvset rows per fragment, scattered into a zero [(B*Q),
    (B*Q)] matrix, equal JAX's local_eval_regular; regular_rvset assembles
    their OR fragment by fragment."""
    jfr, tfr = _fragmentations(case)
    B, n_max = tfr.B, tfr.n_max
    qa_j, qa_t = j_automaton(regex, int), tauto.build_query_automaton(regex,
                                                                     int)
    Q = qa_t.n_states
    q_lab, q_tr = torch.tensor(qa_t.state_labels), torch.tensor(qa_t.trans)
    names = ("esrc", "edst", "src_local", "src_row", "tgt_local", "labels",
             "gids")
    for s, t in _pairs(tfr.g.n, case[3], 2)[1:]:
        js, ts = j_slots(jfr, s, t), query_slots(tfr, s, t)
        want_all = np.zeros((B * Q, B * Q), dtype=bool)
        for f in range(tfr.k):
            want = np.asarray(jengine.local_eval_regular(
                *(jnp.asarray(tfr.arrays[name][f]) for name in names),
                jnp.asarray(qa_j.state_labels), jnp.asarray(qa_j.trans),
                jnp.int32(js["s_local"][f]), jnp.int32(js["t_local"][f]),
                jnp.int32(s), jnp.int32(t), n_max=n_max, B=B))
            ta = _tensors(tfr, f)
            rows, block = tengine.local_eval_regular(
                *(ta[name] for name in names), q_lab, q_tr,
                torch.tensor(ts["s_local"][f:f + 1]),
                torch.tensor(ts["t_local"][f:f + 1]), s, t, n_max=n_max, B=B)
            np.testing.assert_array_equal(
                _scatter(rows, block, B * Q, False), want)
            want_all |= want
        tarr = {name: torch.tensor(v) for name, v in tfr.arrays.items()}
        D = tengine.regular_rvset(
            *(tarr[name] for name in names), q_lab, q_tr,
            torch.tensor(ts["s_local"]), torch.tensor(ts["t_local"]), s, t,
            n_max=n_max, B=B, side=B * Q)
        np.testing.assert_array_equal(D.numpy(), want_all)


# ---------------------------------------------------------------------------
# evalDG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,density", [(9, 0.2), (70, 0.03)])
def test_evaldg_matches_reference(B, density):
    """Single-source fixpoints on random dependency matrices: the or-and
    vector-matrix steps (on D as it is stored, padded or not) and the
    min-plus steps agree with JAX's evaldg_reach / evaldg_dist."""
    rng = np.random.default_rng(B)
    D = rng.random((B, B)) < density
    W = np.where(rng.random((B, B)) < density,
                 rng.integers(0, 5, (B, B)), INF).astype(np.int32)
    for trial in range(4):
        src = np.zeros(B, dtype=bool)
        src[rng.integers(B)] = True
        tgt = rng.random(B) < 0.2
        if trial == 3:
            src[:] = False                                 # nothing to start
        want = bool(jengine.evaldg_reach(jnp.asarray(D), jnp.asarray(src),
                                         jnp.asarray(tgt)))
        for Dm in (torch.tensor(D),
                   padded_zeros(B, B, "cpu").copy_(torch.tensor(D))):
            assert tengine.evaldg_reach(Dm, torch.tensor(src),
                                        torch.tensor(tgt)) is want
        want = int(jengine.evaldg_dist(jnp.asarray(W), jnp.asarray(src),
                                       jnp.asarray(tgt)))
        assert tengine.evaldg_dist(torch.tensor(W), torch.tensor(src),
                                   torch.tensor(tgt)) == want


# ---------------------------------------------------------------------------
# the session with cache="none", and the api shims
# ---------------------------------------------------------------------------

def _mixed(n, seed):
    """(kind, s, t, bound, regex) rows; a small endpoint pool forces
    duplicate pairs, and s == t."""
    rng = np.random.default_rng(seed)
    pool = [tuple(int(x) for x in rng.integers(0, n, 2)) for _ in range(5)]
    pool.append((2, 2))
    rows = []
    for i in range(12):
        s, t = pool[int(rng.integers(0, len(pool)))]
        rows.append((i % 4, s, t, int(rng.integers(-1, 4)), REGEXES[i % 2]))
    return rows


def _queries(rows, reach, dist_, rpq, return_matrix=False):
    out = []
    for kind, s, t, b, rx in rows:
        if kind == 0:
            out.append(reach(s, t, return_matrix=return_matrix))
        elif kind == 1:
            out.append(dist_(s, t, bound=None if b < 0 else b))
        else:
            out.append(rpq(s, t, regex=rx, return_matrix=return_matrix))
    return out


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


@pytest.mark.parametrize("case", CASES[1:3], ids=str)
def test_uncached_session_matches_reference(case):
    """connect(fr, cache="none").run(mixed batch) == repro.connect(fr,
    cache="none"): answers, distances, QueryStats, the dependency matrix of
    return_matrix queries, and cache_version None; and the oracles."""
    jfr, tfr = _fragmentations(case)
    rows = _mixed(case[0], case[3])
    want = repro.connect(jfr, backend="vmap", cache="none").run(
        _queries(rows, JReach, JDist, JRpq, return_matrix=True))
    sess = repro_torch.connect(tfr, cache="none", device="cpu")
    queries = _queries(rows, Reach, Dist, Rpq, return_matrix=True)
    got = sess.run(queries)
    for q, r, w in zip(queries, got, want):
        assert (r.answer, r.distance) == (w.answer, w.distance), q
        assert tuple(r.stats) == tuple(w.stats), q
        assert (r.cache_version, r.status) == (None, Status.DONE)
        if w.dependency_matrix is None:
            assert r.dependency_matrix is None, q
        else:
            np.testing.assert_array_equal(r.dependency_matrix,
                                          w.dependency_matrix)
    _check_oracles(tfr.g, queries, got)
    assert sess.stats.executions == len(queries)
    assert tfr.rvset_cache is None            # one-shot: no state left


def test_uncached_stamp_ignores_an_existing_cache():
    """A cache on the shared fragmentation is not consulted, and results
    say so: cache_version None."""
    _, tfr = _fragmentations(CASES[0])
    repro_torch.connect(tfr, device="cpu").warm(with_dist=True)
    got = repro_torch.connect(tfr, cache="none", device="cpu").run(
        [Reach(0, 5), Dist(1, 7, bound=2)])
    assert [r.cache_version for r in got] == [None, None]
    assert tfr.rvset_cache.version == 0


@pytest.mark.parametrize("case", [CASES[1], CASES[3]], ids=str)
def test_api_shims_match_reference(case):
    """dis_reach / dis_dist / dis_rpq / dis_rpq_regex with device="cpu"
    == repro.core.api's, query for query (s == t and the single fragment
    included); they run on one memoized uncached default session."""
    jfr, tfr = _fragmentations(case)
    qa_j = j_automaton(REGEXES[0], int)
    qa_t = tauto.build_query_automaton(REGEXES[0], int)
    for s, t in _pairs(tfr.g.n, case[3], 3):
        pairs = [
            (japi.dis_reach(jfr, s, t, return_matrix=True),
             tapi.dis_reach(tfr, s, t, return_matrix=True, device="cpu")),
            (japi.dis_dist(jfr, s, t), tapi.dis_dist(tfr, s, t, device="cpu")),
            (japi.dis_dist(jfr, s, t, bound=2),
             tapi.dis_dist(tfr, s, t, bound=2, device="cpu")),
            (japi.dis_rpq(jfr, s, t, qa_j),
             tapi.dis_rpq(tfr, s, t, qa_t, device="cpu")),
            (japi.dis_rpq_regex(jfr, s, t, REGEXES[1]),
             tapi.dis_rpq_regex(tfr, s, t, REGEXES[1], device="cpu")),
        ]
        for w, r in pairs:
            assert (r.answer, r.distance, tuple(r.stats)) == \
                (w.answer, w.distance, tuple(w.stats)), (s, t)
        w, r = pairs[0]
        if w.dependency_matrix is not None:
            np.testing.assert_array_equal(r.dependency_matrix,
                                          w.dependency_matrix)
    sess = tsession.default_session(tfr, cache="none", device="cpu")
    assert sess.cache_mode == "none" and sess.backend == "vmap"
    assert tsession.default_session(tfr, "none", "cpu") is sess
    assert tsession.default_session(tfr, device="cpu") is not sess
    assert tfr.rvset_cache is None


def test_shims_default_to_the_card(monkeypatch):
    """Like connect, the shims run on the CUDA device unless given
    device=, and raise without one instead of falling back."""
    _, tfr = _fragmentations(CASES[3])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice, match='device="cpu"'):
        tapi.dis_reach(tfr, 0, 5)
    with pytest.raises(NoCudaDevice):
        tapi.dis_dist(tfr, 0, 5, device="cuda")
    with pytest.raises(NoCudaDevice):
        tsession.exec_reach(tfr, 0, 5)
    assert tapi.dis_reach(tfr, 0, 5, device="cpu").answer == \
        oracle_reach(tfr.g, 0, 5)


def test_trivial_and_bounded_edges_match_reference():
    """s == t short-circuits with QueryStats(0, 0, B, Q); a failed bounded
    query reports no distance; bound 0 between distinct nodes fails."""
    jfr, tfr = _fragmentations(CASES[1])
    qa_t = tauto.build_query_automaton("0 1", int)
    for s, t, b in [(3, 3, 0), (3, 3, None), (0, 5, 0), (0, 5, 1),
                    (0, 5, None), (5, 0, 2)]:
        w = jsession.exec_dist(jfr, s, t, bound=b)
        r = tsession.exec_dist(tfr, s, t, bound=b, device="cpu")
        assert (r.answer, r.distance, tuple(r.stats)) == \
            (w.answer, w.distance, tuple(w.stats)), (s, t, b)
    r = tsession.exec_rpq(tfr, 4, 4, qa_t, device="cpu")
    assert (r.answer, tuple(r.stats)) == (False, (0, 0, tfr.B,
                                                  qa_t.n_states))
    assert tsession.exec_reach(tfr, 4, 4, device="cpu").stats == (0, 0,
                                                                  tfr.B, 1)


# ---------------------------------------------------------------------------
# exec_dist on W's row lists, and its dense route
# ---------------------------------------------------------------------------

def _row_list_pairs(fr, seed):
    """A drawn pair, s == t, and s or t a boundary node where there is
    one."""
    rng = np.random.default_rng(seed + 200)
    s, t = (int(v) for v in rng.integers(0, fr.g.n, 2))
    pairs = [(s, t), (t, t)]
    if len(fr.bnodes):
        pairs += [(int(fr.bnodes[0]), t), (s, int(fr.bnodes[-1]))]
    return pairs


def _traced_dist(fr, s, t, bound):
    """exec_dist on the CPU with the recorder on: its result, the
    oneshot.evaldg spans' counts and the oneshot.query span's."""
    tracing.enable()
    try:
        got = tsession.exec_dist(fr, s, t, bound=bound, device="cpu")
    finally:
        tracing.disable()
    spans = [r for r in tracing.drain() if r.kind == "span"]
    return (got, [r.counts for r in spans if r.name == "oneshot.evaldg"],
            [r.counts for r in spans if r.name == "oneshot.query"])


def _finite_per_row(fr, s, t, cap):
    """The finite entries of W a row, from the row block of every
    fragment."""
    qs = query_slots(fr, s, t)
    a = fr.arrays
    args = [torch.tensor(a[n]) for n in ("esrc", "edst", "src_local",
                                         "src_row", "tgt_local")]
    args += [torch.tensor(qs[n]) for n in ("s_local", "t_local")]
    _, block = tengine.local_eval_dist(*args, cap, n_max=fr.n_max, B=fr.B)
    return (block < INF).sum(1)


@pytest.mark.parametrize("bound", [None, 0, 1, 6], ids=str)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_exec_dist_on_row_lists_matches_reference(case, bound):
    """exec_dist, which keeps W as row lists, against JAX's exec_dist: a
    drawn pair, s == t, s or t a boundary node; the traced evalDG counts
    the pairs the lists hold (oneshot.w_entries), W's finite entries, and
    no query takes the dense route."""
    jfr, tfr = _fragmentations(case)
    cap = INF if bound is None else bound
    for s, t in _row_list_pairs(tfr, case[3]):
        want = jsession.exec_dist(jfr, s, t, bound=bound)
        got, evaldg, query = _traced_dist(tfr, s, t, bound)
        assert (got.answer, got.distance, tuple(got.stats)) == \
            (bool(want.answer), want.distance, tuple(want.stats)), (s, t)
        if s == t:
            assert evaldg == []
            continue
        counts, = evaldg
        assert counts["oneshot.w_entries"] == int(
            _finite_per_row(tfr, s, t, cap).sum()), (s, t)
        assert "oneshot.dense_fallbacks" not in query[0], (s, t)


@pytest.mark.parametrize("bound", [None, 0, 1, 6], ids=str)
def test_exec_dist_past_the_row_lists_takes_the_dense_route(bound):
    """Two fragments of a dense graph, whose rows reach more stubs than a
    row list holds: every query answers as JAX's exec_dist does, and one
    that overflowed the lists is answered again on the dense W, counted
    once in oneshot.dense_fallbacks, its second evalDG a dense one."""
    jg = j_er(160, 2400, n_labels=4, seed=7)
    tg = erdos_renyi(160, 2400, n_labels=4, seed=7)
    jfr = j_fragment(jg, j_random_partition(jg, 2, 7), 2)
    tfr = fragment_graph(tg, random_partition(tg, 2, 7), 2)
    cap = INF if bound is None else bound
    rng = np.random.default_rng(8)
    pairs = [tuple(int(v) for v in p) for p in rng.integers(0, 160, (4, 2))
             if p[0] != p[1]]
    pairs.append((int(tfr.bnodes[0]), int(tfr.bnodes[-1])))
    fell_back = 0
    for s, t in pairs:
        want = jsession.exec_dist(jfr, s, t, bound=bound)
        got, evaldg, query = _traced_dist(tfr, s, t, bound)
        assert (got.answer, got.distance) == (bool(want.answer),
                                              want.distance), (s, t)
        over = int(_finite_per_row(tfr, s, t, cap).max()) > ROW_CAP
        assert query[0].get("oneshot.dense_fallbacks", 0) == int(over)
        assert len(evaldg) == 1 + over
        if over:
            assert "evaldg.rows" not in evaldg[0]
            assert evaldg[1]["evaldg.rows"] > 0
        fell_back += over
    assert fell_back == (len(pairs) if bound is None else fell_back)


# ---------------------------------------------------------------------------
# single-query sharded functions on a one-rank gloo group
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


@pytest.mark.parametrize("case", CASES[1:3], ids=str)
def test_single_query_sharded_matches_reference(gloo_rank, case):
    """dis_reach_sharded: (answer, D) equal to JAX exec_reach's answer and
    matrix and to the port's exec_reach, with one collective of exactly
    traffic_bits("reach") bits; dis_rpq_sharded: the answer of exec_rpq
    with one collective of traffic_bits("rpq", states=Q) bits."""
    jfr, tfr = _fragmentations(case)
    qa = tauto.build_query_automaton(REGEXES[0], int)
    for s, t in _pairs(tfr.g.n, case[3])[1:]:
        if s == t:
            continue
        tdist.collectives = tdist.payload_bits = 0
        ans, D = tdist.dis_reach_sharded(tfr, s, t, device="cpu")
        assert (tdist.collectives, tdist.payload_bits) == \
            (1, tfr.traffic_bits("reach"))
        want = jsession.exec_reach(jfr, s, t, return_matrix=True)
        assert ans is want.answer
        np.testing.assert_array_equal(D, want.dependency_matrix)
        mine = tsession.exec_reach(tfr, s, t, return_matrix=True,
                                   device="cpu")
        np.testing.assert_array_equal(D, mine.dependency_matrix)
        tdist.collectives = tdist.payload_bits = 0
        got = tdist.dis_rpq_sharded(tfr, s, t, qa, device="cpu")
        assert (tdist.collectives, tdist.payload_bits) == \
            (1, tfr.traffic_bits("rpq", states=qa.n_states))
        assert got is tsession.exec_rpq(tfr, s, t, qa, device="cpu").answer
        assert got == oracle_rpq(tfr.g, s, t, j_automaton(REGEXES[0], int))
    tdist.collectives = 0
    assert tdist.dis_reach_sharded(tfr, 2, 2, device="cpu") == (True, None)
    assert tdist.dis_rpq_sharded(tfr, 2, 2, qa, device="cpu") is False
    assert tdist.collectives == 0             # s == t evaluates nothing


def test_uncached_sharded_session_runs_one_shot(gloo_rank):
    """cache="none" answers with the one-shot engine whatever the
    backend, as in the reference package."""
    jfr, tfr = _fragmentations(CASES[1])
    rows = _mixed(CASES[1][0], 7)
    want = repro.connect(jfr, backend="vmap", cache="none").run(
        _queries(rows, JReach, JDist, JRpq))
    sess = repro_torch.connect(tfr, backend="shard_map", cache="none",
                               device="cpu")
    got = sess.run(_queries(rows, Reach, Dist, Rpq))
    assert [(r.answer, r.distance, tuple(r.stats)) for r in got] == \
        [(r.answer, r.distance, tuple(r.stats)) for r in want]
