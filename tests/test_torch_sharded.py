"""The port's sharded backend (``connect(fr, backend="shard_map")`` over
torch.distributed) vs the JAX package's shard_map backend.

In-process tests hold the port's Placement, packed device inputs and
packed local stages bit-equal to the JAX functions, and run the session on
a one-rank gloo group (d = 1, every fragment packed on one rank).  One
spawned run of 8 gloo ranks (k = 16 and k = 32 fragments) writes a report
that several tests read: answers equal on every rank and to the oracles,
exactly one collective per fused group, payload bits == traffic_bits.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro
import repro_torch
from repro.core import Dist as JDist
from repro.core import Placement as JPlacement
from repro.core import Reach as JReach
from repro.core import Rpq as JRpq
from repro.core import build_query_automaton as j_automaton
from repro.core import cache as jcache
from repro.core import distributed as jdist
from repro.core import fragment_graph as j_fragment
from repro.graph import erdos_renyi as j_er
from repro.graph import random_partition as j_random_partition
from repro_torch import Dist, Placement, Reach, Rpq
from repro_torch.core import automaton as tauto
from repro_torch.core import cache as tcache
from repro_torch.core import distributed as tdist
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import erdos_renyi, random_partition

from oracles import oracle_dist, oracle_reach, oracle_rpq

REGEXES = ["(0|1)* 2", "0* 1*"]


def _case(n, m, k, seed, **kw):
    """The same fragmentation in both packages (test_placement's
    generator: erdos_renyi over 3 labels, random partition)."""
    jg = j_er(n, m, n_labels=3, seed=seed)
    tg = erdos_renyi(n, m, n_labels=3, seed=seed)
    return (j_fragment(jg, j_random_partition(jg, k, seed), k, **kw),
            fragment_graph(tg, random_partition(tg, k, seed), k, **kw))


def _results(results):
    return [(r.answer, r.distance, tuple(r.stats)) for r in results]


# ---------------------------------------------------------------------------
# Placement (the cases of tests/test_placement.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,k,d", [(0, 8, 3), (1, 16, 8), (2, 32, 8),
                                      (3, 5, 5), (4, 9, 2)])
def test_placement_matches_reference(seed, k, d):
    jfr, tfr = _case(12 * k, 30 * k, k, seed)
    for jpl, tpl in ((JPlacement.balanced(jfr, d), Placement.balanced(tfr, d)),
                     (JPlacement.round_robin(k, d),
                      Placement.round_robin(k, d))):
        assert tpl.device_of == jpl.device_of
        assert (tpl.k, tpl.d, tpl.fpd) == (jpl.k, jpl.d, jpl.fpd)
        np.testing.assert_array_equal(tpl.perm(), jpl.perm())
        assert tpl.max_load(tfr) == jpl.max_load(jfr)
        assert tpl.cache_key() == jpl.cache_key()
    np.testing.assert_array_equal(Placement.fragment_weights(tfr),
                                  JPlacement.fragment_weights(jfr))


def test_placement_skew_and_layout_match_reference():
    """test_placement's skewed fragmentation and its round-robin layout."""
    g = erdos_renyi(96, 260, n_labels=3, seed=7)
    part = np.minimum(np.arange(96) * 8 // 96, 7).astype(np.int32)
    part[:40] = 0
    tfr = fragment_graph(g, part, 8)
    jfr = j_fragment(j_er(96, 260, n_labels=3, seed=7), part, 8)
    for d in (2, 4):
        assert (Placement.balanced(tfr, d).device_of
                == JPlacement.balanced(jfr, d).device_of)
        assert (Placement.balanced(tfr, d).max_load(tfr)
                <= Placement.round_robin(8, d).max_load(tfr))
    pl = Placement.round_robin(7, 3)
    assert pl.perm().tolist() == [0, 3, 6, 1, 4, -1, 2, 5, -1]


@pytest.mark.parametrize("make", [
    lambda P, fr: P.round_robin(4, 8),
    lambda P, fr: P.balanced(fr, 5),
    lambda P, fr: P(k=2, d=3, device_of=(0, 1)),
    lambda P, fr: P(k=4, d=2, device_of=(0, 1, 0)),
    lambda P, fr: P(k=3, d=2, device_of=(0, 1, 2)),
    lambda P, fr: P(k=2, d=0, device_of=()),
], ids=["rr-d>k", "balanced-d>k", "d>k", "length", "range", "d=0"])
def test_placement_errors_match_reference(make):
    """Each invalid placement raises ValueError in both packages, with the
    same first words."""
    jfr, tfr = _case(24, 60, 4, 0)
    with pytest.raises(ValueError) as want:
        make(JPlacement, jfr)
    with pytest.raises(ValueError) as got:
        make(Placement, tfr)
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


# ---------------------------------------------------------------------------
# packed device inputs and local stages
# ---------------------------------------------------------------------------

# (n, m, k, seed, reserve_boundary, placement): fpd = 1, 2 (with a pad
# slot) and 4 (with a pad slot), one case with spare boundary slots
STAGE_CASES = [(30, 90, 3, 0, 0, ("balanced", 3)),
               (30, 90, 3, 1, 4, ("round_robin", 2)),
               (48, 150, 7, 2, 0, ("round_robin", 2))]


def _placements(jfr, tfr, how, d):
    if how == "balanced":
        return JPlacement.balanced(jfr, d), Placement.balanced(tfr, d)
    return JPlacement.round_robin(jfr.k, d), Placement.round_robin(tfr.k, d)


def _slots(fr, pairs):
    """[k, N] local slots of s_j (owner only) and t_j (owner or stub)."""
    ss, tt = pairs[:, 0], pairs[:, 1]
    s_slots = np.full((fr.k, len(pairs)), fr.n_max, dtype=np.int32)
    s_slots[fr.part[ss], np.arange(len(pairs))] = fr.owner_local[ss]
    return s_slots, fr.slot_index()[tt, :].T.copy()


@pytest.mark.parametrize("case", STAGE_CASES, ids=str)
def test_device_inputs_match_reference(case):
    n, m, k, seed, rb, (how, d) = case
    jfr, tfr = _case(n, m, k, seed, reserve_boundary=rb)
    jpl, tpl = _placements(jfr, tfr, how, d)
    want = jdist._device_inputs(jfr, jpl)
    assert tdist._array_pads(tfr) == jdist._array_pads(jfr)
    for got_arr, want_arr in zip(tdist._srcidx_own(tfr),
                                 jdist._srcidx_own(jfr)):
        np.testing.assert_array_equal(got_arr, want_arr)
    got = [tdist._device_inputs(tfr, tpl, r, "cpu") for r in range(d)]
    for name in tfr.arrays:
        np.testing.assert_array_equal(
            torch.cat([g["arrs"][name] for g in got]).numpy(),
            np.asarray(want["arrs"][name]), err_msg=name)
    for name in ("srcidx", "own", "mine"):
        np.testing.assert_array_equal(
            torch.cat([g[name] for g in got]).numpy(),
            np.asarray(want[name]), err_msg=name)
    np.testing.assert_array_equal(got[0]["local_b"].numpy(),
                                  np.asarray(want["local_b"]))
    # memoized per (arrays_version, placement, rank, device)
    assert tdist._device_inputs(tfr, tpl, 0, "cpu") is got[0]
    tfr.arrays_version += 1
    assert tdist._device_inputs(tfr, tpl, 0, "cpu") is not got[0]


@pytest.mark.parametrize("case", STAGE_CASES, ids=str)
def test_packed_local_stages_match_reference(case):
    """The merged (d0, sb, direct, tc) of every rank's packed local stage
    equal the JAX local_stage_*_packed outputs, for all three kinds."""
    n, m, k, seed, rb, (how, d) = case
    jfr, tfr = _case(n, m, k, seed, reserve_boundary=rb)
    jpl, tpl = _placements(jfr, tfr, how, d)
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n, size=(10, 2))
    pairs[0] = (3, 3)
    s_slots, t_slots = _slots(tfr, pairs)
    perm, fpd, nb = tpl.perm(), tpl.fpd, tfr.n_boundary
    jin = jdist._device_inputs(jfr, jpl)
    s_pack = tdist._pack_rows(s_slots, perm, tfr.n_max)
    t_pack = tdist._pack_rows(t_slots, perm, tfr.n_max)
    qa_j = j_automaton(REGEXES[0], int)
    qa_t = tauto.build_query_automaton(REGEXES[0], int)
    for rank in range(d):
        rows = slice(rank * fpd, (rank + 1) * fpd)
        tin = tdist._device_inputs(tfr, tpl, rank, "cpu")
        ja = {name: v[rows] for name, v in jin["arrs"].items()}
        ta = tin["arrs"]
        js, jt = jnp.asarray(s_pack[rows]), jnp.asarray(t_pack[rows])
        ts, tt = torch.tensor(s_pack[rows]), torch.tensor(t_pack[rows])
        for jfn, tfn in ((jcache.local_stage_reach_packed,
                          tcache.local_stage_reach_packed),
                         (jcache.local_stage_dist_packed,
                          tcache.local_stage_dist_packed)):
            want = jfn(ja["esrc"], ja["edst"], ja["src_local"], js, jt,
                       jin["srcidx"][rows], jin["own"][rows],
                       ja["tgt_local"][:, :nb], n_max=jfr.n_max)
            got = tfn(ta["esrc"], ta["edst"], ta["src_local"], ts, tt,
                      tin["srcidx"], tin["own"], ta["tgt_local"][:, :nb],
                      n_max=tfr.n_max)
            for name, g, w in zip(("d0", "sb", "direct", "tc"), got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"{tfn.__name__} {name}")
        want = jcache.local_stage_rpq_packed(
            ja["esrc"], ja["edst"], ja["src_local"], ja["src_row"],
            ja["tgt_local"], ja["labels"], ja["gids"],
            jnp.asarray(qa_j.state_labels), jnp.asarray(qa_j.trans),
            jnp.int32(qa_j.start), js, jt,
            jnp.asarray(pairs[:, 0].astype(np.int32)),
            jnp.asarray(pairs[:, 1].astype(np.int32)), jin["local_b"],
            jin["mine"][rows], n_max=jfr.n_max, B=jfr.B)
        got = tcache.local_stage_rpq_packed(
            ta["esrc"], ta["edst"], ta["src_local"], ta["src_row"],
            ta["tgt_local"], ta["labels"], ta["gids"],
            torch.tensor(qa_t.state_labels), torch.tensor(qa_t.trans),
            int(qa_t.start), ts, tt,
            torch.tensor(pairs[:, 0].astype(np.int32)),
            torch.tensor(pairs[:, 1].astype(np.int32)), tin["local_b"],
            tin["mine"], n_max=tfr.n_max, B=tfr.B)
        for name, g, w in zip(("d0", "sb", "direct", "tc"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"rpq {name}")


def test_unpacked_local_stage_is_one_fragment():
    """local_stage_reach on one fragment == the JAX per-fragment stage."""
    jfr, tfr = _case(30, 90, 3, 0)
    pairs = np.array([[0, 7], [5, 5], [11, 2]])
    s_slots, t_slots = _slots(tfr, pairs)
    srcidx, own = tdist._srcidx_own(tfr)
    nb = tfr.n_boundary
    for f in range(tfr.k):
        a = {name: v[f] for name, v in tfr.arrays.items()}
        want = jcache.local_stage_reach(
            *(jnp.asarray(x) for x in (a["esrc"], a["edst"], a["src_local"],
                                       s_slots[f], t_slots[f], srcidx[f],
                                       own[f], a["tgt_local"][:nb])),
            n_max=jfr.n_max)
        got = tcache.local_stage_reach(
            *(torch.tensor(x) for x in (a["esrc"], a["edst"], a["src_local"],
                                        s_slots[f], t_slots[f], srcidx[f],
                                        own[f], a["tgt_local"][:nb])),
            n_max=tfr.n_max)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the session on a one-rank gloo group (d = 1, fpd = k)
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


def _mixed(n, seed):
    rng = np.random.default_rng(seed)
    pool = [tuple(int(x) for x in rng.integers(0, n, 2)) for _ in range(6)]
    pool.append((2, 2))
    rows = []
    for i in range(24):
        s, t = pool[int(rng.integers(0, len(pool)))]
        rows.append((i % 4, s, t, int(rng.integers(-1, 4)), REGEXES[i % 2]))
    return rows


def _queries(rows, reach, dist_, rpq):
    return [reach(s, t) if kind == 0 else
            dist_(s, t, bound=None if b < 0 else b) if kind == 1 else
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


@pytest.mark.parametrize("case", [(28, 80, 4, 5), (20, 50, 3, 6)],
                         ids=str)
def test_sharded_session_d1_matches_reference(gloo_rank, case):
    """backend='shard_map' on one rank packs every fragment onto it; a
    mixed batch equals repro.connect(fr, backend='vmap') in answers,
    distances and QueryStats, and the oracles.  One collective per fused
    group, with payload bits == traffic_bits."""
    jfr, tfr = _case(*case)
    rows = _mixed(case[0], case[3])
    want = repro.connect(jfr, backend="vmap").run(
        _queries(rows, JReach, JDist, JRpq))
    sess = repro_torch.connect(tfr, backend="shard_map", device="cpu")
    assert sess.backend == "shard_map"
    assert sess.placement.d == 1 and sess.placement.fpd == tfr.k
    queries = _queries(rows, Reach, Dist, Rpq)
    tdist.collectives = tdist.payload_bits = 0
    got = sess.run(queries)
    assert _results(got) == _results(want)
    _check_oracles(tfr.g, queries, got)
    groups = sess.last_plan.groups
    assert tdist.collectives == len(groups) == sess.stats.executions
    assert tdist.payload_bits == sum(
        tfr.traffic_bits(gr.kind, states=1 if gr.automaton is None
                         else gr.automaton.n_states, batch=gr.padded_size)
        for gr in groups)
    assert sess.stats.degraded_groups == 0
    assert tfr.rvset_cache is None        # the sharded path builds no cache


def test_packed_single_rank_queries_of_reference(gloo_rank):
    """tests/test_placement.py's single-device case, query for query."""
    jfr, tfr = _case(28, 80, 4, 5)
    jq = [JReach(0, 9), JReach(9, 9), JDist(1, 7), JDist(3, 3, bound=0),
          JRpq(2, 11, regex=REGEXES[0]), JReach(6, 0)]
    tq = [Reach(0, 9), Reach(9, 9), Dist(1, 7), Dist(3, 3, bound=0),
          Rpq(2, 11, regex=REGEXES[0]), Reach(6, 0)]
    want = repro.connect(jfr, backend="shard_map").run(jq)
    got = repro_torch.connect(tfr, backend="shard_map", device="cpu").run(tq)
    assert _results(got) == _results(want)
    _check_oracles(tfr.g, tq, got)


def test_explicit_placement_threads_through_session(gloo_rank):
    _, tfr = _case(20, 50, 3, 6)
    pl = Placement(k=3, d=1, device_of=(0, 0, 0))
    sess = repro_torch.connect(tfr, backend="shard_map", placement=pl,
                               device="cpu")
    assert sess.placement is pl
    assert sess.run(Reach(0, 5))[0].answer == oracle_reach(tfr.g, 0, 5)
    with pytest.raises(ValueError, match="placement"):
        repro_torch.connect(tfr, placement=Placement.round_robin(4, 2),
                            device="cpu")
    with pytest.raises(ValueError, match="2 ranks|expects 2"):
        repro_torch.connect(tfr, backend="shard_map",
                            placement=Placement.round_robin(3, 2),
                            device="cpu")


def test_auto_stays_vmap_on_one_rank(gloo_rank):
    _, tfr = _case(20, 50, 3, 6)
    assert repro_torch.connect(tfr, device="cpu").backend == "vmap"


def test_shard_map_needs_a_process_group():
    """No group is created behind the caller's back."""
    assert not dist.is_initialized()
    _, tfr = _case(20, 50, 3, 6)
    with pytest.raises(RuntimeError, match="init_process_group"):
        repro_torch.connect(tfr, backend="shard_map", device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tdist.dis_reach_batch_sharded(tfr, [(0, 1)], device="cpu")
    assert repro_torch.connect(tfr, device="cpu").backend == "vmap"


def test_empty_sharded_batches(gloo_rank):
    _, tfr = _case(20, 50, 3, 6)
    qa = tauto.build_query_automaton(REGEXES[1], int)
    assert tdist.dis_reach_batch_sharded(tfr, [], device="cpu").shape == (0,)
    assert tdist.dis_dist_batch_sharded(tfr, [], device="cpu").dtype == np.int64
    assert tdist.dis_rpq_batch_sharded(tfr, [], qa, device="cpu").shape == (0,)


# ---------------------------------------------------------------------------
# 8 gloo ranks: k = 16 and k = 32 fragments on d = 8
# ---------------------------------------------------------------------------

N_RANKS = 8
# (k, n, m): tests/test_placement.py's scale-out graphs
SCALEOUT = [(16, 64, 180), (32, 96, 280)]

_RANK = r"""
import json, sys
sys.path.insert(0, __SRC__)
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + __STORE__,
                        rank=rank, world_size=__RANKS__)
import repro_torch
from repro_torch import Dist, Reach, Rpq
from repro_torch.core import distributed as D
from repro_torch.core import session as QS
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import erdos_renyi, random_partition

report = {}
rng = np.random.default_rng(11)
for k, n, m in __SCALEOUT__:
    g = erdos_renyi(n, m, n_labels=3, seed=k)
    fr = fragment_graph(g, random_partition(g, k, 1), k, reserve_boundary=8,
                        reserve_edges=32, reserve_stubs=16)
    sess = repro_torch.connect(fr, device="cpu")      # auto: d = 8 <= k
    pairs = [(int(rng.integers(n)), int(rng.integers(n))) for _ in range(6)]
    queries = ([Reach(s, t) for s, t in pairs] + [Dist(s, t) for s, t in pairs]
               + [Rpq(s, t, regex="(0|1)* 2") for s, t in pairs])
    D.collectives = D.payload_bits = 0
    res = sess.run(queries)
    mixed = [D.collectives, D.payload_bits]
    plan = sess.last_plan
    groups = []
    for grp in plan.groups:
        states = 1 if grp.automaton is None else grp.automaton.n_states
        D.collectives = D.payload_bits = 0
        sess.run([queries[i] for i in grp.indices])
        groups.append(dict(
            kind=grp.kind, collectives=D.collectives, bits=D.payload_bits,
            traffic_bits=fr.traffic_bits(grp.kind, states=states,
                                         batch=grp.padded_size),
            stats_bits=sum(res[i].stats.payload_bits for i in grp.indices),
            rounds=sum(res[i].stats.collective_rounds for i in grp.indices)))
    answers = [[r.answer, r.distance] for r in res]
    # the single-query one-shot functions: one collective of traffic_bits
    qa = sess._resolve_automaton(queries[-1])
    one_shot = []
    for s, t in pairs[:3]:
        D.collectives = D.payload_bits = 0
        ans, mat = D.dis_reach_sharded(fr, s, t, device="cpu")
        wire = [D.collectives, D.payload_bits]
        rpq = D.dis_rpq_sharded(fr, s, t, qa, device="cpu")
        wire += [D.collectives, D.payload_bits]
        one = QS.exec_reach(fr, s, t, return_matrix=True, device="cpu")
        one_shot.append(dict(
            reach=ans, rpq=rpq, wire=wire,
            d_equal=bool(mat is None or (mat == one.dependency_matrix).all()),
            traffic=[fr.traffic_bits("reach"),
                     fr.traffic_bits("rpq", states=qa.n_states)]))
    answers.append(one_shot)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, answers)
    report[str(k)] = dict(
        backend=sess.backend, d=sess.placement.d, fpd=sess.placement.fpd,
        pairs=pairs, answers=answers[:-1], one_shot=one_shot,
        same_on_every_rank=all(a == answers for a in every),
        n_groups=plan.n_groups, mixed=mixed, groups=groups)
g4 = erdos_renyi(32, 80, n_labels=3, seed=4)
fr4 = fragment_graph(g4, random_partition(g4, 4, 4), 4)
report["auto_k4"] = repro_torch.connect(fr4, device="cpu").backend
try:
    repro_torch.connect(fr4, backend="shard_map", device="cpu")
    report["d_gt_k"] = None
except ValueError as e:
    report["d_gt_k"] = str(e)
if rank == 0:
    print(json.dumps(report))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks_report(tmp_path_factory):
    """One run of N_RANKS gloo ranks, each its own process."""
    here = os.path.dirname(os.path.abspath(__file__))
    store = tmp_path_factory.mktemp("gloo") / "store"
    code = (_RANK.replace("__SRC__", repr(os.path.join(here, "..", "src")))
            .replace("__STORE__", repr(str(store)))
            .replace("__RANKS__", str(N_RANKS))
            .replace("__SCALEOUT__", repr(SCALEOUT)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(N_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("k", ["16", "32"])
def test_scaleout_answers_match_oracles(ranks_report, k):
    """k fragments on 8 ranks (auto backend): shard_map is chosen, the
    balanced placement packs k/8 fragments per rank, every rank returns
    the same answers, and they match the oracles."""
    rep = ranks_report[k]
    assert rep["backend"] == "shard_map", rep
    assert rep["d"] == N_RANKS and rep["fpd"] == int(k) // N_RANKS, rep
    assert rep["same_on_every_rank"], rep
    _, n, m = next(c for c in SCALEOUT if c[0] == int(k))
    g = erdos_renyi(n, m, n_labels=3, seed=int(k))
    qa = j_automaton("(0|1)* 2", int)
    want = ([oracle_reach(g, s, t) for s, t in rep["pairs"]]
            + [oracle_dist(g, s, t) for s, t in rep["pairs"]]
            + [oracle_rpq(g, s, t, qa) for s, t in rep["pairs"]])
    n_pairs = len(rep["pairs"])
    got = [a if i // n_pairs != 1 else d
           for i, (a, d) in enumerate(rep["answers"])]
    assert got == want


@pytest.mark.parametrize("k", ["16", "32"])
def test_scaleout_one_collective_per_group(ranks_report, k):
    """Exactly one all_reduce per fused group (so none inside a fixpoint
    loop), in the mixed run and in each group's own run."""
    rep = ranks_report[k]
    assert rep["mixed"][0] == rep["n_groups"] == 3, rep
    assert [g["collectives"] for g in rep["groups"]] == [1, 1, 1], rep
    assert [g["rounds"] for g in rep["groups"]] == [1, 1, 1], rep


@pytest.mark.parametrize("k", ["16", "32"])
def test_scaleout_wire_unchanged_by_packing(ranks_report, k):
    """Payload bits == traffic_bits, the one-fragment-per-rank formula:
    packing k/8 fragments per rank adds no wire, and the summed QueryStats
    of each group report the same bits."""
    rep = ranks_report[k]
    for g in rep["groups"]:
        assert g["bits"] == g["traffic_bits"] == g["stats_bits"], g
    assert rep["mixed"][1] == sum(g["traffic_bits"] for g in rep["groups"])


@pytest.mark.parametrize("k", ["16", "32"])
def test_scaleout_single_query_functions(ranks_report, k):
    """dis_reach_sharded / dis_rpq_sharded on 8 ranks: the same answer on
    every rank, equal to the oracles; D equal to the one-rank exec_reach's;
    exactly one collective each, of traffic_bits bits."""
    rep = ranks_report[k]
    assert rep["same_on_every_rank"], rep
    _, n, m = next(c for c in SCALEOUT if c[0] == int(k))
    g = erdos_renyi(n, m, n_labels=3, seed=int(k))
    qa = j_automaton("(0|1)* 2", int)
    for (s, t), one in zip(rep["pairs"], rep["one_shot"]):
        assert one["reach"] == oracle_reach(g, s, t)
        assert one["rpq"] == oracle_rpq(g, s, t, qa)
        assert one["d_equal"]
        reach_bits, rpq_bits = one["traffic"]
        if s == t:
            assert one["wire"] == [0, 0, 0, 0]
        else:
            assert one["wire"] == [1, reach_bits, 2, reach_bits + rpq_bits]


def test_scaleout_refuses_more_ranks_than_fragments(ranks_report):
    """8 ranks, 4 fragments: auto stays vmap, explicit shard_map raises."""
    assert ranks_report["auto_k4"] == "vmap"
    assert "cannot use a 8-rank process group" in (ranks_report["d_gt_k"]
                                                   or "no error")
