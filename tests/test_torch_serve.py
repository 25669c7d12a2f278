"""The port's serving stack (``repro_torch.serve``) against the JAX
package's ``repro.serve``.

Deterministic flushes (``start=False``) of the same numpy-seeded request
stream, with the same ``FaultInjector`` seed, through both servers, in
barrier and in MVCC mode: every future's status, answer, ``cache_version``,
``attempts``, lane and error type, the resolution order, the dead letters
and the counters must be equal, exactly (booleans and int32 distances:
tolerance zero).  Then the chaos scenarios of tests/test_chaos.py
(retries and backoff, poison bisection, admission, deadlines, rollback,
the degrade route on a one-rank gloo group), a device fault that must
halt the engine instead of dead-lettering, a threaded MVCC run checked
against the oracles per version, and the counters' atomicity.
"""
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro
import repro.serve as j_serve
import repro_torch
import repro_torch.serve as t_serve
from repro.core import GraphDelta as JDelta
from repro.core import build_query_automaton as j_automaton
from repro.core import fragment_graph as j_fragment
from repro.graph import erdos_renyi as j_er
from repro.graph import random_partition as j_random_partition
from repro_torch import (Dist, GraphDelta, NoCudaDevice, Reach, Rpq,
                         Status)
from repro_torch.core import distributed as tdist
from repro_torch.core.automaton import build_query_automaton
from repro_torch.core.fragments import fragment_graph
from repro_torch.errors import KernelError, is_device_fault
from repro_torch.graph import Graph, erdos_renyi, random_partition
from repro_torch.kernels.bitpack_ops import ops as pops
from repro_torch.kernels.bool_matmul import ops as bops
from repro_torch.kernels.tropical_matmul import ops as tops
from repro_torch.serve import (GREEN, YELLOW, AdmissionPolicy,
                               DeadlineExceeded,
                               FaultInjector, FaultSpec, InjectedFault,
                               QueryServer, QueryTooExpensive, RetryPolicy,
                               UpdateFuture, estimate_cost)

from oracles import oracle_dist, oracle_reach, oracle_rpq
from torch_lock_order import port_lock_order  # noqa: F401

# every test runs on instrumented locks and fails on an order inversion
pytestmark = pytest.mark.usefixtures("port_lock_order")

RESULT_TIMEOUT_S = 60.0
RESERVE = dict(reserve_boundary=10, reserve_edges=24, reserve_stubs=10)

JAX = types.SimpleNamespace(
    Server=j_serve.QueryServer, FaultInjector=j_serve.FaultInjector,
    FaultSpec=j_serve.FaultSpec, RetryPolicy=j_serve.RetryPolicy,
    AdmissionPolicy=j_serve.AdmissionPolicy, GraphDelta=JDelta,
    estimate_cost=j_serve.estimate_cost, automaton=j_automaton, er=j_er,
    random_partition=j_random_partition, fragment=j_fragment, kw={})
PORT = types.SimpleNamespace(
    Server=t_serve.QueryServer, FaultInjector=t_serve.FaultInjector,
    FaultSpec=t_serve.FaultSpec, RetryPolicy=t_serve.RetryPolicy,
    AdmissionPolicy=t_serve.AdmissionPolicy, GraphDelta=GraphDelta,
    estimate_cost=t_serve.estimate_cost, automaton=build_query_automaton,
    er=erdos_renyi, random_partition=random_partition,
    fragment=fragment_graph, kw={"device": "cpu"})


def _case(pkg, n=30, m=70, k=2, seed=1):
    g = pkg.er(n, m, n_labels=3, seed=seed)
    return g, pkg.fragment(g, pkg.random_partition(g, k, 1), k, **RESERVE)


def _server(pkg, fr, chaos=None, **kw):
    kw.setdefault("batch_size", 8)
    kw.setdefault("retry", pkg.RetryPolicy(max_attempts=3,
                                           base_delay_ms=0.0))
    kw.setdefault("start", False)
    kw.setdefault("backend", "vmap")
    return pkg.Server(fr, chaos=chaos, **kw, **pkg.kw)


def _record(fut):
    """What a resolved future shows a client, comparable across packages."""
    base = dict(status=str(fut.status), seq=fut._seq,
                error=None if fut.error is None else type(fut.error).__name__)
    if isinstance(fut, (UpdateFuture, j_serve.UpdateFuture)):
        return dict(base, mode=None if fut.value is None else fut.value.mode)
    return dict(base, value=fut.value, cache_version=fut.cache_version,
                attempts=fut.attempts, degraded=fut.degraded, lane=fut.lane,
                cost=fut.cost)


def _counters(srv):
    return dict(retries=srv.retries, batches=srv.batches_run,
                applied=srv.updates_applied, failed=srv.updates_failed,
                dead=[(f.s, f.t) for f in srv.dead_letters],
                rejected=srv.rejected,
                statuses=srv.telemetry()["statuses"])


# ---------------------------------------------------------------------------
# the fault injector
# ---------------------------------------------------------------------------

def test_fault_injector_replays_the_reference_schedule():
    """Same seed, same rates: the same failures draw for draw, per site,
    however the sites interleave; poison and healing alike."""
    def schedule(pkg, seed):
        inj = pkg.FaultInjector(
            seed=seed, rates={"engine.vmap": 0.3, "upload": 0.5,
                              "delta.repair": pkg.FaultSpec(
                                  rate=0.7, max_failures=3)},
            poison=[(3, 4)])
        out = []
        rng = np.random.default_rng(seed)
        for _ in range(60):
            site = t_serve.SITES[int(rng.integers(4))]
            pairs = np.array([[0, 1], [3, 4]]) if rng.random() < 0.1 else None
            try:
                inj.maybe_fail(site, pairs=pairs)
                out.append((site, None))
            except Exception as exc:        # both packages' InjectedFault
                out.append((site, (str(exc), exc.permanent)))
        return out, inj.draws, inj.failures

    for seed in (0, 7):
        assert schedule(PORT, seed) == schedule(JAX, seed)
    assert t_serve.SITES == j_serve.SITES
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector().maybe_fail("engine.tpu")
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector(rates={"nope": 0.5})
    with pytest.raises(ValueError, match="fault rate"):
        FaultSpec(rate=1.5)


# ---------------------------------------------------------------------------
# deterministic flushes against the reference
# ---------------------------------------------------------------------------

def _mixed_flush(pkg, seed, mvcc):
    """tests/test_chaos.py's seeded stream: 3 segments of 9 mixed reach /
    dist / bounded / rpq requests, each followed by a delta, under a 30 %
    fault rate at engine.vmap and delta.repair."""
    g, fr = _case(pkg, n=24, m=50, seed=5)
    chaos = pkg.FaultInjector(seed=seed, rates={"engine.vmap": 0.3,
                                                "delta.repair": 0.3})
    srv = _server(pkg, fr, chaos=chaos, batch_size=4, mvcc=mvcc,
                  retry=pkg.RetryPolicy(max_attempts=4, base_delay_ms=0.0))
    qa = pkg.automaton("(0|1)*", int)
    rng = np.random.default_rng(100 + seed)
    submitted = []
    for _ in range(3):
        for _ in range(9):
            s, t = int(rng.integers(g.n)), int(rng.integers(g.n))
            kind = int(rng.integers(4))
            if kind == 0:
                submitted.append(srv.submit(s, t))
            elif kind == 1:
                submitted.append(srv.submit(s, t, kind="dist"))
            elif kind == 2:
                submitted.append(srv.submit(s, t, kind="bounded", bound=2))
            else:
                submitted.append(srv.submit(s, t, kind="rpq", automaton=qa))
        edge = [(int(rng.integers(g.n)), int(rng.integers(g.n)))]
        submitted.append(srv.submit_delta(pkg.GraphDelta.insert(edge)))
    served = srv.flush()
    rec = dict(futures=[_record(f) for f in submitted],
               order=[submitted.index(f) for f in served],
               counters=_counters(srv), pending=srv.pending())
    srv.close()
    return g, submitted, rec


@pytest.mark.parametrize("mvcc", [False, True], ids=["barrier", "mvcc"])
@pytest.mark.parametrize("seed", [0, 1])
def test_deterministic_flush_matches_reference(seed, mvcc):
    _, _, want = _mixed_flush(JAX, seed, mvcc)
    g, submitted, got = _mixed_flush(PORT, seed, mvcc)
    assert got == want
    assert got["pending"] == 0 and len(got["order"]) == len(submitted)
    # and each answer is the oracle's on the graph its snapshot saw: in
    # barrier mode the deltas before it, in MVCC mode its cache version
    graphs, cur = {0: g}, g
    for f in submitted:
        if isinstance(f, UpdateFuture) and f.status == Status.APPLIED:
            cur = Graph(cur.n, np.concatenate([cur.src, f.delta.add_src]),
                        np.concatenate([cur.dst, f.delta.add_dst]),
                        cur.labels)
            graphs[max(graphs) + 1] = cur
    qa = j_automaton("(0|1)*", int)
    for f in submitted:
        if isinstance(f, UpdateFuture) or f.status != Status.DONE:
            continue
        gv = graphs[f.cache_version]
        d = oracle_dist(gv, f.s, f.t)
        want = {"reach": lambda: oracle_reach(gv, f.s, f.t),
                "dist": lambda: d,
                "bounded": lambda: d is not None and d <= 2,
                "rpq": lambda: oracle_rpq(gv, f.s, f.t, qa)}[f.kind]()
        assert f.value == want, f


def _poison(pkg):
    g, fr = _case(pkg)
    srv = _server(pkg, fr, chaos=pkg.FaultInjector(seed=0, poison=[(0, 1)]))
    poison = srv.submit(0, 1)
    mates = [srv.submit(2 + i, 10 + i) for i in range(5)]
    srv.flush()
    later = srv.submit(5, 6)
    srv.flush()
    rec = dict(poison=_record(poison), mates=[_record(f) for f in mates],
               later=_record(later), counters=_counters(srv),
               cause=(type(poison.error.cause).__name__,
                      poison.error.cause.permanent))
    srv.close()
    return g, rec


def test_poison_request_quarantined_not_blocking():
    _, want = _poison(JAX)
    g, got = _poison(PORT)
    assert got == want
    assert got["poison"]["status"] == "dead_letter"
    assert got["cause"] == ("InjectedFault", True)
    assert got["counters"]["dead"] == [(0, 1)]
    for rec, i in zip(got["mates"], range(5)):
        assert rec["status"] == "done"
        assert rec["value"] == oracle_reach(g, 2 + i, 10 + i)
    assert got["later"]["value"] == oracle_reach(g, 5, 6)


def _transient(pkg):
    g, fr = _case(pkg)
    chaos = pkg.FaultInjector(
        seed=0, rates={"engine.vmap": pkg.FaultSpec(rate=1.0,
                                                    max_failures=2)})
    sleeps = []
    srv = _server(pkg, fr, chaos=chaos, sleep=sleeps.append,
                  retry=pkg.RetryPolicy(max_attempts=4, base_delay_ms=5.0,
                                        max_delay_ms=8.0))
    reqs = [srv.submit(i, i + 3) for i in range(4)]
    srv.flush()
    rec = dict(reqs=[_record(f) for f in reqs], sleeps=sleeps,
               counters=_counters(srv))
    srv.close()
    return rec


def test_transient_faults_retry_with_backoff_to_success():
    got = _transient(PORT)
    assert got == _transient(JAX)
    assert [r["attempts"] for r in got["reqs"]] == [3] * 4
    assert got["sleeps"] == [0.005, 0.008]
    assert got["counters"]["retries"] == 2 and not got["counters"]["dead"]


def test_permanent_fault_skips_backoff():
    _, fr = _case(PORT)
    sleeps = []
    srv = _server(PORT, fr, chaos=FaultInjector(seed=0, poison=[(0, 1)]),
                  sleep=sleeps.append,
                  retry=RetryPolicy(max_attempts=5, base_delay_ms=50.0))
    srv.submit(0, 1)
    mate = srv.submit(2, 3)
    srv.flush()
    assert sleeps == [] and mate.status == Status.DONE


def test_submit_validates_requests():
    g, fr = _case(PORT)
    srv = _server(PORT, fr, warm=False)
    for s, t in [(0, g.n), (g.n, 0), (-1, 0), (0, -1)]:
        with pytest.raises(ValueError, match="out of range"):
            srv.submit(s, t)
    bad = [dict(kind="walk"), dict(kind="bounded"),
           dict(kind="reach", bound=3), dict(kind="rpq"),
           dict(kind="rpq", regex="0", automaton=build_query_automaton(
               "0", int)),
           dict(kind="dist", regex="0")]
    for kw in bad:
        with pytest.raises(ValueError):
            srv.submit(0, 1, **kw)
    assert srv.pending() == 0
    srv.submit(0, g.n - 1)
    assert srv.pending() == 1
    with pytest.warns(DeprecationWarning, match="drain"):
        assert len(srv.drain()) == 1


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def test_admission_costs_match_reference():
    _, jfr = _case(JAX)
    _, tfr = _case(PORT)
    for kind in ("reach", "dist", "bounded", "rpq"):
        for states, cached in [(1, True), (3, True), (3, False)]:
            assert estimate_cost(tfr, kind, states, cached) == \
                j_serve.estimate_cost(jfr, kind, states, cached)
    assert AdmissionPolicy.for_fragmentation(tfr) == \
        AdmissionPolicy(**vars(j_serve.AdmissionPolicy.for_fragmentation(jfr)))
    with pytest.raises(ValueError, match="red_max"):
        AdmissionPolicy(green_max=10.0, red_max=5.0)


def _lanes(pkg):
    g, fr = _case(pkg)
    reach_cost = pkg.estimate_cost(fr, "reach")
    policy = pkg.AdmissionPolicy(green_max=reach_cost,
                                 red_max=reach_cost * 3)
    srv = _server(pkg, fr, admission=policy, with_dist=True)
    qa = pkg.automaton("(0|1)*", int)
    green = srv.submit(0, 5)
    yellow = srv.submit(0, 5, kind="dist")
    mate = srv.submit(1, 6)
    with pytest.raises(Exception) as ei:                # cold RPQ is RED
        srv.submit(0, 5, kind="rpq", automaton=qa)
    rec = dict(error=type(ei.value).__name__, estimate=ei.value.estimate,
               limit=ei.value.limit, pending=srv.pending())
    order = srv.flush()
    rec.update(futures=[_record(f) for f in (green, yellow, mate)],
               order=[(f.s, f.t, f.kind) for f in order],
               counters=_counters(srv))
    srv.close()
    return g, rec


def test_admission_lanes_and_red_rejection():
    _, want = _lanes(JAX)
    g, got = _lanes(PORT)
    assert got == want
    assert got["error"] == "QueryTooExpensive" and got["pending"] == 3
    assert got["counters"]["rejected"] == 1
    green, yellow, mate = got["futures"]
    assert (green["lane"], yellow["lane"], mate["lane"]) == \
        (GREEN, YELLOW, GREEN)
    # the yellow lane is served after the green one
    assert got["order"][-1] == (0, 5, "dist")
    assert yellow["value"] == oracle_dist(g, 0, 5)


def test_rpq_admission_cost_drops_once_closure_cached():
    _, fr = _case(PORT)
    for mvcc in (False, True):
        srv = _server(PORT, fr, mvcc=mvcc)
        cold = srv.submit(0, 5, kind="rpq", regex="(0|1)* 2")
        srv.flush()
        warm = srv.submit(0, 5, kind="rpq", regex="(0|1)* 2")
        srv.flush()
        assert warm.cost < cold.cost
        srv.close()
        fr.rvset_cache = None
    with pytest.raises(QueryTooExpensive):
        _server(PORT, fr, admission=AdmissionPolicy(red_max=1.0)).submit(
            0, 1)


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def _deadlines(pkg):
    _, fr = _case(pkg)
    now = {"t": 0.0}
    srv = _server(pkg, fr, clock=lambda: now["t"])
    stale = srv.submit(0, 5, deadline_ms=50.0)
    fresh = srv.submit(1, 6)
    now["t"] = 1.0
    srv.flush()
    far = [srv.submit(0, 5, deadline_ms=60_000.0)] + \
        [srv.submit(i, i + 2) for i in range(5)]
    srv.flush()
    rec = dict(stale=_record(stale), fresh=_record(fresh),
               far=[_record(f) for f in far], counters=_counters(srv))
    srv.close()
    return rec


def test_deadlines_match_reference():
    got = _deadlines(PORT)
    assert got == _deadlines(JAX)
    assert got["stale"]["status"] == "deadline"
    assert got["stale"]["error"] == "DeadlineExceeded"
    assert got["stale"]["value"] is None
    assert got["fresh"]["status"] == "done"
    assert got["counters"]["batches"] == 2   # the far deadline split nothing


def test_near_deadline_ships_partial_bucket():
    g, fr = _case(PORT)
    srv = _server(PORT, fr, batch_size=8, start=True,
                  batch_wait_ms=60_000.0, ship_margin_ms=1000.0)
    try:
        relaxed = srv.submit(1, 3)
        urgent = srv.submit(0, 5, deadline_ms=500.0)
        assert urgent.result(timeout=30.0) == oracle_reach(g, 0, 5)
        assert relaxed.result(timeout=30.0) == oracle_reach(g, 1, 3)
        assert srv.batches_run == 1
    finally:
        srv.close()


def test_expired_request_raises_its_typed_error():
    _, fr = _case(PORT)
    now = {"t": 0.0}
    srv = _server(PORT, fr, clock=lambda: now["t"])
    stale = srv.submit(0, 5, deadline_ms=1.0)
    now["t"] = 1.0
    srv.flush()
    with pytest.raises(DeadlineExceeded):
        stale.result(timeout=1.0)
    pending = srv.submit(1, 2)
    with pytest.raises(TimeoutError, match="flush"):
        pending.result(timeout=0.01)
    srv.close()


# ---------------------------------------------------------------------------
# failed deltas: rollback (barrier) on both packages
# ---------------------------------------------------------------------------

def _rollback(pkg, with_dist):
    g, fr = _case(pkg, seed=2)
    chaos = pkg.FaultInjector(
        seed=0, rates={"delta.repair": pkg.FaultSpec(rate=1.0,
                                                     max_failures=1)})
    srv = _server(pkg, fr, chaos=chaos, with_dist=with_dist)
    kind = "dist" if with_dist else "reach"
    srv.serve_pairs([(0, 1)], kind=kind)
    v0, av0 = srv.session.cache_version, fr.arrays_version
    u, v = next((a, b) for a in range(12) for b in range(12)
                if a != b and not oracle_reach(g, a, b))
    upd = srv.submit_delta(pkg.GraphDelta.insert([(u, v)]))
    post = srv.submit(u, v, kind=kind)
    srv.flush()
    rec = dict(upd=_record(upd), post=_record(post),
               versions=(srv.session.cache_version - v0,
                         fr.arrays_version - av0),
               rollbacks=srv.session.stats.rollbacks,
               cause=type(upd.error.cause).__name__,
               rolled_back=upd.error.rolled_back)
    upd2 = srv.submit_delta(pkg.GraphDelta.insert([(u, v)]))
    post2 = srv.submit(u, v, kind=kind)
    srv.flush()
    rec.update(upd2=_record(upd2), post2=_record(post2),
               counters=_counters(srv))
    srv.close()
    return rec


@pytest.mark.parametrize("with_dist", [False, True])
def test_delta_failure_rolls_back_to_pre_delta_snapshot(with_dist):
    got = _rollback(PORT, with_dist)
    assert got == _rollback(JAX, with_dist)
    assert got["upd"]["status"] == "failed" and got["rolled_back"]
    assert got["cause"] == "InjectedFault" and got["rollbacks"] == 1
    assert got["versions"] == (0, 0)
    assert got["post"]["value"] in (False, None)
    assert got["upd2"]["status"] == "applied"
    assert got["post2"]["value"] not in (False, None)


# ---------------------------------------------------------------------------
# the degrade route, on a one-rank gloo group
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


@pytest.mark.parametrize("site", ["engine.shard_map", "upload"])
def test_sharded_failure_degrades_to_cached_path_exact(gloo_rank, site):
    """A failing sharded group re-runs on the cached one-device path of
    the same device: exact answers flagged ``degraded``, one degraded group
    per (kind, automaton) group, and the reference package's answers."""
    jg, jfr = _case(JAX, seed=3)
    g, fr = _case(PORT, seed=3)
    jqa = j_automaton("(0|1)*", int)
    qa = build_query_automaton("(0|1)*", int)
    jsess = repro.connect(jfr, backend="vmap")
    want = jsess.run([repro.core.Reach(0, 5), repro.core.Dist(0, 5),
                      repro.core.Rpq(0, 5, automaton=jqa)])
    chaos = FaultInjector(seed=0, rates={site: 1.0})
    sess = repro_torch.connect(fr, backend="shard_map", device="cpu",
                               chaos=chaos)
    queries = [Reach(0, 5), Dist(0, 5), Rpq(0, 5, automaton=qa)]
    tdist.collectives = 0
    res = sess.run(queries)
    assert tdist.collectives == 0        # both sites fire before the wire
    assert all(r.degraded for r in res)
    assert sess.stats.degraded_groups == 3
    assert [(r.answer, r.distance) for r in res] == \
        [(w.answer, w.distance) for w in want]
    assert res[0].answer == oracle_reach(g, 0, 5)
    assert res[1].distance == oracle_dist(g, 0, 5)
    assert res[2].answer == oracle_rpq(g, 0, 5, jqa)
    assert fr.rvset_cache is not None     # the fallback built the cache
    assert chaos.draws["engine.vmap"] == 3
    # a healthy sharded session: no flag, one collective per group
    healthy = repro_torch.connect(fr, backend="shard_map", device="cpu")
    tdist.collectives = 0
    again = healthy.run(queries)
    assert tdist.collectives == 3 and not any(r.degraded for r in again)
    assert [r.answer for r in again] == [r.answer for r in res]


def test_degraded_server_requests_done_and_flagged(gloo_rank):
    g, fr = _case(PORT, seed=3)
    srv = _server(PORT, fr, backend="shard_map",
                  chaos=FaultInjector(seed=0, rates={"upload": 1.0}))
    r = srv.submit(0, 5)
    srv.flush()
    assert r.status == Status.DONE and r.degraded
    assert r.value == oracle_reach(g, 0, 5)
    assert srv.session.stats.degraded_groups == 1 and srv.retries == 0
    srv.close()


# ---------------------------------------------------------------------------
# device faults halt the engine
# ---------------------------------------------------------------------------

def test_device_fault_classification():
    assert is_device_fault(KernelError("min_plus_matmul launch failed"))
    assert is_device_fault(RuntimeError("CUDA error: an illegal memory "
                                        "access was encountered"))
    assert not is_device_fault(RuntimeError("something else"))
    assert not is_device_fault(InjectedFault("engine.vmap"))
    assert not is_device_fault(ValueError("CUDA error"))


@pytest.mark.parametrize("start", [False, True], ids=["inline", "thread"])
def test_device_fault_halts_instead_of_dead_lettering(start, monkeypatch):
    """A kernel failure is retried never and dead-lettered never: the
    engine halts, every waiting future resolves FAILED with it, and flush
    and close raise it."""
    _, fr = _case(PORT)
    srv = _server(PORT, fr, start=start, batch_wait_ms=1.0)
    boom = KernelError("or_and_matmul launch failed: CUDA error 700")

    def broken(*args, **kwargs):
        raise boom

    monkeypatch.setattr(srv.session, "run", broken)
    futs = [srv.submit(i, i + 1) for i in range(3)]
    with pytest.raises(KernelError):
        srv.flush()
    for f in futs:
        assert f.status == Status.FAILED and f.error is boom
        with pytest.raises(KernelError):
            f.result(timeout=1.0)
    assert srv.retries == 0 and srv.dead_letters == []
    with pytest.raises(RuntimeError, match="halted"):
        srv.submit(0, 1)
    with pytest.raises(KernelError):
        srv.close()
    assert not srv.engine.running


def test_device_fault_in_a_repair_halts_too(monkeypatch):
    _, fr = _case(PORT)
    srv = _server(PORT, fr, mvcc=True)
    boom = RuntimeError("CUDA error: unspecified launch failure")

    def broken(work_fr, delta):
        raise boom

    monkeypatch.setattr(srv.session, "repair_on", broken)
    upd = srv.submit_delta(GraphDelta.insert([(0, 1)]))
    q = srv.submit(0, 1)
    with pytest.raises(Exception) as ei:
        srv.flush()
    assert ei.value.__cause__ is boom or ei.value is boom
    assert upd.status == Status.FAILED and q.status == Status.DONE
    assert srv.updates_failed == 0


# ---------------------------------------------------------------------------
# device selection
# ---------------------------------------------------------------------------

def test_server_defaults_to_cuda_and_never_falls_back(monkeypatch):
    _, fr = _case(PORT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        QueryServer(fr, start=False)
    srv = QueryServer(fr, start=False, device="cpu")
    assert srv.session.device.type == "cpu"
    shared = QueryServer(fr, session=srv.session, start=False)
    assert shared.session is srv.session
    with pytest.raises(ValueError, match="session runs on"):
        QueryServer(fr, session=srv.session, start=False, device="meta")
    assert repro_torch.QueryServer is QueryServer


# ---------------------------------------------------------------------------
# a threaded MVCC run, checked per version
# ---------------------------------------------------------------------------

def test_threaded_mvcc_answers_match_their_version():
    """A client thread submits mixed requests while the main thread submits
    deltas; every answer equals the oracle on the graph of the version its
    ``cache_version`` names."""
    g, fr = _case(PORT, 28, 50, 3, seed=31)
    rng = np.random.default_rng(8)
    graphs = {0: g}
    srv = QueryServer(fr, batch_size=8, batch_wait_ms=1.0, mvcc=True,
                      versions=2, with_dist=True, device="cpu")
    futs = []

    def client():
        crng = np.random.default_rng(9)
        for i in range(48):
            s, t = (int(x) for x in crng.integers(0, g.n, 2))
            kind = ("reach", "dist", "bounded")[i % 3]
            futs.append(srv.submit(s, t, kind=kind,
                                   bound=3 if kind == "bounded" else None))
            time.sleep(0.001)

    th = threading.Thread(target=client)
    try:
        th.start()
        for _ in range(3):
            delta = GraphDelta.insert(
                [tuple(int(x) for x in rng.integers(0, g.n, 2))])
            srv.submit_delta(delta).result(timeout=RESULT_TIMEOUT_S)
            head = srv.store.head()
            graphs[head.cache_version] = head.fr.g
        th.join(timeout=RESULT_TIMEOUT_S)
        assert not th.is_alive()
        srv.flush()
    finally:
        srv.close()
    assert srv.updates_applied == 3 and srv.retries == 0
    assert len(futs) == 48 and {f.status for f in futs} == {Status.DONE}
    for f in futs:
        gv = graphs[f.cache_version]
        d = oracle_dist(gv, f.s, f.t)
        if f.kind == "reach":
            assert f.value == oracle_reach(gv, f.s, f.t), f
        elif f.kind == "dist":
            assert f.value == d, f
        else:
            assert f.value == (d is not None and d <= 3), f
    assert srv.telemetry()["mvcc"]["versions_committed"] == 3


# ---------------------------------------------------------------------------
# the counters chip_smoke.py reads are atomic across threads
# ---------------------------------------------------------------------------

def test_counters_lose_no_update_across_threads():
    old = sys.getswitchinterval()
    saved = (bops.launches, pops.launches, tops.launches, tops.copies,
             tdist.collectives, tdist.payload_bits)
    bops.launches = pops.launches = tops.launches = tops.copies = 0
    tdist.collectives = tdist.payload_bits = 0
    n_threads, per = 16, 2000

    def hammer():
        for _ in range(per):
            bops._count_launch()
            pops._count_launch()
            tops._count_launch()
            tops._count_copy()
            tdist._count_collective(3)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    try:
        sys.setswitchinterval(1e-6)
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=RESULT_TIMEOUT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    total = n_threads * per
    counts = (bops.launches, pops.launches, tops.launches, tops.copies,
              tdist.collectives, tdist.payload_bits)
    (bops.launches, pops.launches, tops.launches, tops.copies,
     tdist.collectives, tdist.payload_bits) = saved
    assert counts == (total, total, total, total, total, 3 * total)
