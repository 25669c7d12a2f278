"""The port's MVCC snapshot store (``repro_torch.core.versions``) against
the JAX package's, scenario for scenario.

Every scenario of tests/test_mvcc.py runs on both packages, from the same
numpy-seeded graph, and records what it observes (answers, cache
versions, version ids, gauges, update modes); the two records must be
equal, exactly.  Then what only the port has: the clone carries the
port's extra cache fields and shares every tensor; a base version's
closures stay bit-equal while a clone is repaired in each mode (repair,
repair with new boundary nodes, recompute, rebuild); the clone's first
sharded batch uploads its own arrays; and a threaded MVCC server never
makes a read wait for a repair (the threaded run checked against the
oracles per version is in tests/test_torch_serve.py).
"""
import gc
import threading
import types
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro
import repro.core.versions as j_versions
import repro.serve as j_serve
import repro_torch
import repro_torch.core.versions as t_versions
import repro_torch.serve as t_serve
from repro.core import GraphDelta as JDelta
from repro.core import Reach as JReach
from repro.core import fragment_graph as j_fragment
from repro.errors import DeltaApplyFailed as JDeltaApplyFailed
from repro.graph import erdos_renyi as j_er
from repro.graph import random_partition as j_random_partition
from repro_torch import DeltaApplyFailed, GraphDelta, Reach
from repro_torch.core import distributed as tdist
from repro_torch.core.fragments import fragment_graph
from repro_torch.core.session import default_session
from repro_torch.core.versions import VersionedCacheStore, cow_clone
from repro_torch.graph import erdos_renyi, random_partition
from repro_torch.serve import QueryServer

from oracles import oracle_reach
from torch_lock_order import port_lock_order  # noqa: F401

# every test runs on instrumented locks and fails on an order inversion
pytestmark = pytest.mark.usefixtures("port_lock_order")

RESULT_TIMEOUT_S = 60.0
RESERVE = dict(reserve_boundary=12, reserve_edges=24, reserve_stubs=12)

JAX = types.SimpleNamespace(
    connect=lambda fr, **kw: repro.connect(fr, **kw),
    Reach=JReach, GraphDelta=JDelta, DeltaApplyFailed=JDeltaApplyFailed,
    Store=j_versions.VersionedCacheStore, cow_clone=j_versions.cow_clone,
    Server=j_serve.QueryServer, FaultInjector=j_serve.FaultInjector,
    FaultSpec=j_serve.FaultSpec, RetryPolicy=j_serve.RetryPolicy,
    er=j_er, random_partition=j_random_partition, fragment=j_fragment,
    server_kw={})
PORT = types.SimpleNamespace(
    connect=lambda fr, **kw: repro_torch.connect(fr, device="cpu", **kw),
    Reach=Reach, GraphDelta=GraphDelta, DeltaApplyFailed=DeltaApplyFailed,
    Store=t_versions.VersionedCacheStore, cow_clone=t_versions.cow_clone,
    Server=t_serve.QueryServer, FaultInjector=t_serve.FaultInjector,
    FaultSpec=t_serve.FaultSpec, RetryPolicy=t_serve.RetryPolicy,
    er=erdos_renyi, random_partition=random_partition,
    fragment=fragment_graph, server_kw={"device": "cpu"})


def _case(pkg, n=24, m=40, k=3, seed=11, **kw):
    kw = dict(RESERVE, **kw)
    g = pkg.er(n, m, n_labels=3, seed=seed)
    return g, pkg.fragment(g, pkg.random_partition(g, k, seed), k, **kw)


def _unreachable_pair(g, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(500):
        s, t = int(rng.integers(g.n)), int(rng.integers(g.n))
        if s != t and not oracle_reach(g, s, t):
            return s, t
    raise AssertionError("graph is (almost) strongly connected")


def _pin(store, ver):
    """Pin an arbitrary (possibly non-head) version, like a reader that
    acquired it before newer versions published."""
    with store._lock:
        ver.pins += 1
    return ver


def _both(scenario):
    """Run ``scenario(pkg)`` on both packages; the records must agree."""
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# store semantics, on both packages
# ---------------------------------------------------------------------------

def _commit_publishes(pkg):
    g, fr = _case(pkg)
    s, t = _unreachable_pair(g)
    sess = pkg.connect(fr).warm()
    store = pkg.Store(sess, capacity=4)
    old = store.acquire_head()
    g0, av0, cv0 = fr.g, fr.arrays_version, fr.rvset_cache.version
    ver, stats = store.commit_delta(pkg.GraphDelta.insert([(s, t)]))
    r_old = sess.run([pkg.Reach(s, t)], version=old)[0]
    r_new = sess.run([pkg.Reach(s, t)], version=ver)[0]
    store.release(old)
    return dict(mode=stats.mode, head=store.head() is ver, vid=ver.vid,
                committed=store.committed,
                base_untouched=(fr.g is g0 and fr.arrays_version == av0
                                and fr.rvset_cache.version == cv0),
                new_graph=ver.fr.g is not g0, cv=(cv0, ver.cache_version),
                old=(r_old.answer, r_old.cache_version),
                new=(r_new.answer, r_new.cache_version),
                gauges=store.gauges())


def test_commit_publishes_new_head_base_untouched():
    rec = _both(_commit_publishes)
    assert rec["mode"] in ("repair", "recompute") and rec["head"]
    assert rec["base_untouched"] and rec["new_graph"]
    cv0 = rec["cv"][0]
    assert rec["old"] == (False, cv0) and rec["new"] == (True, cv0 + 1)


def _empty_delta(pkg):
    _, fr = _case(pkg, 16, 30, 2, seed=3)
    store = pkg.Store(pkg.connect(fr).warm())
    ver, stats = store.commit_delta(pkg.GraphDelta())
    return dict(mode=stats.mode, head=ver is store.head(), vid=ver.vid,
                committed=store.committed)


def test_empty_delta_is_noop_version():
    assert _both(_empty_delta) == dict(mode="noop", head=True, vid=0,
                                       committed=0)


def _drop_non_head(pkg):
    g, fr = _case(pkg, seed=5)
    sess = pkg.connect(fr).warm()
    store = pkg.Store(sess)
    rng = np.random.default_rng(1)
    for _ in range(2):
        store.commit_delta(pkg.GraphDelta.insert(
            [(int(rng.integers(g.n)), int(rng.integers(g.n)))]))
    v0, v1, v2 = store.live()
    _pin(store, v1)
    store.drop(v1.vid)
    rec = dict(head_after_drop=store.head().vid, retired=v1.retired,
               dropped=store.dropped, kept=v1.vid in store._versions)
    r = sess.run([pkg.Reach(0, 1)], version=v1)[0]
    rec["pinned_stamp"] = (r.cache_version, v1.cache_version)
    store.release(v1)
    rec["reclaimed"] = v1.vid not in store._versions
    store.drop(v2.vid)
    rec["fallback_head"] = store.head().vid
    with pytest.raises(ValueError, match="last live"):
        store.drop(v0.vid)
    with pytest.raises(KeyError):
        store.drop(v1.vid)
    return rec


def test_drop_non_head_keeps_pinned_reader_snapshot():
    rec = _both(_drop_non_head)
    assert rec["head_after_drop"] == 2 and rec["retired"] and rec["kept"]
    assert rec["pinned_stamp"][0] == rec["pinned_stamp"][1]
    assert rec["reclaimed"] and rec["fallback_head"] == 0


def _capacity(pkg):
    g, fr = _case(pkg, seed=7)
    store = pkg.Store(pkg.connect(fr).warm(), capacity=2)
    pinned = store.acquire_head()
    rng = np.random.default_rng(2)
    for _ in range(3):
        store.commit_delta(pkg.GraphDelta.insert(
            [(int(rng.integers(g.n)), int(rng.integers(g.n)))]))
    live = [v.vid for v in store.live()]
    n_versions = len(store._versions)
    store.release(pinned)
    return dict(live=live, after=[v.vid for v in store.live()],
                evicted=store.evicted, n_versions=n_versions,
                gauges=store.gauges())


def test_capacity_evicts_only_unpinned_nonhead():
    rec = _both(_capacity)
    assert rec["live"] == rec["after"] == [0, 3]
    assert rec["evicted"] == 2 and rec["n_versions"] == 2
    assert rec["gauges"]["pinned_readers"] == {}


def _failed_repair(pkg):
    g, fr = _case(pkg, seed=9)
    s, t = _unreachable_pair(g)
    chaos = pkg.FaultInjector(
        seed=0, rates={"delta.repair": pkg.FaultSpec(rate=1.0,
                                                     max_failures=1)})
    sess = pkg.connect(fr, chaos=chaos).warm()
    store = pkg.Store(sess)
    cv0 = fr.rvset_cache.version
    with pytest.raises(pkg.DeltaApplyFailed):
        store.commit_delta(pkg.GraphDelta.insert([(s, t)]))
    rec = dict(head=store.head().vid, dropped=store.dropped,
               committed=store.committed, rollbacks=sess.stats.rollbacks,
               untouched=fr.g is g and fr.rvset_cache.version == cv0,
               pre=sess.run([pkg.Reach(s, t)], version=store.head())[0]
               .answer)
    ver, stats = store.commit_delta(pkg.GraphDelta.insert([(s, t)]))
    rec.update(mode=stats.mode, post=sess.run([pkg.Reach(s, t)],
                                              version=ver)[0].answer)
    return rec


def test_failed_repair_drops_clone_head_keeps_serving():
    rec = _both(_failed_repair)
    assert (rec["head"], rec["dropped"], rec["committed"],
            rec["rollbacks"]) == (0, 1, 0, 1)
    assert rec["untouched"] and rec["pre"] is False and rec["post"] is True


def test_reclaimed_versions_release_their_state():
    """A version the store evicts or drops is freed at once, without the
    cycle collector: once no reader pins it, its fragmentation, its cache
    and the tensors only it held are gone, so the allocator can reuse
    them.  The session's own version keeps its cache."""
    g, fr = _case(PORT, seed=7)
    store = VersionedCacheStore(PORT.connect(fr).warm(with_dist=True),
                                capacity=2)
    rng = np.random.default_rng(2)
    refs = []
    gc.collect()
    gc.disable()
    try:
        for _ in range(3):
            ver, _ = store.commit_delta(GraphDelta.insert(
                [(int(rng.integers(g.n)), int(rng.integers(g.n)))]))
            refs.append((weakref.ref(ver.fr),
                         weakref.ref(ver.fr.rvset_cache),
                         weakref.ref(ver.fr.rvset_cache.dist_closure)))
            del ver
        # v0 and v1 evicted; v0 is the session's own fr and keeps its cache
        assert [v.vid for v in store.live()] == [2, 3]
        assert store.evicted == 2 and fr.rvset_cache is not None
        assert all(r() is None for r in refs[0])
        assert all(r() is not None for r in refs[1] + refs[2])
        store.drop(2)
        assert all(r() is None for r in refs[1])
        assert store.head().vid == 3
        # a pinned version survives its drop until its reader releases it
        store.commit_delta(GraphDelta.insert([(0, 1)]))
        pinned = store.acquire_head()
        store.drop(pinned.vid)
        assert pinned.vid in store._versions
        assert pinned.fr.rvset_cache is not None
        store.release(pinned)
        assert pinned.vid not in store._versions
        assert pinned.fr.rvset_cache is None
    finally:
        gc.enable()


def test_store_capacity_validation():
    _, fr = _case(PORT, 12, 20, 2, seed=1)
    with pytest.raises(ValueError, match="capacity"):
        VersionedCacheStore(PORT.connect(fr), capacity=0)


# ---------------------------------------------------------------------------
# the copy-on-write clone
# ---------------------------------------------------------------------------

def test_cow_clone_shares_untouched_copies_touched():
    g, fr = _case(PORT, seed=13)
    PORT.connect(fr).warm(with_dist=True)
    default_session(fr, device="cpu")        # memoized on the base
    base = fr.rvset_cache
    u = int(np.nonzero(fr.part == 0)[0][0])
    w = int(np.nonzero(fr.part == 1)[0][0])
    clone = cow_clone(fr, GraphDelta.insert([(u, w)]))      # cross edge
    for name in ("esrc", "src_local", "src_row", "gids", "tgt_local"):
        assert clone.arrays[name] is not fr.arrays[name], name
    assert clone.g is fr.g and clone.part is fr.part
    assert clone.b_index is not fr.b_index
    assert "_sharded_device_inputs" not in clone.__dict__
    assert any(k.startswith("_default_session") for k in fr.__dict__)
    assert not any(k.startswith("_default_session") for k in clone.__dict__)
    c = clone.rvset_cache
    assert c is not base and c.fr is clone and base.fr is fr
    # every field carried, every tensor shared: nothing is copied
    assert c.device == base.device and c.version == base.version
    for name in ("bl_frontier", "closure", "closure_t", "bl_dist",
                 "dist_closure"):
        assert getattr(c, name) is getattr(base, name), name
    assert c.arrays is not base.arrays and c.arrays == base.arrays
    assert c.rpq_closures is not base.rpq_closures
    assert c.rpq_closures_t is not base.rpq_closures_t
    # an intra-fragment delta copies only the edge arrays
    u2 = int(np.nonzero(fr.part == 0)[0][1])
    intra = cow_clone(fr, GraphDelta.insert([(u, u2)]))
    assert intra.arrays["src_local"] is fr.arrays["src_local"]
    assert intra.arrays["esrc"] is not fr.arrays["esrc"]
    # the JAX package copies the same arrays for the same deltas
    jg, jfr = _case(JAX, seed=13)
    for delta in ([(u, w)], [(u, u2)]):
        assert t_versions.touched_array_names(fr, GraphDelta.insert(delta)) \
            == j_versions.touched_array_names(jfr, JDelta.insert(delta))


def _mode_deltas(fr, rng):
    """(mode, delta) for each repair mode on a warm cache with reserves."""
    part = fr.part
    f = int(np.argmax(np.bincount(part, minlength=fr.k)))
    mine = np.nonzero(part == f)[0]
    fresh = np.nonzero((fr.b_index < 0) & (part != f))[0]
    e = rng.choice(fr.g.m, size=2, replace=False)
    return [
        ("repair", GraphDelta.insert([(int(rng.choice(mine)),
                                       int(rng.choice(mine)))
                                      for _ in range(3)])),
        ("repair", GraphDelta.insert([(int(mine[0]), int(fresh[0]))])),
        ("recompute", GraphDelta.delete([(int(fr.g.src[i]),
                                          int(fr.g.dst[i])) for i in e])),
        ("rebuild", GraphDelta.insert([(int(rng.choice(mine)),
                                        int(rng.choice(mine)))
                                       for _ in range(fr.e_max + 1)])),
    ]


@pytest.mark.parametrize("which", ["repair", "repair_new_boundary",
                                   "recompute", "rebuild"])
def test_base_closures_bit_equal_while_a_clone_repairs(which):
    """Every tensor of the base version's cache, and every host array of
    its fragmentation, holds its contents while a clone takes the delta:
    no repair writes into a tensor an older version holds."""
    g, fr = _case(PORT, 32, 64, 4, seed=21)
    sess = PORT.connect(fr).warm(with_dist=True)
    rng = np.random.default_rng(4)
    sess.run([_rpq(0, 1)])                   # an RPQ closure in the base
    deltas = dict(zip(["repair", "repair_new_boundary", "recompute",
                       "rebuild"], (d for _, d in _mode_deltas(fr, rng))))
    want_mode = {"repair_new_boundary": "repair"}.get(which, which)
    base = fr.rvset_cache
    held = {n: (getattr(base, n), getattr(base, n).clone())
            for n in ("bl_frontier", "closure", "closure_t", "bl_dist",
                      "dist_closure")}
    held.update({f"rpq{i}": (t, t.clone()) for i, t in
                 enumerate(list(base.rpq_closures.values())
                           + list(base.rpq_closures_t.values()))})
    arrays = {k: (v, v.clone()) for k, v in base.arrays.items()}
    host = {k: v.copy() for k, v in fr.arrays.items()}
    store = VersionedCacheStore(sess)
    pinned = store.acquire_head()
    ver, stats = store.commit_delta(deltas[which])
    assert stats.mode == want_mode, stats
    if which == "repair_new_boundary":
        assert stats.new_boundary == 1
    assert fr.rvset_cache is base and base.version == 0
    for name, (obj, copy) in {**held, **arrays}.items():
        assert torch.equal(obj, copy), name
    assert all(getattr(base, n) is obj for n, (obj, _) in held.items()
               if not n.startswith("rpq"))
    for name, arr in host.items():
        np.testing.assert_array_equal(fr.arrays[name], arr, err_msg=name)
    # the pinned base still answers the pre-delta graph, the head the new
    pairs = [tuple(int(x) for x in rng.integers(0, g.n, 2))
             for _ in range(8)]
    old = sess.run([Reach(s, t) for s, t in pairs], version=pinned)
    new = sess.run([Reach(s, t) for s, t in pairs], version=ver)
    for (s, t), r_old, r_new in zip(pairs, old, new):
        assert r_old.answer == oracle_reach(g, s, t)
        assert r_new.answer == oracle_reach(ver.fr.g, s, t)
    store.release(pinned)


def _rpq(s, t):
    return repro_torch.Rpq(s, t, regex="(0|1)* 2")


# ---------------------------------------------------------------------------
# the engine in MVCC mode
# ---------------------------------------------------------------------------

def _deferred_pre_delta(pkg):
    g, fr = _case(pkg, 24, 30, 3, seed=11)
    s, t = _unreachable_pair(g)
    srv = pkg.Server(fr, batch_size=4, start=False, mvcc=True,
                     **pkg.server_kw)
    try:
        pre = srv.submit(s, t)
        upd = srv.submit_delta(pkg.GraphDelta.insert([(s, t)]))
        mid = srv.submit(s, t)
        srv.flush()
        post = srv.submit(s, t)
        srv.flush()
        return dict(values=[pre.value, mid.value, post.value],
                    versions=[pre.cache_version, mid.cache_version,
                              post.cache_version],
                    update=(str(upd.status), upd.value.mode),
                    applied=srv.updates_applied,
                    mvcc=srv.telemetry()["mvcc"])
    finally:
        srv.close()


def test_deferred_mvcc_queued_queries_answer_pre_delta_head():
    rec = _both(_deferred_pre_delta)
    assert rec["values"] == [False, False, True]
    v = rec["versions"][0]
    assert rec["versions"] == [v, v, v + 1]
    assert rec["update"][0] == "applied" and rec["applied"] == 1


def _failed_delta_serving_continues(pkg):
    g, fr = _case(pkg, seed=23)
    s, t = _unreachable_pair(g)
    chaos = pkg.FaultInjector(seed=0, rates={"delta.repair": 1.0})
    srv = pkg.Server(fr, batch_size=4, start=False, mvcc=True, chaos=chaos,
                     retry=pkg.RetryPolicy(max_attempts=2, base_delay_ms=0.0),
                     **pkg.server_kw)
    try:
        upd = srv.submit_delta(pkg.GraphDelta.insert([(s, t)]))
        q = srv.submit(s, t)
        srv.flush()
        with pytest.raises(pkg.DeltaApplyFailed):
            upd.result(timeout=RESULT_TIMEOUT_S)
        return dict(update=str(upd.status), value=q.value,
                    failed=srv.updates_failed,
                    dropped=srv.telemetry()["mvcc"]["versions_dropped"])
    finally:
        srv.close()


def test_failed_delta_resolves_failed_and_serving_continues():
    assert _both(_failed_delta_serving_continues) == dict(
        update="failed", value=False, failed=1, dropped=1)


def _dead_letter_cap(pkg):
    _, fr = _case(pkg, 20, 50, 2, seed=7)
    poisons = [(0, 1), (2, 3), (4, 5)]
    srv = pkg.Server(fr, batch_size=4, start=False,
                     chaos=pkg.FaultInjector(seed=0, poison=poisons),
                     dead_letter_cap=2,
                     retry=pkg.RetryPolicy(max_attempts=2, base_delay_ms=0.0),
                     **pkg.server_kw)
    try:
        futs = [srv.submit(s, t) for s, t in poisons]
        srv.flush()
        return dict(statuses=[str(f.status) for f in futs],
                    kept=[(f.s, f.t) for f in srv.dead_letters],
                    evicted=srv.dead_letters_evicted,
                    attempts=[f.attempts for f in futs])
    finally:
        srv.close()


def test_dead_letter_cap_evicts_oldest_and_counts():
    rec = _both(_dead_letter_cap)
    assert rec["statuses"] == ["dead_letter"] * 3
    assert rec["kept"] == [(2, 3), (4, 5)] and rec["evicted"] == 1


def test_telemetry_has_no_mvcc_block_outside_mvcc_mode():
    _, fr = _case(PORT, 12, 20, 2, seed=1)
    srv = QueryServer(fr, batch_size=4, warm=False, start=False,
                      device="cpu")
    try:
        assert "mvcc" not in srv.telemetry()
    finally:
        srv.close()


def test_live_mvcc_commit_point_and_monotonic_reads():
    g, fr = _case(PORT, 24, 30, 3, seed=17)
    s, t = _unreachable_pair(g)
    with QueryServer(fr, batch_size=4, batch_wait_ms=1.0, mvcc=True,
                     device="cpu") as srv:
        pre = srv.submit(s, t)
        assert pre.result(timeout=RESULT_TIMEOUT_S) is False
        upd = srv.submit_delta(GraphDelta.insert([(s, t)]))
        upd.result(timeout=RESULT_TIMEOUT_S)    # the commit point
        post = srv.submit(s, t)
        assert post.result(timeout=RESULT_TIMEOUT_S) is True
        assert post.cache_version > pre.cache_version
        snap = srv.telemetry()
        assert snap["mvcc"]["versions_committed"] == 1
        assert snap["mvcc"]["head_vid"] == 1
        assert snap["mvcc"]["repair_queue_depth"] == 0


def test_queries_never_block_on_inflight_repair():
    g, fr = _case(PORT, 30, 60, 3, seed=19)
    srv = QueryServer(fr, batch_size=4, batch_wait_ms=1.0, mvcc=True,
                      device="cpu")
    real_repair = srv.session.repair_on
    try:
        entered, release = threading.Event(), threading.Event()

        def slow_repair(work_fr, delta):
            entered.set()
            release.wait(RESULT_TIMEOUT_S)     # held until the reads are in
            return real_repair(work_fr, delta)

        srv.session.repair_on = slow_repair
        upd = srv.submit_delta(GraphDelta.insert([(0, 1)]))
        assert entered.wait(timeout=RESULT_TIMEOUT_S)
        reads = [srv.submit(i, (i + 5) % g.n) for i in range(4)]
        for r in reads:
            r.result(timeout=RESULT_TIMEOUT_S)
        assert not upd.done()           # the repair is still in flight
        for r in reads:
            assert r.value == oracle_reach(g, r.s, r.t)
            assert r.cache_version == 0
        release.set()
        upd.result(timeout=RESULT_TIMEOUT_S)
        assert srv.updates_applied == 1
    finally:
        release.set()
        srv.session.repair_on = real_repair
        srv.close()


# ---------------------------------------------------------------------------
# the sharded backend under MVCC (one-rank gloo group)
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


def test_sharded_clone_uploads_its_own_arrays(gloo_rank):
    """The clone does not carry the base's sharded device uploads: its
    first sharded batch uploads its own arrays, keyed on its
    ``arrays_version``, and answers the new graph while the pinned base
    keeps answering the old one, one collective per group."""
    g, fr = _case(PORT, 30, 60, 4, seed=3)
    s, t = _unreachable_pair(g)
    sess = repro_torch.connect(fr, backend="shard_map", device="cpu")
    store = VersionedCacheStore(sess)
    assert sess.run([Reach(s, t)])[0].answer is False
    base_memo = dict(fr.__dict__["_sharded_device_inputs"])
    old = store.acquire_head()
    ver, stats = store.commit_delta(GraphDelta.insert([(s, t)]))
    assert stats.mode == "structural"          # no cache on this backend
    assert "_sharded_device_inputs" not in ver.fr.__dict__
    tdist.collectives = 0
    r_new = sess.run([Reach(s, t)], version=ver)[0]
    r_old = sess.run([Reach(s, t)], version=old)[0]
    assert tdist.collectives == 2
    assert (r_new.answer, r_old.answer) == (True, False)
    memo = ver.fr.__dict__["_sharded_device_inputs"]
    assert [key[0] for key in memo] == [ver.fr.arrays_version]
    assert ver.fr.arrays_version == fr.arrays_version + 1
    assert fr.__dict__["_sharded_device_inputs"].keys() == base_memo.keys()
    store.release(old)
