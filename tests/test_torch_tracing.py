"""The port's span-and-counter recorder (``repro_torch.tracing``) on the
CPU: nothing recorded and no clock read while it is off; spans that nest
and share the id of the batch or query they serve; counts that fold into
the top span; hand counts of fixpoint steps and uploaded bytes on a chain;
no record lost under a threaded server; the server's queue-wait telemetry;
and the readings ``tools/trace_cell.py`` takes from a tiny benchmark cell.
"""
import importlib.util
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch import (Dist, GraphDelta, QueryServer, Reach, Status,
                         connect, tracing)
from repro_torch.core.fragments import fragment_graph, query_slots
from repro_torch.graph import Graph, block_partition, erdos_renyi
from repro_torch.graph import random_partition
from repro_torch.serve import Telemetry

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 60.0

# a chain 0 -> 1 -> ... -> 9 cut into two blocks: nodes 0-4 and 5-9
CHAIN_N = 10


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test leaves the recorder off and empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _er(n=48, m=160, k=3, seed=2):
    g = erdos_renyi(n, m, n_labels=3, seed=seed)
    return fragment_graph(g, random_partition(g, k, 1), k)


def _reserved(n=64, m=200, k=3, seed=4):
    """A fragmentation with headroom, so that inserted edges repair."""
    g = erdos_renyi(n, m, n_labels=3, seed=seed)
    return fragment_graph(g, random_partition(g, k, 1), k,
                          reserve_boundary=16, reserve_edges=32,
                          reserve_stubs=16)


def _intra_deltas(fr, count, seed=3):
    """``count`` deltas of two new edges inside fragment 0 each."""
    rng = np.random.default_rng(seed)
    nodes = np.nonzero(fr.part == 0)[0]
    return [GraphDelta.insert([tuple(int(x) for x in rng.choice(nodes, 2,
                                                                replace=False))
                               for _ in range(2)]) for _ in range(count)]


def _chain():
    g = Graph(CHAIN_N, np.arange(CHAIN_N - 1), np.arange(1, CHAIN_N),
              np.zeros(CHAIN_N, dtype=np.int32))
    return fragment_graph(g, block_partition(g, 2), 2)


def _served(fr, pairs):
    """One deterministic flush of ``pairs`` (``(s, t, kind)``) through a
    server on the CPU; returns the futures."""
    srv = QueryServer(fr, device="cpu", start=False, with_dist=True,
                      batch_size=16)
    futs = [srv.submit(s, t, kind=k) for s, t, k in pairs]
    srv.flush()
    srv.close()
    return futs


def _oneshot(fr, queries):
    return connect(fr, cache="none", device="cpu").run(queries)


def _traced(fn, *args):
    tracing.enable()
    try:
        out = fn(*args)
    finally:
        tracing.disable()
    return out, tracing.drain()


def _spans(records, name):
    return [r for r in records if r.kind == "span" and r.name == name]


MIXED = [(0, 5, "reach"), (1, 7, "dist"), (2, 9, "reach"), (3, 4, "dist")]


@pytest.mark.parametrize("path", ["served", "oneshot", "mvcc"])
def test_off_records_nothing_and_reads_no_clock(path, monkeypatch):
    fr = _er() if path != "mvcc" else _reserved()
    server = QueryServer(fr, device="cpu", start=False, with_dist=True,
                         mvcc=path == "mvcc")

    def forbidden():
        raise AssertionError("a clock was read with the recorder off")
    monkeypatch.setattr(time, "monotonic_ns", forbidden)
    monkeypatch.setattr(time, "thread_time_ns", forbidden)
    if path == "served":
        futs = [server.submit(s, t, kind=k) for s, t, k in MIXED]
        server.flush()
        assert all(f.status is Status.DONE for f in futs)
    elif path == "mvcc":
        futs = [server.submit_delta(d) for d in _intra_deltas(fr, 2)]
        futs += [server.submit(s, t, kind=k) for s, t, k in MIXED]
        server.flush()
        assert all(f.status in (Status.APPLIED, Status.DONE) for f in futs)
    else:
        results = _oneshot(fr, [Reach(0, 5), Dist(1, 7)])
        assert all(r.status is Status.DONE for r in results)
    server.close()
    assert tracing.drain() == []


def test_spans_nest_under_the_batch_and_share_its_id():
    futs, recs = _traced(_served, _er(), MIXED)
    (batch,) = _spans(recs, "serve.batch")
    (run,) = _spans(recs, "session.run")
    assert run.parent == batch.id
    assert {s.parent for s in _spans(recs, "session.plan")} == {run.id}
    groups = _spans(recs, "session.group")
    assert sorted(g.attrs["kind"] for g in groups) == ["dist", "reach"]
    assert all(g.parent == run.id and g.attrs["n"] == 2
               and g.attrs["size"] == 8 for g in groups)
    for name in ("cache.inputs", "cache.per_query", "cache.t_column",
                 "cache.compose", "cache.readback", "session.answers"):
        children = _spans(recs, name)
        assert sorted(c.parent for c in children) == sorted(
            g.id for g in groups), name
    under = [r for r in recs if r.kind == "span"
             and r.name.split(".")[0] in ("session", "cache")]
    assert {r.serves for r in under} == {batch.id}
    for r in under:
        parent = next(p for p in recs if p.kind == "span" and p.id == r.parent
                      ) if r.parent != batch.id else batch
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        assert 0 <= r.cpu_ns
    waits = [r for r in recs if r.kind == "wait"]
    assert sorted(w.id for w in waits) == sorted(f.id for f in futs)
    assert all(w.name == "serve.queue_wait" and w.parent == batch.id
               and w.start_ns <= w.end_ns <= batch.end_ns for w in waits)


def _children_sum(recs, parent):
    total = {}
    for r in recs:
        if r.kind == "span" and r.parent == parent.id:
            for k, v in r.counts.items():
                total[k] = total.get(k, 0) + v
    return total


@pytest.mark.parametrize("path", ["served", "oneshot"])
def test_counts_fold_into_the_top_span(path):
    if path == "served":
        _, recs = _traced(_served, _er(), MIXED)
        (top,) = _spans(recs, "serve.batch")
        inner = (_spans(recs, "session.run")
                 + _spans(recs, "session.group"))
    else:
        _, recs = _traced(_oneshot, _er(), [Reach(0, 5), Dist(1, 7)])
        inner = tops = _spans(recs, "oneshot.query")
        assert len(tops) == 2
        top = _spans(recs, "session.run")[0]
    assert top.counts["host.syncs"] > 0
    assert top.counts["fixpoint.steps"] > 0
    assert top.counts["h2d.pageable_bytes"] > 0
    for span in [top] + inner:
        assert span.counts == _children_sum(recs, span), span.name


def test_chain_counts_match_the_hand_count():
    """From 0, fragment 0 (nodes 0-4 and the stub of 5) takes one step a
    node: 1, 2, 3, 4, the stub, then a step that changes nothing: 6 steps.
    Fragment 1's source, in-node 5, needs 5 (6, 7, 8, 9, none), so the
    all-sources one-shot loop also runs 6."""
    fr = _chain()
    nb = fr.n_boundary
    _, recs = _traced(_served, fr, [(0, 9, "reach")])
    (group,) = _spans(recs, "session.group")
    size = group.attrs["size"]
    (pq,) = _spans(recs, "cache.per_query")
    assert pq.counts == {"fixpoint.steps": 6, "host.syncs": 7}
    (inputs,) = _spans(recs, "cache.inputs")
    # frag_s, s_slot, t_slot_sfrag [size] and t_cols [size, nb], int64
    assert inputs.counts == {"h2d.pageable_bytes": 8 * size * (3 + nb)}
    (readback,) = _spans(recs, "cache.readback")
    assert readback.counts == {"host.syncs": 1}

    (result,), recs = _traced(_oneshot, fr, [Reach(0, 9)])
    assert result.answer
    (local,) = _spans(recs, "oneshot.local_eval")
    assert local.counts["fixpoint.steps"] == 6
    qs = query_slots(fr, 0, 9)
    (inputs,) = _spans(recs, "oneshot.inputs")
    assert inputs.counts == {"h2d.pageable_bytes": (
        sum(v.nbytes for v in fr.arrays.values())
        + qs["s_local"].nbytes + qs["t_local"].nbytes)}
    (evaldg,) = _spans(recs, "oneshot.evaldg")
    # the source-row and target-column masks, bool [B] each
    assert evaldg.counts == {"h2d.pageable_bytes": 2 * fr.B,
                             "host.syncs": 1}


def test_threaded_server_loses_no_record():
    fr = _er(n=64, m=220, k=4, seed=5)
    rng = np.random.default_rng(0)
    kinds = ["reach", "dist", "bounded"]
    futs, lock = [], threading.Lock()
    srv = QueryServer(fr, device="cpu", with_dist=True, batch_size=8)

    def submitter(seed):
        r = np.random.default_rng(seed)
        for _ in range(40):
            s, t = (int(x) for x in r.integers(0, fr.g.n, size=2))
            k = kinds[int(r.integers(0, 3))]
            f = srv.submit(s, t, kind=k, bound=3 if k == "bounded" else None)
            with lock:
                futs.append(f)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    tracing.enable()
    try:
        threads = [threading.Thread(target=submitter, args=(int(seed),))
                   for seed in rng.integers(0, 2 ** 31, size=2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        assert not any(t.is_alive() for t in threads)
        for f in futs:
            f.result(timeout=TIMEOUT_S)
        srv.close()
    finally:
        tracing.disable()
        sys.setswitchinterval(old)
    recs = tracing.drain()
    assert len(futs) == 80
    waits = [r for r in recs if r.kind == "wait"]
    assert sorted(w.id for w in waits) == sorted(f.id for f in futs)
    batches = _spans(recs, "serve.batch")
    assert len(batches) == srv.batches_run
    ids = {b.id for b in batches}
    runs = _spans(recs, "session.run")
    assert len(runs) == len(batches) and {r.parent for r in runs} == ids
    assert {w.parent for w in waits} <= ids
    assert sum(g.attrs["n"] for g in _spans(recs, "session.group")) == 80
    assert len({r.id for r in recs if r.kind == "span"}) == len(
        [r for r in recs if r.kind == "span"])


VERSIONS = 2


def _committed(fr, deltas):
    """The deltas committed through an MVCC server on the CPU, reads
    between them; returns the delta futures and the server's store."""
    srv = QueryServer(fr, device="cpu", start=False, with_dist=True,
                      mvcc=True, versions=VERSIONS, batch_size=8)
    futs = []
    for d in deltas:
        futs.append(srv.submit_delta(d))
        for s, t, k in MIXED:
            srv.submit(s, t, kind=k)
    srv.flush()
    srv.close()
    return futs, srv.engine.store


def test_repair_lane_spans_nest_under_each_commit():
    """Each delta: one ``serve.commit`` that holds its wait, its clone,
    its repair and its publish; the repair holds the frontiers, the row
    diff, the two rank updates and the refresh; ``repair.rows`` is the
    repair's changed rows, and no publish finds the store above its
    capacity."""
    (futs, store), recs = _traced(_committed, _reserved(),
                                  _intra_deltas(_reserved(), 3))
    stats = [f.result(timeout=TIMEOUT_S) for f in futs]
    assert [s.mode for s in stats] == ["repair"] * 3
    commits = _spans(recs, "serve.commit")
    assert len(commits) == 3
    ids = [c.id for c in commits]
    by_parent = {}
    for r in recs:
        if r.kind == "span":
            by_parent.setdefault(r.parent, []).append(r)
    for commit, st in zip(commits, stats):
        kids = sorted(r.name for r in by_parent[commit.id])
        assert kids == ["mvcc.clone", "mvcc.publish", "repair.apply"]
        (apply_,) = [r for r in by_parent[commit.id]
                     if r.name == "repair.apply"]
        assert apply_.attrs == {"kind": "repair"}
        assert apply_.counts["repair.rows"] == st.changed_rows
        assert apply_.counts.get("repair.launches", 0) == (
            6 if st.changed_rows else 0)
        assert apply_.counts.get("closure.squarings", 0) >= (
            2 if st.changed_rows else 0)
        inner = sorted((r.name, r.attrs.get("kind"))
                       for r in by_parent[apply_.id])
        want = [("repair.diff", None), ("repair.frontiers", None),
                ("repair.refresh", None)]
        if st.changed_rows:
            want += [("repair.rank_update", "bool"),
                     ("repair.rank_update", "tropical")]
        assert inner == sorted(want)
        for r in [apply_] + by_parent[apply_.id]:
            assert r.serves == commit.id
            assert commit.start_ns <= r.start_ns <= r.end_ns <= commit.end_ns
    waits = [r for r in recs if r.kind == "wait"
             and r.name == "serve.delta_wait"]
    assert sorted(w.id for w in waits) == sorted(f.id for f in futs)
    assert sorted(w.parent for w in waits) == sorted(ids)
    assert sum(st.changed_rows for st in stats) > 0
    clones, publishes = (_spans(recs, "mvcc.clone"),
                         _spans(recs, "mvcc.publish"))
    assert [p.attrs["n"] for p in publishes] == [2, 2, 2]
    assert all(p.attrs["n"] <= VERSIONS for p in publishes)
    assert [c.attrs["n"] for c in clones] == [2, 3, 3]
    # beside the store's versions at most the session's own first one
    # stays resident (an open memory cost, not a guarantee)
    assert all(p.attrs["n"] <= p.attrs["size"] <= p.attrs["n"] + 1
               for p in publishes)
    assert all(c.counts["mvcc.clone_bytes"] > 0 for c in clones)
    assert all(p.counts["mvcc.version_bytes"] > 0 for p in publishes)
    assert store.committed == 3


def test_enable_starts_afresh_and_drain_takes_everything():
    tracing.enable()
    with tracing.span("a"):
        tracing.count("c", 2)
    tracing.enable()                     # drops what was not drained
    with tracing.span("b", kind="k"):
        tracing.count("c", 3)
        with tracing.span("inner"):
            tracing.count("c")
    tracing.count("loose", 4)
    tracing.disable()
    tracing.count("c")                   # off: nothing
    recs = tracing.drain()
    assert [r.name for r in recs if r.kind == "span"] == ["b", "inner"]
    b, inner = (r for r in recs if r.kind == "span")
    assert b.counts == {"c": 4} and inner.counts == {"c": 1}
    assert b.attrs == {"kind": "k"} and inner.serves == b.serves == b.id
    assert inner.parent == b.id and b.parent == 0
    (loose,) = (r for r in recs if r.kind == "count")
    assert loose.counts == {"loose": 4}
    assert tracing.drain() == []


def test_enable_while_a_span_is_open_keeps_it_whole():
    """A new recording started while a span is open: the span closes
    into the old one's lists, and the new recording starts clean."""
    tracing.enable()
    with tracing.span("old"):
        tracing.enable()
        with tracing.span("new"):
            tracing.count("c")
        tracing.count("c")
    tracing.disable()
    recs = tracing.drain()
    assert [(r.name, r.parent, dict(r.counts)) for r in recs] == [
        ("c", 0, {"c": 1}), ("new", 0, {"c": 1})]


def test_telemetry_reports_queue_wait_per_route():
    srv = QueryServer(_er(), device="cpu", start=False, with_dist=True)
    futs = [srv.submit(s, t, kind=k) for s, t, k in MIXED]
    expired = srv.submit(0, 1, kind="reach", deadline_ms=0.0)
    time.sleep(0.01)
    srv.flush()
    assert expired.status is Status.DEADLINE
    assert expired._queue_wait_s is None
    assert all(f._queue_wait_s >= 0.01 for f in futs)
    routes = srv.telemetry()["routes"]
    srv.close()
    for route in ("reach/green", "dist/green"):
        r = routes[route]
        # each request waits no longer than its whole latency, so every
        # order statistic of the waits is at most the latencies'
        assert 10.0 <= r["queue_wait_p50_ms"] <= r["p50_ms"]
        assert r["queue_wait_p50_ms"] <= r["queue_wait_p95_ms"] <= r["p95_ms"]


def test_telemetry_keeps_queue_waits_only_where_given():
    t = Telemetry(window=4)
    for i in range(6):
        t.record("reach/green", 0.002 * (i + 1), Status.DONE, 0.001 * i)
    t.record("update", 0.5, Status.APPLIED)
    routes = t.snapshot()["routes"]
    assert routes["reach/green"]["queue_wait_p50_ms"] == pytest.approx(4.0)
    assert routes["reach/green"]["queue_wait_p95_ms"] == pytest.approx(5.0)
    assert "queue_wait_p50_ms" not in routes["update"]


def _trace_cell():
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    spec = importlib.util.spec_from_file_location(
        "trace_cell", ROOT / "tools" / "trace_cell.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_cell_reads_the_repair_lane():
    """The delta cell's window, cut to the CPU: its commits give the
    repair lane's readings; the other cells' readings have none."""
    tool = _trace_cell()
    from bench import spec
    from bench.tests import tiny
    cell = tiny.shrink(spec.load_cell(ROOT, "cached.reads_deltas"))
    run, result, recs = tool.traced_run(cell, 2 ** 31 + 13, 1.0, "cpu")
    assert result["correct"], result["checks"]
    assert run.deltas
    got = tool.readings(recs, run.trace)
    for name in ("serve.delta_wait_ms_p50", "repair.commit_ms_p50",
                 "repair.apply_ms_p50", "repair.frontiers_ms_p50",
                 "repair.rank_bool_ms_p50", "repair.rank_tropical_ms_p50",
                 "repair.rows_p50", "repair.launches_p50",
                 "repair.host_syncs_p50", "mvcc.clone_kib_p50",
                 "mvcc.version_gib_p50"):
        assert got[name] is not None and got[name] >= 0, name
    versions = cell.config["server"]["versions"]
    assert got["mvcc.live_versions_max"] == versions + 1
    assert versions + 1 <= got["mvcc.resident_versions_max"] <= versions + 2
    idle = tool.repair_readings([])
    assert set(idle) < set(got) and all(v is None for v in idle.values())


@pytest.mark.parametrize("cell,expect", [
    ("cached.reads", ["serve.queue_wait_ms_p50", "session.cpu_share",
                      "session.inputs_ms_p50", "session.per_query_ms_p50",
                      "session.host_syncs_per_batch",
                      "session.upload_mib_per_batch"]),
    ("oneshot.reach_dist", ["session.cpu_share",
                            "oneshot.local_steps_p50",
                            "oneshot.evaldg_rows_p50",
                            "oneshot.evaldg_levels_p50"])])
def test_trace_cell_reads_the_program_records(cell, expect):
    tool = _trace_cell()
    from bench.tests import tiny
    run, result, recs = tool.traced_run(tiny.cell(cell), 2 ** 31 + 11, 0.5,
                                        "cpu")
    assert result["correct"], result["checks"]
    got = tool.readings(recs, run.trace)
    for name in expect:
        assert got[name] is not None and got[name] >= 0, name
    assert got["device.idle_unlabelled_share.reads"] is None   # no trace
    block = tool.program_block(run, recs)
    assert "session.run" in block["spans"]
    events = tool.chrome(recs)["traceEvents"]
    assert {e["name"] for e in events} >= {"session.run"}
    assert not tracing.ON
