"""``repro_torch.connect(fr).run([...])`` vs ``repro.connect(fr)``: a mixed
batch of Reach, Dist (bounded and exact) and Rpq (two regexes) must give
the same answers, distances and QueryStats, and match the host oracles."""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import Dist as JDist
from repro.core import Reach as JReach
from repro.core import Rpq as JRpq
from repro.core import build_query_automaton as j_automaton
from repro.core import fragment_graph as j_fragment
from repro.graph import erdos_renyi as j_er
from repro.graph import random_partition as j_random_partition
from repro_torch import Dist, GraphDelta, NoCudaDevice, Reach, Rpq, Status
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import erdos_renyi, random_partition

from oracles import oracle_dist, oracle_reach, oracle_rpq

REGEXES = ["0* 1*", "(0|1)* 2"]
# (n, m, k, seed): the generators of tests/test_batched_cache.py, and a
# single fragment (no boundary at all)
CASES = [(24, 70, 3, 0), (36, 110, 4, 11), (12, 30, 1, 2)]


def _fragmentations(n, m, k, seed):
    jg, tg = j_er(n, m, n_labels=3, seed=seed), erdos_renyi(n, m, 3, seed)
    jp, tp = j_random_partition(jg, k, seed), random_partition(tg, k, seed)
    return j_fragment(jg, jp, k), fragment_graph(tg, tp, k)


def _mixed(n, seed):
    """A mixed batch as (kind, s, t, bound, regex) rows; a small endpoint
    pool forces duplicate pairs and s == t."""
    rng = np.random.default_rng(seed)
    pool = [tuple(int(x) for x in rng.integers(0, n, 2)) for _ in range(6)]
    pool.append((2, 2))
    rows = []
    for i in range(24):
        s, t = pool[int(rng.integers(0, len(pool)))]
        rows.append((i % 4, s, t, int(rng.integers(-1, 4)), REGEXES[i % 2]))
    return rows


def _queries(rows, reach, dist, rpq):
    qs = []
    for kind, s, t, bound, rx in rows:
        if kind == 0:
            qs.append(reach(s, t))
        elif kind == 1:
            qs.append(dist(s, t, bound=None if bound < 0 else bound))
        else:
            qs.append(rpq(s, t, regex=rx))
    return qs


def _check_oracles(g, queries, results):
    for q, r in zip(queries, results):
        if isinstance(q, Reach):
            assert r.answer == oracle_reach(g, q.s, q.t), q
        elif isinstance(q, Dist):
            d = oracle_dist(g, q.s, q.t)
            ok = d is not None and (q.bound is None or d <= q.bound)
            assert (r.answer, r.distance) == (ok, d if ok else None), q
        else:
            qa = j_automaton(q.regex, int)
            assert r.answer == oracle_rpq(g, q.s, q.t, qa), q


@pytest.mark.parametrize("case", CASES, ids=str)
def test_mixed_batch_matches_reference_and_oracles(case):
    jfr, tfr = _fragmentations(*case)
    rows = _mixed(case[0], case[3])
    want = repro.connect(jfr, backend="vmap").run(
        _queries(rows, JReach, JDist, JRpq))
    sess = repro_torch.connect(tfr, device="cpu")
    queries = _queries(rows, Reach, Dist, Rpq)
    got = sess.run(queries)
    assert len(got) == len(want) == len(queries)
    for q, r, w in zip(queries, got, want):
        assert (r.answer, r.distance) == (w.answer, w.distance), q
        assert r.stats == w.stats and tuple(r.stats) == tuple(w.stats), q
        assert (r.cache_version, r.status, r.degraded) == (0, Status.DONE,
                                                           False)
    _check_oracles(tfr.g, queries, got)
    assert sess.stats.executions == sess.last_plan.n_groups == 4
    assert sess.cache_version == 0
    # a second run answers from the built caches, identically
    again = sess.run(queries)
    assert [(r.answer, r.distance) for r in again] == \
        [(r.answer, r.distance) for r in got]


def test_degenerate_batches():
    """Empty batch, s == t, and one fragment (nb == 0) where only the
    direct local answer applies."""
    _, tfr = _fragmentations(10, 20, 2, 1)
    sess = repro_torch.connect(tfr, device="cpu")
    assert sess.run([]) == []
    assert sess.reach(3, 3)
    r = sess.dist(3, 3, bound=0)
    assert (r.answer, r.distance) == (True, 0)
    assert sess.rpq(4, 4, regex="0 1") is False      # not nullable
    assert sess.rpq(4, 4, regex="0*") is True        # nullable
    g1 = erdos_renyi(12, 30, seed=2)
    fr1 = fragment_graph(g1, np.zeros(12, np.int32), 1)
    assert fr1.n_boundary == 0
    sess1 = repro_torch.connect(fr1, device="cpu")
    pairs = [(0, 5), (5, 0), (2, 2)]
    got = sess1.run([Reach(s, t) for s, t in pairs])
    for (s, t), r in zip(pairs, got):
        assert r.answer == oracle_reach(g1, s, t)
    got = sess1.run([Dist(s, t) for s, t in pairs])
    for (s, t), r in zip(pairs, got):
        assert r.distance == oracle_dist(g1, s, t)


def test_connect_defaults_to_cuda_and_never_falls_back(monkeypatch):
    _, tfr = _fragmentations(10, 20, 2, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice, match='device="cpu"'):
        repro_torch.connect(tfr)
    with pytest.raises(NoCudaDevice):
        repro_torch.connect(tfr, device="cuda")
    assert repro_torch.connect(tfr, device="cpu").device.type == "cpu"


def test_unported_paths_raise():
    _, tfr = _fragmentations(10, 20, 2, 1)
    # the sharded backend is ported, but needs the caller's process group
    with pytest.raises(RuntimeError, match="init_process_group"):
        repro_torch.connect(tfr, backend="shard_map", device="cpu")
    with pytest.raises(ValueError):
        repro_torch.connect(tfr, backend="mesh", device="cpu")
    with pytest.raises(ValueError):
        repro_torch.connect(tfr, cache="lazy", device="cpu")
    # the one-shot engine and graph deltas are ported (item 5b and item 6)
    uncached = repro_torch.connect(tfr, cache="none", device="cpu")
    assert uncached.run([Reach(0, 1)])[0].answer == oracle_reach(tfr.g, 0, 1)
    sess = repro_torch.connect(tfr, backend="vmap", device="cpu")
    assert sess.backend == "vmap"
    assert sess.apply(GraphDelta()).mode == "noop"
    # so are the MVCC building blocks: repair_on repairs a clone, and
    # run(version=) answers against it, stamped with its cache version
    from repro_torch.core.versions import Version, cow_clone
    sess.warm()
    delta = GraphDelta.insert([(0, 1)])
    clone = cow_clone(tfr, delta)
    assert sess.repair_on(clone, delta).mode in ("repair", "recompute",
                                                 "rebuild")
    r = sess.run([Reach(0, 1)], version=Version(1, clone))[0]
    assert r.answer is True and r.cache_version == 1
    assert sess.cache_version == 0 and tfr.arrays_version == 0
