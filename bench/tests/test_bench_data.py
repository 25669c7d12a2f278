"""The benchmark's inputs come from the seed alone, in fixed counts."""
from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from bench.data import generate as gen
from bench.spec import BENCH

CONFIG = {"generator": "erdos_renyi", "n_nodes": 512, "n_edges": 2048,
          "n_labels": 8, "partitioner": "random_partition", "n_fragments": 8,
          "graph_seed": 0}
MIX = {"mix": {"shares": {"reach": 1, "dist": 1, "bounded": 1}, "bound": 6},
       "pairs": {"sampler": "uniform"}}
DELTAS = {"rate_per_s": 10, "edges": 8, "shapes": {"intra": 3, "cross": 1}}
ARRIVALS = {"process": "poisson_quantiles"}


def _arrivals(count, seconds, seed):
    return gen.make_arrivals(count, seconds, ARRIVALS, seed, gen.ARRIVALS)
BIG = 2 ** 31 + 12345


def _same_graph(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("src", "dst", "labels", "part"))


def test_same_seed_same_inputs():
    a, b = gen.make_graph(CONFIG, BIG), gen.make_graph(CONFIG, BIG)
    assert _same_graph(a, b)
    assert gen.make_reads(a.n, 300, MIX, BIG) == gen.make_reads(b.n, 300,
                                                                MIX, BIG)
    assert gen.make_deltas(a, 40, DELTAS, BIG) == gen.make_deltas(
        b, 40, DELTAS, BIG)
    np.testing.assert_array_equal(_arrivals(500, 20.0, BIG),
                                  _arrivals(500, 20.0, BIG))


def test_other_seed_other_inputs_same_counts():
    a, b = gen.make_graph(CONFIG, 1), gen.make_graph(CONFIG, 2)
    assert not _same_graph(a, b)
    assert a.src.shape == b.src.shape == (2048,)
    ra, rb = gen.make_reads(a.n, 301, MIX, 1), gen.make_reads(a.n, 301,
                                                              MIX, 2)
    assert ra != rb
    for reads in (ra, rb):
        kinds = [r.kind for r in reads]
        assert sorted(kinds.count(k) for k in gen.KINDS) == [0, 100, 100,
                                                             101]
        assert "rpq" not in kinds
        assert all(r.bound == 6 for r in reads if r.kind == "bounded")
    da, db = gen.make_deltas(a, 40, DELTAS, 1), gen.make_deltas(a, 40,
                                                                DELTAS, 2)
    assert da != db
    for ds in (da, db):
        assert [d.shape for d in ds].count("cross") == 10
        assert all(len(d.inserts) == 8 and not d.deletes for d in ds)


def _shape(g):
    """What a relabelling keeps: each fragment's sorted (internal edges,
    edges out, nodes) counts, and the sorted in- and out-degrees."""
    ps, pd = g.part[g.src], g.part[g.dst]
    frags = sorted((int(((ps == f) & (pd == f)).sum()),
                    int(((ps == f) & (pd != f)).sum()),
                    int((g.part == f).sum())) for f in range(g.k))
    return (frags, sorted(np.bincount(g.src, minlength=g.n)),
            sorted(np.bincount(g.dst, minlength=g.n)),
            sorted(np.bincount(g.labels)))


def test_seeds_relabel_one_graph():
    a, b = gen.make_graph(CONFIG, 1), gen.make_graph(CONFIG, BIG)
    assert _shape(a) == _shape(b)
    c = gen.make_graph(dict(CONFIG, graph_seed=1), 1)
    assert _shape(c) != _shape(a)


def test_deltas_leave_one_fragment():
    g = gen.make_graph(CONFIG, 3)
    for d in gen.make_deltas(g, 60, DELTAS, 3):
        frags = {int(g.part[u]) for u, _ in d.inserts}
        assert len(frags) == 1
        if d.shape == "intra":
            assert {int(g.part[v]) for _, v in d.inserts} == frags


def test_arrivals_fill_the_window_at_the_rate():
    for seed in (1, 2, BIG):
        t = _arrivals(1000, 20.0, seed)
        assert t[0] == 0.0 and np.all(np.diff(t) > 0) and t[-1] < 20.0
        gaps = np.sort(np.diff(np.append(t, 20.0)))
        # the same set of gaps for every seed, in another order
        ref = np.sort(np.diff(np.append(_arrivals(1000, 20.0, 7), 20.0)))
        np.testing.assert_allclose(gaps, ref, rtol=1e-9, atol=1e-12)


def test_a_delta_shape_sees_the_edges_drawn_before_it():
    g = gen.make_graph(CONFIG, 4)
    ctx = gen.DeltaContext(g)
    first = gen.make_deltas(g, 5, DELTAS, 4, ctx=ctx)
    src, dst = ctx.edges()
    assert len(src) == len(g.src) + 5 * 8
    assert list(zip(src[-8:].tolist(), dst[-8:].tolist())) == first[-1].inserts
    gone = gen.Delta("delete", [], [(int(src[0]), int(dst[0]))])
    ctx.add(gone)
    assert len(ctx.edges()[0]) == len(src) - 1
    with np.testing.assert_raises(ValueError):
        gen.apply(ctx.edges(), gen.Delta("delete", [], [(-1, -1)]))


# the reads each older traffic file drew before rpq reads were added to
# the kinds, for n = 32768: a digest of every read's kind, pair and bound
OLDER_READS = {
    ("reach_dist_closed", 11):
        "13b07810add45ffd8ab434c40595a36eecac57fa2c172a9c127710952d62ac8d",
    ("reach_dist_closed", 2 ** 31 + 12345):
        "82a8b4140974d17dea187624c0c2a24d9dffcd8e2b96898d3b829fb434a2ee43",
    ("reads_backlog", 11):
        "d734f759acaffa0a8b376bf454ea5713566a4967de84a0730afd1c538c3b899a",
    ("reads_backlog", 2 ** 31 + 12345):
        "24679d21e476dd2f53e70f89506feb5e8f8a3a98037c9d556cf51769b3aa08f9",
    ("reads_deltas_backlog", 11):
        "d734f759acaffa0a8b376bf454ea5713566a4967de84a0730afd1c538c3b899a",
    ("reads_deltas_backlog", 2 ** 31 + 12345):
        "24679d21e476dd2f53e70f89506feb5e8f8a3a98037c9d556cf51769b3aa08f9",
}


def _traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,seed", sorted(OLDER_READS))
def test_older_traffic_draws_the_reads_it_drew(name, seed):
    """A kind added at the end of the kinds, with no share in these mixes,
    leaves every read they draw as it was: kind, pair and bound."""
    reads = gen.make_reads(32768, _traffic(name)["reads"], _traffic(name),
                           seed)
    rows = [[r.kind, r.s, r.t, r.bound] for r in reads]
    assert all(r.regex == "" for r in reads)
    digest = hashlib.sha256(json.dumps(rows).encode()).hexdigest()
    assert digest == OLDER_READS[name, seed]


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12345])
def test_rpq_traffic_draws_rpq_reads_with_the_regex(seed):
    traffic = _traffic("rpq_closed")
    reads = gen.make_reads(32768, traffic["reads"], traffic, seed)
    assert len(reads) == 4096
    assert all(r.kind == "rpq" and r.bound == 0 for r in reads)
    assert {r.regex for r in reads} == {traffic["mix"]["regex"]}
    other = gen.make_reads(32768, traffic["reads"], traffic, seed + 1)
    assert [(r.s, r.t) for r in reads] != [(r.s, r.t) for r in other]
