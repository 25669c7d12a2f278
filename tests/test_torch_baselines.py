"""The port's baselines of the paper's Sec. 7 (``core.baselines``:
disReach_n, disReach_m; ``core.mapreduce``: MRdRPQ) vs the JAX package's,
on the CPU: the same inputs from numpy seeds, every field of the result
equal (answers, traffic bits, site visits, rounds, the MR cost model).
"""
import weakref

import numpy as np
import pytest
import torch

from repro.core import build_query_automaton as j_automaton
from repro.core import dis_reach as j_dis_reach
from repro.core import engine as jengine
from repro.core import fragment_graph as j_fragment
from repro.core.baselines import dis_reach_m as j_dis_reach_m
from repro.core.baselines import dis_reach_n as j_dis_reach_n
from repro.core.mapreduce import mr_drpq as j_mr_drpq
from repro.graph import erdos_renyi as j_er
from repro.graph import labeled_chain_graph as j_chain
from repro.graph import random_partition as j_random_partition
from repro.graph.graph import Graph as JGraph
from repro_torch import NoCudaDevice
from repro_torch.core import engine as tengine
from repro_torch.core.api import dis_reach
from repro_torch.core.automaton import build_query_automaton
from repro_torch.core.baselines import (BaselineResult, dis_reach_m,
                                        dis_reach_n)
from repro_torch.core.fragments import fragment_graph
from repro_torch.core.mapreduce import MRResult, mr_drpq
from repro_torch.graph import erdos_renyi, labeled_chain_graph
from repro_torch.graph import random_partition
from repro_torch.graph.graph import Graph

from oracles import oracle_reach, oracle_rpq


def _er_case(n, m, k, seed, part_seed, n_labels=1):
    jg = j_er(n, m, n_labels=n_labels, seed=seed)
    tg = erdos_renyi(n, m, n_labels=n_labels, seed=seed)
    return (jg, j_fragment(jg, j_random_partition(jg, k, part_seed), k),
            fragment_graph(tg, random_partition(tg, k, part_seed), k))


def _fields(res):
    return tuple(res.__dict__.values())


# ---------------------------------------------------------------------------
# disReach_n, disReach_m
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [8, 9, 10, 11])
@pytest.mark.parametrize("name", ["n", "m"])
def test_baseline_matches_reference(name, seed):
    """erdos_renyi(36, 100) in 4 random fragments (the reference's
    test_baselines_agree_with_engine): every field equal, and the answer
    equal to the oracle."""
    jg, jfr, tfr = _er_case(36, 100, 4, seed, 1)
    j_fn, t_fn = {"n": (j_dis_reach_n, dis_reach_n),
                  "m": (j_dis_reach_m, dis_reach_m)}[name]
    rng = np.random.default_rng(4)
    for _ in range(8):
        s, t = int(rng.integers(jg.n)), int(rng.integers(jg.n))
        got = t_fn(tfr, s, t, device="cpu")
        assert isinstance(got, BaselineResult)
        assert _fields(got) == _fields(j_fn(jfr, s, t)), (s, t)
        assert got.answer == oracle_reach(jg, s, t)


def test_message_passing_visits_sites_many_times():
    """The contrast the paper measures (the reference's
    test_message_passing_baseline_visits_sites_many_times): a 64-node chain
    dealt round-robin over 4 fragments takes disReach_m many rounds, each
    visiting every site, while the one-shot disReach takes one round."""
    n, k = 64, 4
    src, dst = np.arange(n - 1), np.arange(1, n)
    part = (np.arange(n) % k).astype(np.int32)
    jfr = j_fragment(JGraph(n, src, dst, np.zeros(n, np.int32)), part, k)
    tfr = fragment_graph(Graph(n, src, dst, np.zeros(n, np.int32)), part, k)
    got = dis_reach_m(tfr, 0, n - 1, device="cpu")
    assert _fields(got) == _fields(j_dis_reach_m(jfr, 0, n - 1))
    assert got.answer and got.rounds > k
    assert got.site_visits == k * got.rounds
    one = dis_reach(tfr, 0, n - 1, device="cpu")
    assert one.answer and one.stats.collective_rounds == 1
    assert j_dis_reach(jfr, 0, n - 1).stats.collective_rounds == 1
    # disReach_n ships the whole graph once
    assert _fields(dis_reach_n(tfr, 0, n - 1, device="cpu")) == \
        _fields(j_dis_reach_n(jfr, 0, n - 1))


def test_message_passing_round_cap():
    """``max_rounds`` cuts the chain short, as in the reference."""
    n, k = 64, 4
    src, dst = np.arange(n - 1), np.arange(1, n)
    part = (np.arange(n) % k).astype(np.int32)
    jfr = j_fragment(JGraph(n, src, dst, np.zeros(n, np.int32)), part, k)
    tfr = fragment_graph(Graph(n, src, dst, np.zeros(n, np.int32)), part, k)
    got = dis_reach_m(tfr, 0, n - 1, max_rounds=3, device="cpu")
    assert _fields(got) == _fields(j_dis_reach_m(jfr, 0, n - 1,
                                                 max_rounds=3))
    assert not got.answer and got.rounds == 3


def test_baselines_answer_s_equals_t():
    _, jfr, tfr = _er_case(36, 100, 4, 8, 1)
    for j_fn, t_fn in ((j_dis_reach_n, dis_reach_n),
                       (j_dis_reach_m, dis_reach_m)):
        assert _fields(t_fn(tfr, 5, 5, device="cpu")) == \
            _fields(j_fn(jfr, 5, 5))


# ---------------------------------------------------------------------------
# MRdRPQ
# ---------------------------------------------------------------------------

REGEXES = ["(0|1)* 2", "0* 1*", "2 (0|3)*"]


@pytest.mark.parametrize("regex", REGEXES)
@pytest.mark.parametrize("seed", [2, 3])
def test_mr_drpq_matches_reference(seed, regex):
    """erdos_renyi(40, 150, 4 labels) in 4 random fragments: the answer and
    the three bit counts equal the reference's, and the answer the
    product-graph oracle's."""
    jg, jfr, tfr = _er_case(40, 150, 4, seed, seed, n_labels=4)
    jqa, tqa = j_automaton(regex, int), build_query_automaton(regex, int)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        s, t = int(rng.integers(jg.n)), int(rng.integers(jg.n))
        got = mr_drpq(tfr, s, t, tqa, device="cpu")
        assert isinstance(got, MRResult)
        assert _fields(got) == _fields(j_mr_drpq(jfr, s, t, jqa)), (s, t)
        assert got.answer == oracle_rpq(jg, s, t, jqa)


def test_mr_drpq_planted_chain():
    """The reference's test_rpq_planted_chain_positive: a planted chain of
    label 2 from 0 to 11, matched by ``2*``."""
    args = (12, 30, 80)
    kw = dict(chain_label=2, n_labels=4, seed=0)
    jg, tg = j_chain(*args, **kw), labeled_chain_graph(*args, **kw)
    jfr = j_fragment(jg, j_random_partition(jg, 3, 5), 3)
    tfr = fragment_graph(tg, random_partition(tg, 3, 5), 3)
    jqa, tqa = j_automaton("2*", int), build_query_automaton("2*", int)
    got = mr_drpq(tfr, 0, 11, tqa, device="cpu")
    assert got.answer and oracle_rpq(jg, 0, 11, jqa)
    assert _fields(got) == _fields(j_mr_drpq(jfr, 0, 11, jqa))
    # s == t answers by nullability and ships nothing
    assert _fields(mr_drpq(tfr, 4, 4, tqa, device="cpu")) == \
        _fields(j_mr_drpq(jfr, 4, 4, jqa))


def test_mr_drpq_holds_one_mapper_block_and_the_reference_union(
        monkeypatch):
    """The reducer never holds more than one mapper's block: each block is
    written into D and dropped before the next mapper runs (a weakref
    count of the live blocks peaks at 1).  The assembled D equals the
    reference's OR over its stacked [k, B*Q, B*Q] rvsets."""
    jg, jfr, tfr = _er_case(40, 150, 4, 2, 2, n_labels=4)
    jqa = j_automaton("(0|1)* 2", int)
    tqa = build_query_automaton("(0|1)* 2", int)
    live, peak, mapped = [0], [0], []
    orig_local = tengine.local_eval_regular

    def counted(*args, **kw):
        rows, block = orig_local(*args, **kw)
        live[0] += 1
        peak[0] = max(peak[0], live[0])
        mapped.append(block.shape)

        def dropped():
            live[0] -= 1
        weakref.finalize(block, dropped)
        return rows, block

    seen = {}
    orig_t, orig_j = tengine.evaldg_reach, jengine.evaldg_reach

    def keep_t(D, *a, **kw):
        seen["port"] = D.numpy().copy()
        return orig_t(D, *a, **kw)

    def keep_j(D, *a, **kw):
        seen["ref"] = np.asarray(D)
        return orig_j(D, *a, **kw)

    monkeypatch.setattr(tengine, "local_eval_regular", counted)
    monkeypatch.setattr(tengine, "evaldg_reach", keep_t)
    monkeypatch.setattr(jengine, "evaldg_reach", keep_j)
    s, t = 3, 17
    got = mr_drpq(tfr, s, t, tqa, device="cpu")
    want = j_mr_drpq(jfr, s, t, jqa)
    assert got.answer == want.answer
    assert len(mapped) == tfr.k and peak[0] == 1
    side = tfr.B * tqa.n_states
    assert seen["port"].shape == (side, side)
    np.testing.assert_array_equal(seen["port"], seen["ref"])


# ---------------------------------------------------------------------------
# no card, no device: the entry points raise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["n", "m", "mr"])
def test_baselines_raise_without_a_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tfr = _er_case(36, 100, 4, 8, 1, n_labels=3)
    qa = build_query_automaton("(0|1)*", int)
    fn = {"n": lambda: dis_reach_n(tfr, 0, 5),
          "m": lambda: dis_reach_m(tfr, 0, 5),
          "mr": lambda: mr_drpq(tfr, 0, 5, qa)}[call]
    with pytest.raises(NoCudaDevice):
        fn()
