"""The port's amortized rvset cache and batched engine vs the JAX package:
bit-equal frontiers and closures, equal batch answers, and the same
answers from a JAX-built cache loaded into the port."""
import numpy as np
import pytest
import torch

from repro.core import build_query_automaton as j_automaton
from repro.core import cache as jcache
from repro.core import fragment_graph as j_fragment
from repro.graph import erdos_renyi as j_er
from repro.graph import random_partition as j_random_partition
from repro_torch.core import automaton as tauto
from repro_torch.core import cache as tcache
from repro_torch.core.fragments import Fragmentation, fragment_graph
from repro_torch.graph import erdos_renyi, random_partition

from oracles import oracle_dist, oracle_reach, oracle_rpq

CPU = torch.device("cpu")
REGEXES = ["0* 1*", "(0|1)* 2"]
# (n, m, k, seed, reserve_boundary): the generators of
# tests/test_batched_cache.py, one of them with spare boundary slots, and
# one fragment only (no boundary at all)
CASES = [(24, 70, 3, 0, 0), (30, 90, 3, 3, 4), (12, 30, 1, 2, 0)]


def _fragmentations(case):
    n, m, k, seed, rb = case
    jg = j_er(n, m, n_labels=4, seed=seed)
    jfr = j_fragment(jg, j_random_partition(jg, k, seed), k,
                     reserve_boundary=rb)
    tg = erdos_renyi(n, m, n_labels=4, seed=seed)
    tfr = fragment_graph(tg, random_partition(tg, k, seed), k,
                         reserve_boundary=rb)
    return jfr, tfr


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, n, size=(12, 2))
    p[0] = (1, 1)                                           # s == t
    return p


@pytest.fixture(scope="module", params=CASES, ids=str)
def ref(request):
    """The JAX package's cache state and batch answers for one case,
    computed once per module."""
    jfr, tfr = _fragmentations(request.param)
    c = jcache.prepare_rvset_cache(jfr, with_dist=True)
    pairs = _pairs(jfr.g.n, request.param[3])
    autos = {rx: j_automaton(rx, int) for rx in REGEXES}
    return dict(
        jfr=jfr, tfr=tfr, pairs=pairs,
        state={name: np.asarray(getattr(c, name)) for name in
               ("bl_frontier", "closure", "bl_dist", "dist_closure")},
        product={rx: np.asarray(jcache.product_closure(jfr, qa))
                 for rx, qa in autos.items()},
        reach=jcache.dis_reach_batch(jfr, pairs),
        dist=jcache.dis_dist_batch(jfr, pairs),
        bounded=jcache.dis_dist_batch(jfr, pairs, bound=2),
        rpq={rx: jcache.dis_rpq_batch(jfr, pairs, qa)
             for rx, qa in autos.items()})


def _check_state(cache, state):
    for name, want in state.items():
        got = getattr(cache, name)
        assert got.device == CPU
        assert got.dtype == (torch.bool if want.dtype == bool
                             else torch.int32), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def _check_answers(fr, ref):
    pairs = ref["pairs"]
    np.testing.assert_array_equal(tcache.dis_reach_batch(fr, pairs, CPU),
                                  ref["reach"])
    d = tcache.dis_dist_batch(fr, pairs, CPU)
    assert d.dtype == np.int64
    np.testing.assert_array_equal(d, ref["dist"])
    b = tcache.dis_dist_batch(fr, pairs, CPU, bound=2)
    assert b.dtype == bool
    np.testing.assert_array_equal(b, ref["bounded"])
    for rx, want in ref["rpq"].items():
        qa = tauto.build_query_automaton(rx, int)
        np.testing.assert_array_equal(
            tcache.dis_rpq_batch(fr, pairs, qa, CPU), want, err_msg=rx)


def _fresh(ref):
    """A fresh port fragmentation (no cache attached) for the case."""
    tfr = ref["tfr"]
    fresh = Fragmentation(g=tfr.g, part=tfr.part, k=tfr.k,
                          bnodes=tfr.bnodes, b_index=tfr.b_index,
                          n_max=tfr.n_max, e_max=tfr.e_max, s_max=tfr.s_max,
                          arrays=tfr.arrays, frag_sizes=tfr.frag_sizes,
                          owner_local=tfr.owner_local, nb_cap=tfr.nb_cap)
    return fresh


def test_cache_state_matches_reference(ref):
    tfr = _fresh(ref)
    _check_state(tcache.prepare_rvset_cache(tfr, CPU, with_dist=True),
                 ref["state"])


def test_product_closure_matches_reference(ref):
    tfr = _fresh(ref)
    for rx, want in ref["product"].items():
        qa = tauto.build_query_automaton(rx, int)
        got = tcache.product_closure(tfr, qa, CPU)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=rx)


def test_batch_answers_match_reference_and_oracle(ref):
    tfr = _fresh(ref)
    _check_answers(tfr, ref)
    g = tfr.g
    for (s, t), r, d in zip(ref["pairs"], ref["reach"], ref["dist"]):
        assert r == oracle_reach(g, s, t)
        want = oracle_dist(g, s, t)
        assert d == (-1 if want is None else want)
    qa = tauto.build_query_automaton(REGEXES[1], int)
    for (s, t), a in zip(ref["pairs"], ref["rpq"][REGEXES[1]]):
        assert a == oracle_rpq(g, s, t, qa)


def test_loaded_reference_state_answers_the_same(ref):
    """A JAX-built fragmentation and cache, carried over as numpy arrays
    through ``Fragmentation.from_numpy`` + ``load_rvset_state``."""
    jfr = ref["jfr"]
    g = jfr.g
    fields = dict(n=g.n, src=g.src, dst=g.dst, labels=g.labels,
                  part=jfr.part, k=jfr.k, bnodes=jfr.bnodes,
                  b_index=jfr.b_index, n_max=jfr.n_max, e_max=jfr.e_max,
                  s_max=jfr.s_max, arrays=jfr.arrays,
                  frag_sizes=jfr.frag_sizes, owner_local=jfr.owner_local,
                  nb_cap=jfr.nb_cap)
    fr = Fragmentation.from_numpy(fields)
    state = {name: arr.copy() for name, arr in ref["state"].items()}
    cache = tcache.load_rvset_state(fr, state, CPU)
    assert fr.rvset_cache is cache
    # uploads copy: scribbling on the host buffers changes nothing
    for arr in state.values():
        arr[...] = 0
    _check_state(cache, ref["state"])
    _check_answers(fr, ref)


def test_uploads_do_not_alias_host_arrays():
    _, tfr = _fragmentations(CASES[0])
    cache = tcache.prepare_rvset_cache(tfr, CPU)
    for name, arr in tfr.arrays.items():
        assert not np.shares_memory(cache.arrays[name].numpy(), arr), name


def test_cache_stays_on_its_device():
    _, tfr = _fragmentations(CASES[0])
    tcache.prepare_rvset_cache(tfr, CPU)
    with pytest.raises(ValueError, match="lives on cpu"):
        tcache.prepare_rvset_cache(tfr, torch.device("meta"))


def test_product_closures_are_lru_bounded(monkeypatch):
    monkeypatch.setattr(tcache, "MAX_RPQ_CLOSURES", 2)
    _, tfr = _fragmentations(CASES[0])
    autos = [tauto.build_query_automaton(rx, int)
             for rx in ("0*", "1*", "2*")]
    keys = [qa.cache_key() for qa in autos]
    tcache.product_closure(tfr, autos[0], CPU)
    tcache.product_closure(tfr, autos[1], CPU)
    first = tcache.product_closure(tfr, autos[0], CPU)    # hit: now MRU
    tcache.product_closure(tfr, autos[2], CPU)            # evicts "1*"
    assert list(tfr.rvset_cache.rpq_closures) == [keys[0], keys[2]]
    assert tfr.rvset_cache.rpq_closures[keys[0]] is first


def test_empty_batches():
    _, tfr = _fragmentations(CASES[0])
    assert tcache.dis_reach_batch(tfr, np.zeros((0, 2)), CPU).shape == (0,)
    assert tcache.dis_dist_batch(tfr, np.zeros((0, 2)), CPU).dtype == np.int64
    assert tcache.dis_dist_batch(tfr, np.zeros((0, 2)), CPU, bound=1).dtype == bool
    with pytest.raises(ValueError):
        tcache.dis_reach_batch(tfr, [1, 2, 3], CPU)
