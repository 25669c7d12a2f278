"""The rank update's last or-and product with its floor pair, on the CPU.

``or_and_floor_pair(a, b_t, C, Ct)`` returns
``(C | a b_t^T, Ct | (a b_t^T)^T)`` in fresh zero-padded storage
and leaves the floors as they were; ``core.incremental._rank_update_bool``
ends in that one call.  Both are held bit-equal (the semiring does not
round, so the tolerance is zero) to the JAX package on the same seeded
numpy inputs: the rank update to ``repro.core.incremental.
_rank_update_bool``, the product to ``bool_matmul`` (the Pallas kernel in
interpret mode, as the JAX package's own kernel tests run it), and one
insert-only ``apply_delta`` in the ``repair`` mode to the JAX package's
and to a rebuild's answers.  The card's kernel is held to the same plain
version in ``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GraphDelta as JDelta
from repro.core import apply_delta as j_apply
from repro.core import connect as j_connect
from repro.core import fragment_graph as j_fragment
from repro.core import prepare_rvset_cache as j_prepare
from repro.core.incremental import _rank_update_bool as j_rank_update_bool
from repro.graph import erdos_renyi as j_er
from repro.graph import random_partition as j_random_partition
from repro.kernels.bool_matmul.ops import bool_matmul as j_bool_matmul

import repro_torch
from repro_torch import Dist, GraphDelta, Reach
from repro_torch.core import bes, incremental
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import erdos_renyi, random_partition
from repro_torch.kernels.bool_matmul import (is_kmajor, or_and_floor_pair,
                                             or_and_floor_pair_ref, pitch)

RESERVE = dict(reserve_boundary=8, reserve_edges=24, reserve_stubs=12)


def _storage(x):
    """The padded [rows, pitch] storage behind a padded view."""
    return x.as_strided((x.shape[0], x.stride(0)), (x.stride(0), 1))


def _closure(rng, nb):
    """A seeded closure pair (C, C^T) of a sparse random graph, as the
    cache keeps it."""
    D = torch.tensor(rng.random((nb, nb)) < 1.5 / nb)
    return bes.bool_closure_kmajor(D)


def _floor_case(rng, m, k, n, density=0.05):
    a = rng.random((m, k)) < density
    b_t = rng.random((n, k)) < density
    C = rng.random((m, n)) < 0.1
    return a, b_t, C


@pytest.mark.parametrize("nb,r", [(50, 64), (300, 64), (1037, 128)])
def test_rank_update_bool_matches_jax(nb, r):
    """The port's rank update on the closure pair is bit-equal to the JAX
    package's on the same closure, rows and idx; C'^T equals C'.T, both
    outputs are padded with zero pads, and the old pair is unchanged."""
    rng = np.random.default_rng([nb, r])
    C, Ct = _closure(rng, nb)
    rows = rng.random((r, nb)) < 2.0 / nb
    idx = rng.choice(nb, size=r, replace=r > nb)
    old = (C.clone(), Ct.clone())
    C2, C2t = incremental._rank_update_bool(C, Ct, torch.tensor(rows), idx)
    want = np.asarray(j_rank_update_bool(jnp.asarray(C.numpy()),
                                         jnp.asarray(rows),
                                         jnp.asarray(idx)))
    np.testing.assert_array_equal(C2.numpy(), want)
    assert torch.equal(C2t, C2.T)
    for out, cols in ((C2, nb), (C2t, nb)):
        assert is_kmajor(out) and out.stride(0) == pitch(cols)
        assert not _storage(out)[:, cols:].any()
    assert torch.equal(C, old[0]) and torch.equal(Ct, old[1])
    # the update is monotone: C' holds C
    assert not (C & ~C2).any()


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (7, 64, 33), (130, 64, 200),
                                   (129, 65, 127), (64, 0, 17),
                                   (300, 129, 260)])
def test_floor_pair_matches_plain(m, k, n):
    """The fused call equals C | a b_t^T and its transpose, in fresh
    zero-padded storage; C and Ct are left as they were; the plain
    version (``or_and_floor_pair_ref``) gives the same pair."""
    rng = np.random.default_rng([m, k, n])
    a, b_t, C = _floor_case(rng, m, k, n)
    want = C | ((a.astype(np.float32) @ b_t.T.astype(np.float32)) > 0)
    ta, tb, tC = torch.tensor(a), torch.tensor(b_t), torch.tensor(C)
    tCt = tC.T.contiguous()
    old = (tC.clone(), tCt.clone())
    got, got_t = or_and_floor_pair(ta, tb, tC, tCt)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_t.numpy(), want.T)
    assert got.stride(0) == pitch(n) and got_t.stride(0) == pitch(m)
    assert not _storage(got)[:, n:].any()
    assert not _storage(got_t)[:, m:].any()
    assert torch.equal(tC, old[0]) and torch.equal(tCt, old[1])
    ref, ref_t = or_and_floor_pair_ref(ta, tb, tC, tCt)
    assert torch.equal(ref, got) and torch.equal(ref_t, got_t)


@pytest.mark.parametrize("m,k,n", [(130, 64, 200), (5, 70, 9)])
def test_floor_pair_matches_jax_pallas(m, k, n):
    """The fused call against the JAX package's Pallas kernel (interpret
    mode) ORed with the same floor."""
    rng = np.random.default_rng([m, k, n, 1])
    a, b_t, C = _floor_case(rng, m, k, n, density=0.1)
    want = C | np.asarray(j_bool_matmul(jnp.asarray(a), jnp.asarray(b_t.T)))
    got, got_t = or_and_floor_pair(torch.tensor(a), torch.tensor(b_t),
                                   torch.tensor(C), torch.tensor(C.T.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_t.numpy(), want.T)


def test_floor_pair_reads_each_floor_from_its_own_matrix():
    """init_t is used as given, not as init.T: with floors that are not
    transposes of each other each output takes its own."""
    rng = np.random.default_rng(5)
    a, b_t, C = _floor_case(rng, 40, 64, 40)
    Ct = rng.random((40, 40)) < 0.1
    P = (a.astype(np.float32) @ b_t.T.astype(np.float32)) > 0
    got, got_t = or_and_floor_pair(torch.tensor(a), torch.tensor(b_t),
                                   torch.tensor(C), torch.tensor(Ct))
    np.testing.assert_array_equal(got.numpy(), C | P)
    np.testing.assert_array_equal(got_t.numpy(), Ct | P.T)


def _bad_floor_calls():
    a = torch.zeros((6, 64), dtype=torch.bool)
    b_t = torch.zeros((9, 64), dtype=torch.bool)
    C = torch.zeros((6, 9), dtype=torch.bool)
    Ct = torch.zeros((9, 6), dtype=torch.bool)
    return {
        "init_without_init_t": (TypeError, (C,)),
        "init_wrong_shape": (ValueError, (Ct, Ct)),
        "init_t_wrong_shape": (ValueError, (C, C)),
        "init_wrong_dtype": (TypeError, (C.to(torch.uint8), Ct)),
        "init_t_wrong_dtype": (TypeError, (C, Ct.to(torch.int32))),
        "init_wrong_device": (ValueError, (C.to("meta"), Ct)),
        "init_t_wrong_device": (ValueError, (C, Ct.to("meta"))),
        "operand_wrong_dtype": (TypeError, (C, Ct), a.to(torch.uint8)),
    }, a, b_t


@pytest.mark.parametrize("case", sorted(_bad_floor_calls()[0]))
def test_floor_pair_argument_checks(case):
    """A floor pair that is incomplete, of the wrong shape, dtype or
    device, or a product that is not bool, raises."""
    calls, a, b_t = _bad_floor_calls()
    exc, floors, *left = calls[case]
    with pytest.raises(exc):
        or_and_floor_pair(left[0] if left else a, b_t, *floors)


def test_insert_only_repair_matches_jax_and_rebuild():
    """One insert-only delta inside a fragment that changes boundary rows:
    both packages take the ``repair`` mode with the same stats, the closure
    pair equals the JAX package's (C'^T = C'.T), and reach and dist
    answers equal the JAX package's and a rebuilt session's."""
    n, m, k, seed = 24, 40, 4, 7
    jg, tg = j_er(n, m, n_labels=3, seed=seed), erdos_renyi(n, m, n_labels=3,
                                                            seed=seed)
    jfr = j_fragment(jg, j_random_partition(jg, k, seed), k, **RESERVE)
    tfr = fragment_graph(tg, random_partition(tg, k, seed), k, **RESERVE)
    j_prepare(jfr, with_dist=True)
    sess = repro_torch.connect(tfr, device="cpu").warm(with_dist=True)
    cross = np.nonzero(tfr.part[tfr.g.src] != tfr.part[tfr.g.dst])[0]
    u = int(tfr.g.src[cross[0]])
    mine = np.nonzero(tfr.part == tfr.part[u])[0]
    v = int(next(x for x in mine if x != u))
    want = j_apply(jfr, JDelta(add_src=[v], add_dst=[u]))
    got = sess.apply(GraphDelta(add_src=[v], add_dst=[u]))
    assert got.mode == "repair" and got.changed_rows > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cache = tfr.rvset_cache
    np.testing.assert_array_equal(cache.closure.numpy(),
                                  np.asarray(jfr.rvset_cache.closure))
    assert torch.equal(cache.closure_t, cache.closure.T)
    rng = np.random.default_rng(seed)
    pairs = [(int(rng.integers(n)), int(rng.integers(n))) for _ in range(12)]
    queries = [Reach(s, t) for s, t in pairs] + [Dist(s, t) for s, t in pairs]
    answers = [(r.answer, r.distance) for r in sess.run(queries)]
    fresh = fragment_graph(tfr.g, tfr.part, tfr.k, **RESERVE)
    rebuilt = repro_torch.connect(fresh, device="cpu").run(queries)
    assert answers == [(r.answer, r.distance) for r in rebuilt]
    from repro.core import Dist as JDist
    from repro.core import Reach as JReach
    jq = [JReach(s, t) for s, t in pairs] + [JDist(s, t) for s, t in pairs]
    assert answers == [(r.answer, r.distance)
                       for r in j_connect(jfr).run(jq)]
