"""The or-and product and evalDG's D on the CPU: ``x | or_and_matmul(x,
D)`` against the JAX package's (its Pallas kernel in interpret mode, as
tests/test_kernels.py runs it), ``or_and_matmul`` at every shape the query
paths launch, scaled down, on the layout each path builds, against the
JAX package's ``or_and_matmul``, the zero-padded D that every path hands
to evalDG, and the copy counter.

evalDG's fixpoint reads D as it is stored, rows 16 bytes apart; on the CPU
the wrappers take the plain versions, and these tests reach the layout
and the counts around it.  The kernels themselves are held against the
same results by tests/test_torch_gpu.py on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import build_query_automaton as j_automaton
from repro.core import engine as jengine
from repro.core import fragment_graph as j_fragment
from repro.core import session as jsession
from repro.graph import erdos_renyi as j_er
from repro.graph import random_partition as j_random_partition
from repro.kernels.bool_matmul import bool_matmul, bool_matmul_ref
from repro.kernels.bool_matmul import or_and_matmul as j_or_and_matmul
from repro_torch.core import automaton as tauto
from repro_torch.core import bes as tbes
from repro_torch.core import distributed as tdist
from repro_torch.core import engine as tengine
from repro_torch.core import session as tsession
from repro_torch.core.cache import NO_NODE
from repro_torch.core.fragments import fragment_graph
from repro_torch.core.mapreduce import mr_drpq
from repro_torch.graph import erdos_renyi, random_partition
from repro_torch.kernels.bool_matmul import ops as bops
from repro_torch.kernels.bool_matmul import (is_kmajor, kmajor, kmajor_copy,
                                             or_and_matmul, or_and_matmul_nt,
                                             padded, padded_zeros, pitch,
                                             rows_aligned)

SKINNY_M = [1, 2, 3, 8]
# ragged K and N around the 16-byte column groups and the 128-row chunks
SKINNY_KN = [(0, 5), (31, 1), (32, 15), (33, 16), (129, 17), (200, 1037)]
REGEX = "(0|1)* 2"


def _storage(x):
    """The [rows, pitch] storage behind a padded view."""
    return x.as_strided((x.shape[0], x.stride(0)), (x.stride(0), 1))


def _frontiers(rng, m, k):
    one_hot = np.zeros((m, k), dtype=bool)
    if k:
        one_hot[np.arange(m), rng.integers(0, k, m)] = True
    return {"zero": np.zeros((m, k), dtype=bool), "one_hot": one_hot,
            "ones": np.ones((m, k), dtype=bool),
            "random": rng.random((m, k)) < 0.1}


@pytest.mark.parametrize("kn", SKINNY_KN, ids=str)
@pytest.mark.parametrize("m", SKINNY_M)
def test_or_and_init_matches_pallas(m, kn):
    """init | or_and_matmul(a, b) on the CPU == the JAX package's
    init | bool_matmul(a, b), for each kind of frontier, with and without
    init, on b as a padded view and as a plain tensor and a as a strided
    view; the CPU launches nothing."""
    k, n = kn
    rng = np.random.default_rng([m, k, n])
    b = rng.random((k, n)) < 0.1
    init = rng.random((m, n)) < 0.3
    jax_fn = bool_matmul if k else bool_matmul_ref   # Pallas needs K > 0
    tb = torch.tensor(b)
    for name, x in _frontiers(rng, m, k).items():
        prod = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(b)))
        a = torch.tensor(x.T.copy()).T                 # column-major view
        for layout in (tb, padded_zeros(k, n, "cpu").copy_(tb)):
            before = bops.launches
            for given, want in ((None, prod), (init, prod | init)):
                got = or_and_matmul(a, layout)
                if given is not None:
                    got = torch.tensor(given) | got
                assert got.dtype == torch.bool and got.shape == (m, n)
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=name)
            assert bops.launches == before


# (name, M, K, N, the layout of b) of every or-and product the query paths
# launch, scaled down from nb = 16039 (16103 with the dynamic phase's
# reserves), B = nb + 2 and the RPQ side B * Q = 80205 to nb = 160, B =
# 162 and B * Q = 810: evalDG's D zero-padded as the paths make it
# (padded_zeros) or plain, and a closure or its transpose as the products
# keep it, K-major (b^T a padded copy)
PATH_SHAPES = [
    ("evalDG step, one-shot and sharded reach", 1, 162, 162, "padded"),
    ("evalDG step, one-shot RPQ and MR reducer", 1, 810, 810, "padded"),
    ("closure squaring", 160, 160, 160, "kmajor"),
    ("batch compose", 256, 160, 160, "kmajor"),
    ("rank update T", 64, 224, 224, "kmajor"),
    ("rank update left", 224, 64, 64, "kmajor"),
    ("rank update P", 224, 64, 224, "kmajor"),
    ("evalDG step on an unpadded D", 1, 162, 162, "plain"),
]


@pytest.mark.parametrize("shape", PATH_SHAPES, ids=lambda s: s[0])
def test_route_of_each_path_shape(shape):
    """or_and_matmul(a, b) on the CPU, at each path's shape scaled down and
    on b in the layout that path builds, == the JAX package's
    or_and_matmul, with no launch and no copy."""
    name, m, k, n, layout = shape
    rng = np.random.default_rng([m, k, n])
    a = rng.random((m, k)) < (1.0 if m == 1 else 0.05)
    b = rng.random((k, n)) < 2.5 / k
    tb = torch.tensor(b)
    if layout == "padded":
        tb = padded_zeros(k, n, "cpu").copy_(tb)
        assert rows_aligned(tb)
    elif layout == "kmajor":
        tb = kmajor_copy(tb.T).T
        assert is_kmajor(tb.T)
    want = np.asarray(j_or_and_matmul(jnp.asarray(a), jnp.asarray(b)))
    before = (bops.launches, bops.copies)
    got = or_and_matmul(torch.tensor(a), tb)
    assert (bops.launches, bops.copies) == before, name
    assert got.dtype == torch.bool and got.shape == (m, n), name
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_rows_aligned_is_the_skinny_layout():
    """rows_aligned: the layout in which evalDG's fixpoint reads D as it is
    stored."""
    assert rows_aligned(padded_zeros(5, 17, "cpu"))
    assert rows_aligned(torch.zeros((3, 32), dtype=torch.bool))
    assert not rows_aligned(torch.zeros((3, 17), dtype=torch.bool))
    assert not rows_aligned(padded_zeros(5, 40, "cpu")[:, 1:])   # base + 1
    assert not rows_aligned(padded_zeros(5, 40, "cpu").T)
    z = padded_zeros(4, 17, "cpu")
    assert z.stride() == (pitch(17), 1) and not _storage(z).any()
    # rows 16 bytes apart, but the last row's last 16-byte group would read
    # past the storage
    flat = torch.zeros(2 * 32 + 17, dtype=torch.bool)
    assert is_kmajor(flat.as_strided((3, 17), (32, 1)))
    assert not rows_aligned(flat.as_strided((3, 17), (32, 1)))
    assert rows_aligned(flat.as_strided((2, 17), (32, 1)))


# ---------------------------------------------------------------------------
# every producer of evalDG's D makes it zero-padded
# ---------------------------------------------------------------------------

def _fragmentations(seed=1, n=36, m=110, k=4):
    jg = j_er(n, m, n_labels=4, seed=seed)
    tg = erdos_renyi(n, m, n_labels=4, seed=seed)
    return (j_fragment(jg, j_random_partition(jg, k, seed), k),
            fragment_graph(tg, random_partition(tg, k, seed), k))


def _pairs(fr, count=3):
    rng = np.random.default_rng(7)
    pairs = rng.integers(0, fr.g.n, size=(count, 2))
    return [(int(s), int(t)) for s, t in pairs if s != t]


def _assert_padded(D, side, want, what):
    assert D.shape == (side, side), what
    assert D.stride() == (pitch(side), 1), what
    assert rows_aligned(D), what
    assert not _storage(D)[:, side:].any(), what        # zero pads
    np.testing.assert_array_equal(D.numpy(), want, err_msg=what)


@pytest.fixture
def kept_d(monkeypatch):
    """Every D that reaches engine.evaldg_reach, in call order."""
    seen = []
    orig = tengine.evaldg_reach

    def keep(D, src, tgt):
        seen.append(D)
        return orig(D, src, tgt)

    monkeypatch.setattr(tengine, "evaldg_reach", keep)
    return seen


def test_exec_reach_and_rpq_make_d_padded(kept_d):
    """exec_reach's D and regular_rvset's (exec_rpq's) D: zero-padded,
    with the JAX package's values."""
    jfr, tfr = _fragmentations()
    jqa = j_automaton(REGEX, int)
    tqa = tauto.build_query_automaton(REGEX, int)
    Q = tqa.n_states
    for s, t in _pairs(tfr):
        want = jsession.exec_reach(jfr, s, t, return_matrix=True)
        got = tsession.exec_reach(tfr, s, t, return_matrix=True,
                                  device="cpu")
        assert got.answer == want.answer
        _assert_padded(kept_d[-1], tfr.B, np.asarray(want.dependency_matrix),
                       f"exec_reach {s, t}")
        want = jsession.exec_rpq(jfr, s, t, jqa, return_matrix=True)
        got = tsession.exec_rpq(tfr, s, t, tqa, return_matrix=True,
                                device="cpu")
        assert got.answer == want.answer
        _assert_padded(kept_d[-1], tfr.B * Q, np.asarray(want.dependency_matrix),
                       f"exec_rpq {s, t}")


def test_regular_rvset_is_padded():
    """regular_rvset (the one-shot RPQ's D, and the closure and sharded
    batch's d0 built from it) at a side that is not a multiple of 16."""
    _, tfr = _fragmentations()
    tqa = tauto.build_query_automaton(REGEX, int)
    Q = tqa.n_states
    side = tfr.n_boundary * Q
    assert side % 16
    arrs = {name: torch.tensor(v) for name, v in tfr.arrays.items()}
    no_slot = torch.full((tfr.k,), tfr.n_max, dtype=torch.int32)
    D = tengine.regular_rvset(
        arrs["esrc"], arrs["edst"], arrs["src_local"], arrs["src_row"],
        arrs["tgt_local"], arrs["labels"], arrs["gids"],
        torch.tensor(tqa.state_labels), torch.tensor(tqa.trans), no_slot,
        no_slot, NO_NODE, NO_NODE, n_max=tfr.n_max, B=tfr.B, side=side)
    assert D.stride() == (pitch(side), 1) and rows_aligned(D)
    assert not _storage(D)[:, side:].any()
    C, Ct = tbes.bool_closure_kmajor(D)
    C2, _ = tbes.bool_closure_kmajor(D.contiguous())
    assert torch.equal(C, C2) and torch.equal(Ct, C2.T)


def test_mr_drpq_makes_d_padded(kept_d):
    """mr_drpq's reducer D: zero-padded, equal to the one-shot RPQ's D."""
    jfr, tfr = _fragmentations()
    jqa = j_automaton(REGEX, int)
    tqa = tauto.build_query_automaton(REGEX, int)
    for s, t in _pairs(tfr):
        res = mr_drpq(tfr, s, t, tqa, device="cpu")
        want = jsession.exec_rpq(jfr, s, t, jqa, return_matrix=True)
        assert res.answer == want.answer
        _assert_padded(kept_d[-1], tfr.B * tqa.n_states,
                       np.asarray(want.dependency_matrix), f"mr_drpq {s, t}")


@pytest.fixture
def gloo_rank(tmp_path):
    """A one-rank gloo process group on a FileStore, destroyed after."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_sharded_one_shot_makes_d_padded(gloo_rank, kept_d):
    """dis_reach_sharded and dis_rpq_sharded on a one-rank gloo group hand
    evalDG the merged D zero-padded, with the JAX package's values; the
    returned D too."""
    jfr, tfr = _fragmentations()
    jqa = j_automaton(REGEX, int)
    tqa = tauto.build_query_automaton(REGEX, int)
    for s, t in _pairs(tfr):
        want = jsession.exec_reach(jfr, s, t, return_matrix=True)
        ans, D = tdist.dis_reach_sharded(tfr, s, t, device="cpu")
        assert ans == want.answer
        np.testing.assert_array_equal(D, np.asarray(want.dependency_matrix))
        _assert_padded(kept_d[-1], tfr.B, np.asarray(want.dependency_matrix),
                       f"dis_reach_sharded {s, t}")
        want = jsession.exec_rpq(jfr, s, t, jqa, return_matrix=True)
        assert tdist.dis_rpq_sharded(tfr, s, t, tqa, device="cpu") == \
            want.answer
        _assert_padded(kept_d[-1], tfr.B * tqa.n_states,
                       np.asarray(want.dependency_matrix), f"dis_rpq_sharded {s, t}")


@pytest.mark.parametrize("side", [1, 17, 40])
def test_merge_boolean_returns_padded(gloo_rank, side):
    """_merge_boolean turns any rank's matrix, contiguous or padded, into
    the same values in zero-padded storage."""
    rng = np.random.default_rng(side)
    D = rng.random((side, side)) < 0.2
    for given in (torch.tensor(D), padded_zeros(side, side, "cpu").copy_(
            torch.tensor(D))):
        tdist.collectives = 0
        _assert_padded(tdist._merge_boolean(given, None), side, D,
                       f"_merge_boolean {side}")
        assert tdist.collectives == 1


# ---------------------------------------------------------------------------
# evalDG and the copy counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,density", [(1, 1.0), (17, 0.1), (70, 0.03)])
def test_evaldg_on_padded_and_plain_d(B, density):
    """evaldg_reach on D padded and unpadded == JAX's evaldg_reach, with
    no copy made."""
    rng = np.random.default_rng([B, 3])
    D = rng.random((B, B)) < density
    for trial in range(4):
        src = rng.random(B) < (0.0 if trial == 3 else 0.1)
        src[rng.integers(B)] = trial != 3
        tgt = rng.random(B) < 0.3
        want = bool(jengine.evaldg_reach(jnp.asarray(D), jnp.asarray(src),
                                         jnp.asarray(tgt)))
        before = bops.copies
        for Dm in (torch.tensor(D),
                   padded_zeros(B, B, "cpu").copy_(torch.tensor(D))):
            assert tengine.evaldg_reach(Dm, torch.tensor(src),
                                        torch.tensor(tgt)) is want
        assert bops.copies == before


def test_copies_counts_each_kmajor_copy():
    """copies rises by one for each kmajor_copy, also through kmajor and
    the closure's two copies, and for nothing else."""
    x = torch.tensor(np.random.default_rng(5).random((9, 20)) < 0.3)
    bops.copies = 0
    kmajor_copy(x)
    kmajor_copy(x.T)
    assert bops.copies == 2
    k = kmajor(x)                           # pitch 20: copied
    assert bops.copies == 3 and is_kmajor(k)
    assert kmajor(k) is k and bops.copies == 3
    padded(4, 5, "cpu")
    padded_zeros(4, 5, "cpu")
    or_and_matmul(x[:1], x.T.contiguous())
    or_and_matmul_nt(x, x)
    assert bops.copies == 3
    tbes.bool_closure_kmajor(torch.zeros((6, 6), dtype=torch.bool))
    assert bops.copies == 5                 # D and D^T, once each
