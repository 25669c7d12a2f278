"""The or-and kernel's skinny route on the CPU: ``or_and_matmul(a, b,
init=)`` against the JAX package's ``x | or_and_matmul(x, D)`` (its Pallas
kernel in interpret mode, as tests/test_kernels.py runs it), the route
choice at every shape the query paths launch, the zero-padded D that every
path hands to evalDG, and the copy counter.

The skinny route reads the right operand as it is stored, rows 16 bytes
apart; on the CPU the wrapper takes the plain version, and these tests
reach the layout, the route choice and the counts around it.  The kernel
itself is held against the same results by tests/test_torch_gpu.py on the
card.
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
    """or_and_matmul(a, b, init=) on the CPU == the JAX package's
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
                got = or_and_matmul(
                    a, layout, init=None if given is None
                    else torch.tensor(given))
                assert got.dtype == torch.bool and got.shape == (m, n)
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=name)
            assert bops.launches == before


def test_or_and_init_rejects_bad_init():
    a = torch.zeros((1, 3), dtype=torch.bool)
    b = torch.zeros((3, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="init must be bool"):
        or_and_matmul(a, b, init=torch.zeros((1, 5), dtype=torch.bool))
    with pytest.raises(ValueError, match="init must be bool"):
        or_and_matmul(a, b, init=torch.zeros((1, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="do not chain"):
        or_and_matmul(a, torch.zeros((4, 4), dtype=torch.bool))


# (name, M, K, N, b's rows 16 bytes apart) of every or-and product the
# query paths launch at full size: nb = 16039 (16103 with the dynamic
# phase's reserves), B = nb + 2, and the RPQ side B * Q = 80205
PATH_SHAPES = [
    ("evalDG step, one-shot and sharded reach", 1, 16041, 16041, True),
    ("evalDG step, one-shot RPQ and MR reducer", 1, 80205, 80205, True),
    ("closure squaring", 16039, 16039, 16039, True),
    ("batch compose", 256, 16039, 16039, True),
    ("rank update T", 64, 16103, 16103, True),
    ("rank update left", 16103, 64, 64, True),
    ("rank update P", 16103, 64, 16103, True),
    ("evalDG step on an unpadded D", 1, 16041, 16041, False),
]


@pytest.mark.parametrize("shape", PATH_SHAPES, ids=lambda s: s[0])
def test_route_of_each_path_shape(shape):
    """M = 1 on a padded D goes skinny, with every SM's block slots filled
    once by whole chunks of K and no empty split; every other product of
    the paths stays on the tile route."""
    name, m, k, n, aligned = shape
    route = bops._route(m, k, n, aligned)
    if m > bops.SKINNY_MAX_M or not aligned:
        assert route == bops.Route("tile"), name
        return
    assert route.kind == "skinny" and route.rows == 1, name
    strips = -(-n // (bops.SKINNY_THREADS * bops.SKINNY_COLS))
    chunks = -(-k // bops.SKINNY_THREADS)
    assert strips * route.split <= 132 * bops.PER_SM_GUESS[1]
    per = -(-chunks // route.split)
    assert (route.split - 1) * per < chunks <= route.split * per
    for per_sm in (1, 4, 16):
        again = bops._route(m, k, n, aligned, sms=132, per_sm=per_sm)
        assert strips * again.split <= max(132 * per_sm, strips)


def test_route_rows_and_splits():
    """Rows round up to a power of two up to 8; K = 0 takes one split; a
    narrow product splits K down to one chunk a block."""
    assert [bops._route(m, 640, 100, True).rows for m in range(1, 9)] == \
        [1, 2, 4, 4, 8, 8, 8, 8]
    assert bops._route(9, 640, 100, True).kind == "tile"
    assert bops._route(1, 0, 100, True) == bops.Route("skinny", 1, 1)
    assert bops._route(1, 640, 100, True, sms=132, per_sm=16).split == 5
    assert bops._route(1, 640, 100, True, sms=1, per_sm=2).split == 2
    # 5 chunks over 4 splits would leave the last block an empty range
    assert bops._route(1, 5 * 128, 100, True, sms=1, per_sm=4).split == 3


def test_rows_aligned_is_the_skinny_layout():
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
