"""evalDG's reach fixpoint, ``or_and_fixpoint``, and its dist answer by
levels, ``min_plus_settle``, on the CPU: their plain versions (and the
plain Bellman-Ford fixpoint ``min_plus_fixpoint_ref``, the settle
kernel's oracle) against the JAX package's ``evaldg_reach`` /
``evaldg_dist`` (the answer exact, the steps equal to a count of the
reference's ``while_loop`` steps, the bound applied), numpy models of the
kernels' schedules (each fixpoint step reads only the rows the step before
added; the settle kernel's three lists read each row once, in order of
distance) against the naive iterate and the plain version, the launch
plans ``_fixpoint_route`` and ``_settle_route`` as pure functions, and the
one-shot queries through both packages.

On the card each is one cooperative launch whose steps never return to
the host; the kernels are held against the same plain versions by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import fragment_graph as j_fragment
from repro.core import session as jsession
from repro.graph import labeled_chain_graph as j_chain
from repro.graph import random_partition as j_random_partition
from repro_torch.core import distributed as tdist
from repro_torch.core import engine as tengine
from repro_torch.core import session as tsession
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import labeled_chain_graph, random_partition
from repro_torch.kernels import _fixpoint
from repro_torch.kernels.bool_matmul import ops as bops
from repro_torch.kernels.bool_matmul import (or_and_fixpoint,
                                             or_and_fixpoint_ref,
                                             padded_zeros)
from repro_torch.kernels.tropical_matmul import ops as tops
from repro_torch.kernels.tropical_matmul import (INF, min_plus_fixpoint_ref,
                                                 min_plus_settle,
                                                 min_plus_settle_ref)
from repro_torch import tracing
from repro_torch.graph import erdos_renyi


# ---------------------------------------------------------------------------
# inputs and the reference's step counts, in numpy
# ---------------------------------------------------------------------------

def _chain_adjacency(n_chain=40, seed=3):
    """The adjacency of a labelled chain in noise: a long diameter."""
    g = labeled_chain_graph(n_chain, 10, 8, chain_label=1, seed=seed)
    adj = np.zeros((g.n, g.n), dtype=bool)
    adj[g.src, g.dst] = True
    return adj


def _weights(rng, adj, top):
    """W with the entries of ``adj`` drawn from 0..top, INF elsewhere."""
    return np.where(adj, rng.integers(0, top + 1, adj.shape),
                    INF).astype(np.int32)


def _inputs(kind, B, seed):
    """(D, W) of one kind of dependency matrix."""
    rng = np.random.default_rng([seed, B])
    if kind == "chain":
        D = _chain_adjacency(seed=seed)
        return D, _weights(rng, D, 3)
    density = {"random": 2.5 / B, "mostly_inf": 0.5 / B,
               "capped": 3.0 / B}[kind]
    D = rng.random((B, B)) < density
    # capped: every entry at most the bound 2, as a bounded query's
    # localEval leaves them
    W = _weights(rng, rng.random((B, B)) < density,
                 2 if kind == "capped" else 6)
    return D, W


def _sources(rng, B):
    """(name, src, tgt): one source, none, and one that already covers the
    target."""
    one = np.zeros(B, dtype=bool)
    one[rng.integers(B)] = True
    tgt = rng.random(B) < 0.2
    tgt[rng.integers(B)] = True
    covering = one | tgt
    return [("one", one, tgt), ("empty", np.zeros(B, dtype=bool), tgt),
            ("covering", covering, tgt)]


def _naive_reach(D, x0):
    """The reference's iterates x_0, x_1, ...: one product a step until a
    step changes nothing (that step's iterate included); none past x_0
    when x_0 is empty, as its while_loop's first test fails."""
    its = [x0.copy()]
    if not x0.any():
        return its
    Di = D.astype(np.int64)
    while True:
        nxt = its[-1] | ((its[-1].astype(np.int64) @ Di) > 0)
        its.append(nxt)
        if (nxt == its[-2]).all():
            return its


def _naive_dist(W, d0):
    its = [np.minimum(d0.astype(np.int64), INF)]
    if not (its[0] < INF).any():
        return its
    W64 = W.astype(np.int64)
    while True:
        d = its[-1]
        nxt = np.minimum(d, np.minimum((d[:, None] + W64).min(axis=0), INF))
        its.append(nxt)
        if (nxt == d).all():
            return its


def _delta_reach(D, x0):
    """The or-and kernel's schedule: each step ORs into x only the rows of
    D that the step before added to x (all of x0 at the first step), until
    a step adds none."""
    x = x0.copy()
    delta = x0.copy()
    its = [x.copy()]
    while delta.any():
        nxt = x | D[delta].any(axis=0)
        delta = nxt & ~x
        x = nxt
        its.append(x.copy())
    return its


def _settle_lists(W, d0, tgt, bound):
    """The settle kernel's schedule, list for list: lists E, Z and X whose
    roles rotate; a round expands the listed rows of E whose d is the level
    L, then a fold over every column lists into Z the columns that fell to
    L, into X those whose d is T (every one in a level's first round, those
    that fell to T after) and keeps the least d at or above T and tmin.
    Returns (answer, levels, reads a row)."""
    B = len(d0)
    top = INF if bound is None else min(bound, INF)
    W64 = W.astype(np.int64)
    d = np.minimum(d0.astype(np.int64), INF)
    reads = np.zeros(B, dtype=np.int64)
    lists = [list(np.nonzero(d == 0)[0]), [], []]
    e, z, x = 2, 1, 0
    L, T, levels, every = -1, 0, 0, True
    nxt = int(d.min()) if B else INF
    tmin = int(d[tgt].min()) if tgt.any() else INF
    while True:
        old = e
        if lists[z]:
            e, z, every = z, old, False
        else:
            if tmin <= nxt or nxt > top:
                break
            if nxt == T:
                e, x, L, T = x, old, T, T + 1
                levels += 1
            else:
                e, z, T = z, old, nxt
            every = True
        rows, lists[old] = lists[e], []
        acc = np.full(B, INF, dtype=np.int64)
        for k in rows:
            if d[k] == L:
                reads[k] += 1
                acc = np.minimum(acc, L + W64[k])
        fell = acc < d
        d = np.minimum(d, acc)
        lists[z] += list(np.nonzero(fell & (d == L))[0])
        lists[x] += list(np.nonzero((d == T) & (every | fell))[0])
        nxt = int(d[d >= T].min()) if (d >= T).any() else INF
        if (fell & tgt).any():
            tmin = min(tmin, int(d[fell & tgt].min()))
    return (tmin if tmin <= top else INF), levels, reads


def _settled_rows(d, levels):
    """Rows whose final distance is one of the ``levels`` least distinct
    finite values of d: the rows a search in order of distance that settled
    that many levels has read, each once."""
    finite = np.unique(d[d < INF])
    stop = finite[levels] if levels < len(finite) else INF
    return int((d < stop).sum())


KINDS = [("random", 9), ("random", 70), ("mostly_inf", 40), ("capped", 33),
         ("chain", 0), ("random", 2)]

#: the bounds the settle tests apply: none, 0, 1, the cell's 6, and one past
#: INF
BOUNDS = [None, 0, 1, 6, 1 << 40]


# ---------------------------------------------------------------------------
# the plain fixpoints against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,B", KINDS, ids=lambda v: str(v))
def test_plain_fixpoints_match_reference(kind, B):
    """or_and_fixpoint_ref / min_plus_fixpoint_ref: the answer onto the
    target equal to JAX's evaldg_reach / evaldg_dist, x and d equal to the
    reference's fixpoint, and the steps equal to its while_loop's."""
    D, W = _inputs(kind, B, seed=B + 1)
    B = D.shape[0]
    for name, src, tgt in _sources(np.random.default_rng(B), B):
        want = bool(jengine.evaldg_reach(jnp.asarray(D), jnp.asarray(src),
                                         jnp.asarray(tgt)))
        x, steps = or_and_fixpoint_ref(torch.tensor(src), torch.tensor(D))
        its = _naive_reach(D, src)
        assert steps.dtype == torch.int32 and steps.dim() == 0, name
        assert int(steps) == len(its) - 1, name
        np.testing.assert_array_equal(x.numpy(), its[-1], err_msg=name)
        assert bool((x & torch.tensor(tgt)).any()) is want, name
        if name == "covering":
            assert want

        want = int(jengine.evaldg_dist(jnp.asarray(W), jnp.asarray(src),
                                       jnp.asarray(tgt)))
        d0 = np.where(src, 0, INF).astype(np.int32)
        d, steps = min_plus_fixpoint_ref(torch.tensor(d0), torch.tensor(W))
        its = _naive_dist(W, d0)
        assert int(steps) == len(its) - 1, name
        np.testing.assert_array_equal(d.numpy(), its[-1], err_msg=name)
        assert int(torch.where(torch.tensor(tgt), d, INF).min()) == want, name
        if name == "empty":
            assert int(steps) == 0 and want == INF


@pytest.mark.parametrize("kind,B", KINDS, ids=lambda v: str(v))
def test_engine_evaldg_matches_reference(kind, B):
    """engine.evaldg_reach / evaldg_dist on the CPU (the wrappers' plain
    path), on D and W as they are and in padded storage, equal to JAX's."""
    D, W = _inputs(kind, B, seed=B + 2)
    B = D.shape[0]
    for name, src, tgt in _sources(np.random.default_rng(B + 5), B):
        args = [jnp.asarray(src), jnp.asarray(tgt)]
        want = bool(jengine.evaldg_reach(jnp.asarray(D), *args))
        for Dm in (torch.tensor(D),
                   padded_zeros(B, B, "cpu").copy_(torch.tensor(D))):
            assert tengine.evaldg_reach(Dm, torch.tensor(src),
                                        torch.tensor(tgt)) is want, name
        want = int(jengine.evaldg_dist(jnp.asarray(W), *args))
        for Wm in (torch.tensor(W),
                   tops.padded_i32(B, B, "cpu").copy_(torch.tensor(W))):
            assert tengine.evaldg_dist(Wm, torch.tensor(src),
                                       torch.tensor(tgt)) == want, name


# ---------------------------------------------------------------------------
# the dist answer by levels, with a bound
# ---------------------------------------------------------------------------

def _settle_cases(kind, B, seed):
    """(name, W, d0, tgt): the kind's W (zero entries among its weights) and
    the same W with every weight tripled, so that levels go empty; from one
    source, none, one that covers a target, and several finite starts; with
    the targets drawn, unreachable, or the source's own row."""
    _, W = _inputs(kind, B, seed)
    B = W.shape[0]
    rng = np.random.default_rng(seed + 11)
    gaps = np.where(W < INF, 3 * W, INF).astype(np.int32)
    out = []
    for wname, Wm in (("w", W), ("gaps", gaps)):
        for name, src, tgt in _sources(rng, B):
            d0 = np.where(src, 0, INF).astype(np.int32)
            out.append((f"{wname} {name}", Wm, d0, tgt))
        src = np.zeros(B, dtype=bool)
        src[0] = True
        out.append((f"{wname} own row", Wm, np.where(src, 0, INF).astype(
            np.int32), src.copy()))
        reach = _naive_dist(Wm, np.where(src, 0, INF).astype(np.int32))[-1]
        out.append((f"{wname} unreachable", Wm,
                    np.where(src, 0, INF).astype(np.int32), reach >= INF))
        starts = np.full(B, INF, dtype=np.int32)
        starts[rng.random(B) < 0.2] = rng.integers(0, 9)
        out.append((f"{wname} starts", Wm, starts, rng.random(B) < 0.1))
    return out


@pytest.mark.parametrize("kind,B", KINDS, ids=lambda v: str(v))
def test_evaldg_dist_bounded_matches_reference(kind, B):
    """engine.evaldg_dist(..., bound=b) on the CPU, on W as it is and in
    padded storage, for b in None, 0, 1, 6 and past INF: JAX's evaldg_dist
    answer, INF where it is above the bound; zero entries of W, the
    source's own row as a target, unreachable targets and an all-INF d0
    among the cases."""
    for name, W, d0, tgt in _settle_cases(kind, B, seed=B + 4):
        src = d0 == 0
        if not src.any() or ((d0 > 0) & (d0 < INF)).any():
            continue        # evalDG starts at 0 on its sources, INF elsewhere
        want = int(jengine.evaldg_dist(jnp.asarray(W), jnp.asarray(src),
                                       jnp.asarray(tgt)))
        n = W.shape[0]
        for bound in BOUNDS:
            cut = want if bound is None or want <= bound else INF
            for Wm in (torch.tensor(W),
                       tops.padded_i32(n, n, "cpu").copy_(torch.tensor(W))):
                got = tengine.evaldg_dist(Wm, torch.tensor(src),
                                          torch.tensor(tgt), bound=bound)
                assert got == cut, (name, bound)
    src = np.zeros(W.shape[0], dtype=bool)
    want = int(jengine.evaldg_dist(jnp.asarray(W), jnp.asarray(src),
                                   jnp.asarray(~src)))
    for bound in BOUNDS:
        assert tengine.evaldg_dist(torch.tensor(W), torch.tensor(src),
                                   torch.tensor(~src), bound=bound) == \
            want == INF


@pytest.mark.parametrize("kind,B", KINDS, ids=lambda v: str(v))
def test_settle_plain_matches_fixpoint_and_reads_each_row_once(kind, B):
    """min_plus_settle_ref: its answer the plain fixpoint's least target
    distance with the bound applied; its rows those whose final distance
    lies below the level it stopped at, each read once; and its answer,
    levels and rows equal to the kernel's schedule, list for list, which
    reads no row twice."""
    for name, W, d0, tgt in _settle_cases(kind, B, seed=B + 5):
        d, _ = min_plus_fixpoint_ref(torch.tensor(d0), torch.tensor(W))
        d = d.numpy()
        least = int(d[tgt].min()) if tgt.any() else INF
        for bound in BOUNDS:
            state = min_plus_settle_ref(torch.tensor(d0), torch.tensor(W),
                                        torch.tensor(tgt), bound)
            assert state.dtype == torch.int32 and state.shape == (3,)
            answer, levels, rows = state.tolist()
            cut = least if bound is None or least <= bound else INF
            assert answer == cut, (name, bound)
            assert rows == _settled_rows(d, levels), (name, bound)
            got, got_levels, reads = _settle_lists(W, d0, tgt, bound)
            assert (got, got_levels, int(reads.sum())) == \
                (answer, levels, rows), (name, bound)
            assert reads.max(initial=0) <= 1, (name, bound)


def test_settle_stops_at_the_target_and_the_bound():
    """A chain of 1024 nodes: the search settles one node a level, up to
    the target or past the bound, and no further; with no target it reads
    every reachable row once."""
    B = 1024
    W = np.full((B, B), INF, dtype=np.int32)
    W[np.arange(B - 1), np.arange(1, B)] = 1
    d0 = torch.full((B,), INF, dtype=torch.int32)
    d0[0] = 0
    tgt = torch.zeros(B, dtype=torch.bool)
    tgt[40] = True
    cases = [(None, [40, 40, 40]), (6, [INF, 7, 7]), (40, [40, 40, 40]),
             (39, [INF, 40, 40])]
    for bound, want in cases:
        assert min_plus_settle(d0, torch.tensor(W), tgt,
                               bound).tolist() == want, bound
    assert min_plus_settle(d0, torch.tensor(W), torch.zeros_like(tgt)
                           ).tolist() == [INF, B, B]


@pytest.mark.parametrize("bound", [None, 0, 1, 6])
def test_one_shot_dist_on_a_fragmented_graph(bound):
    """exec_dist on an erdos_renyi graph in 6 fragments: answers and
    distances equal to the JAX package's, and the traced evalDG counts the
    rows it read, at most B, and the levels it settled, at most the bound
    plus one."""
    from repro.graph import erdos_renyi as j_erdos_renyi
    jg = j_erdos_renyi(300, 900, n_labels=3, seed=12)
    tg = erdos_renyi(300, 900, n_labels=3, seed=12)
    jfr = j_fragment(jg, j_random_partition(jg, 6, 12), 6)
    tfr = fragment_graph(tg, random_partition(tg, 6, 12), 6)
    rng = np.random.default_rng(13)
    pairs = [tuple(int(v) for v in p) for p in rng.integers(0, 300, (6, 2))
             if p[0] != p[1]]
    for s, t in pairs:
        want = jsession.exec_dist(jfr, s, t, bound=bound)
        tracing.enable()
        try:
            got = tsession.exec_dist(tfr, s, t, bound=bound, device="cpu")
        finally:
            tracing.disable()
        assert (got.answer, got.distance) == (bool(want.answer),
                                              want.distance), (s, t)
        counts, = [r.counts for r in tracing.drain()
                   if r.kind == "span" and r.name == "oneshot.evaldg"]
        assert 0 < counts["evaldg.rows"] <= tfr.B, (s, t)
        assert 0 < counts["evaldg.levels"] <= (
            tfr.B if bound is None else bound + 1), (s, t)


# ---------------------------------------------------------------------------
# the kernels' schedule: only the rows the step before added
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,B", KINDS, ids=lambda v: str(v))
def test_delta_schedule_equals_naive_iterate(kind, B):
    """Reading only the new rows gives the naive loop's iterate at every
    step, and the same number of steps; every row of D enters the
    schedule's lists at most once."""
    D, _ = _inputs(kind, B, seed=B + 3)
    B = D.shape[0]
    rng = np.random.default_rng(B + 7)
    for name, src, _ in _sources(rng, B):
        naive, fast = _naive_reach(D, src), _delta_reach(D, src)
        assert len(naive) == len(fast), name
        for t, (a, b) in enumerate(zip(naive, fast)):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} step {t}")
        added = [fast[0]] + [b & ~a for a, b in zip(fast, fast[1:])]
        assert int(sum(a.sum() for a in added)) == int(fast[-1].sum())


def test_chain_takes_one_step_a_hop():
    """A chain of 1024 nodes: the fixpoint walks it one hop a step, 1023
    steps that add a node and the one that adds none; the plain versions
    agree with the reference's count."""
    B = 1024
    D = np.zeros((B, B), dtype=bool)
    D[np.arange(B - 1), np.arange(1, B)] = True
    W = np.where(D, 1, INF).astype(np.int32)
    src = np.zeros(B, dtype=bool)
    src[0] = True
    x, steps = or_and_fixpoint_ref(torch.tensor(src), torch.tensor(D))
    assert int(steps) == B and bool(x.all())
    assert len(_delta_reach(D, src)) - 1 == B
    d, steps = min_plus_fixpoint_ref(
        torch.tensor(np.where(src, 0, INF).astype(np.int32)),
        torch.tensor(W))
    assert int(steps) == B
    np.testing.assert_array_equal(d.numpy(), np.arange(B))


# ---------------------------------------------------------------------------
# the launch plan and the wrappers on the CPU
# ---------------------------------------------------------------------------

# (K = N) of the fixpoints the paths launch at full size: the one-shot and
# sharded reach and dist (B = nb + 2), the one-shot RPQ and the MR reducer
# (B Q), the benchmark's one-shot cell (er32k_k16_oneshot, nb = 32038),
# the baselines' chain, and the smallest B
PLAN_SIZES = [16041, 80205, 32040, 1026, 2, 1, 0]


def _plan(ops):
    """The grid function of each semiring's evalDG kernel: the or-and
    fixpoint's and the settle kernel's."""
    return bops._fixpoint_route if ops is bops else tops._settle_route


@pytest.mark.parametrize("ops", [bops, tops], ids=["or_and", "min_plus"])
@pytest.mark.parametrize("B", PLAN_SIZES)
def test_fixpoint_route_fits_the_card(ops, B):
    """The grid is co-resident (at most the SMs times the blocks each
    holds, and times MAX_PER_SM), at least one block, no more than one
    block for every MIN_ROWS rows in every strip, and the strips cover
    N."""
    width = ops.FIXPOINT_STRIP
    for sms, per_sm in ((132, 16), (132, 3), (132, None), (1, 1), (8, 2)):
        route = _plan(ops)(B, B, sms, per_sm)
        cap = _fixpoint.MAX_PER_SM if per_sm is None else per_sm
        assert 1 <= route.blocks <= sms * min(cap, _fixpoint.MAX_PER_SM)
        assert route.strips * width >= max(B, 1)
        assert (route.strips - 1) * width < max(B, 1)
        rows = max(1, -(-B // _fixpoint.MIN_ROWS))
        assert route.blocks <= rows * route.strips


def test_fixpoint_route_small_and_full():
    """B = 2 and K = 0 take one block; the one-shot B fills the card's
    slots; the chain's B stays a few blocks, so its thousand steps wait
    at small barriers."""
    for plan in (bops._fixpoint_route, tops._settle_route):
        assert plan(2, 2) == _fixpoint.FixRoute(1, 1)
        assert plan(0, 0) == _fixpoint.FixRoute(1, 1)
        assert plan(0, 5000).blocks == plan(0, 5000).strips
        assert plan(16041, 16041, 132, 16).blocks == \
            132 * _fixpoint.MAX_PER_SM
    assert bops._fixpoint_route(1026, 1026) == _fixpoint.FixRoute(33, 1)
    assert tops._settle_route(1026, 1026) == _fixpoint.FixRoute(99, 3)


def test_wrappers_on_cpu_are_the_plain_versions():
    """On CPU tensors the wrappers return the plain versions' results
    (x / d and a 0-d int32 steps tensor; the settle state), launch nothing
    and copy nothing, whatever D's and W's layout."""
    D, W = _inputs("random", 37, seed=11)
    src = np.zeros(37, dtype=bool)
    src[4] = True
    d0 = torch.tensor(np.where(src, 0, INF).astype(np.int32))
    counts = (bops.fixpoint_launches, bops.launches, bops.copies,
              tops.settle_launches, tops.launches, tops.copies)
    for Dm in (torch.tensor(D), torch.tensor(D.T.copy()).T,
               padded_zeros(37, 37, "cpu").copy_(torch.tensor(D))):
        got, want = or_and_fixpoint(torch.tensor(src), Dm), \
            or_and_fixpoint_ref(torch.tensor(src), torch.tensor(D))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[1].dtype == torch.int32 and got[1].dim() == 0
    for Wm in (torch.tensor(W), torch.tensor(W.T.copy()).T):
        tgt = torch.arange(37) % 5 == 2
        for bound in (None, 2):
            assert torch.equal(min_plus_settle(d0, Wm, tgt, bound),
                               min_plus_settle_ref(d0, torch.tensor(W), tgt,
                                                   bound))
    assert counts == (bops.fixpoint_launches, bops.launches, bops.copies,
                      tops.settle_launches, tops.launches, tops.copies)


def test_wrappers_reject_bad_operands():
    D = torch.zeros((4, 4), dtype=torch.bool)
    with pytest.raises(TypeError, match="bool"):
        or_and_fixpoint(torch.zeros(4, dtype=torch.uint8), D)
    with pytest.raises(ValueError, match=r"x0 \[B\] and D \[B, B\]"):
        or_and_fixpoint(torch.zeros(5, dtype=torch.bool), D)
    with pytest.raises(ValueError, match=r"x0 \[B\] and D \[B, B\]"):
        or_and_fixpoint(torch.zeros(4, dtype=torch.bool), D[:, :3])
    W = torch.full((4, 4), INF, dtype=torch.int32)
    d0 = torch.zeros(4, dtype=torch.int32)
    tgt = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError, match="int32"):
        min_plus_settle(d0.long(), W, tgt)
    with pytest.raises(TypeError, match="bool tgt"):
        min_plus_settle(d0, W, tgt.int())
    with pytest.raises(ValueError, match=r"tgt \[B\]"):
        min_plus_settle(d0, W, tgt[:3])
    with pytest.raises(ValueError, match=r"tgt \[B\]"):
        min_plus_settle(d0, W[:, :3], tgt)


def test_rows_copy_is_padded_and_counted():
    """rows_copy: the values in zero-padded storage the fixpoint reads as
    it is, one count in copies."""
    D = torch.tensor(np.random.default_rng(2).random((21, 21)) < 0.3)
    before = bops.copies
    got = bops.rows_copy(D)
    assert bops.copies == before + 1
    assert bops.rows_aligned(got) and torch.equal(got, D)
    assert not got.as_strided((21, got.stride(0)),
                              (got.stride(0), 1))[:, 21:].any()


def test_evaldg_marks_one_fixpoint():
    """Each evalDG is one fixpoint loop in the collective record, whether
    or not its source is empty, and issues no collective."""
    D, W = _inputs("random", 30, seed=4)
    src = torch.zeros(30, dtype=torch.bool)
    tgt = torch.ones(30, dtype=torch.bool)
    with tdist.record_collectives() as rec:
        tengine.evaldg_reach(torch.tensor(D), src, tgt)
        src[3] = True
        tengine.evaldg_reach(torch.tensor(D), src, tgt)
        tengine.evaldg_dist(torch.tensor(W), src, tgt)
    assert rec.fixpoints == 3 and rec.entries == []


# ---------------------------------------------------------------------------
# the one-shot queries through both packages
# ---------------------------------------------------------------------------

def _chain_fragmentations(k=4, seed=5):
    jg = j_chain(30, 20, 24, chain_label=1, n_labels=3, seed=seed)
    tg = labeled_chain_graph(30, 20, 24, chain_label=1, n_labels=3,
                             seed=seed)
    return (j_fragment(jg, j_random_partition(jg, k, seed), k),
            fragment_graph(tg, random_partition(tg, k, seed), k))


@pytest.mark.parametrize("bound", [None, 0, 2, 5])
def test_one_shot_queries_match_reference(bound):
    """exec_reach and exec_dist (bounded at 0, 2 and 5, and exact) on a
    chain in noise cut into 4 fragments: answers and distances equal to
    the JAX package's, the chain's ends included."""
    jfr, tfr = _chain_fragmentations()
    rng = np.random.default_rng(9)
    pairs = [(0, 29), (29, 0), (3, 17)]
    pairs += [tuple(int(v) for v in p) for p in rng.integers(0, 50, (6, 2))]
    for s, t in pairs:
        want = jsession.exec_dist(jfr, s, t, bound=bound)
        got = tsession.exec_dist(tfr, s, t, bound=bound, device="cpu")
        assert (got.answer, got.distance) == (bool(want.answer),
                                              want.distance), (s, t)
        if bound is None:
            want = jsession.exec_reach(jfr, s, t)
            got = tsession.exec_reach(tfr, s, t, device="cpu")
            assert got.answer == bool(want.answer), (s, t)
