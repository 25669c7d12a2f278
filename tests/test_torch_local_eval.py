"""The one-shot localEval written into the dependency matrix
(``engine.local_eval_reach`` / ``local_eval_dist`` with ``out=``, through
``kernels.local_eval`` on the card) on the CPU: the padded D or W it leaves
equals the ``(rows, block)`` row block written into a zero D (``D[rows] =
block``) or an INF W (``W.fill_(INF); W[rows] = block``), byte for byte
over the whole padded storage, so that rows no source owns and the pad
columns get the semiring zero.  Given W's row lists instead, each row
holds exactly the finite entries of the row block, and what does not fit
is flagged.  Also the kernel wrapper's refusals and its shared-memory
plan.  The kernels themselves are held to this path on the card in
tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.engine import INF
from repro_torch.core.fragments import fragment_graph, query_slots
from repro_torch.graph import erdos_renyi, random_partition
from repro_torch.kernels.local_eval import (local_eval_dist_into,
                                            local_eval_reach_into)
from repro_torch.kernels.local_eval import ops
from repro_torch.kernels.tropical_matmul import ops as tops
from repro_torch.graph.graph import Graph

# test_torch_uncached.py's CASES: (n, m, k, seed, reserve_boundary)
CASES = [(24, 70, 3, 0, 0), (36, 110, 4, 1, 0), (30, 90, 2, 2, 4),
         (16, 40, 1, 3, 0)]
# None: reach; an int: dist capped there (INF: exact)
CAPS = [None, INF, 0, 1, 3]
FRAGS = ["all", "first", "last_two"]
PAD = 0x5A          # what every byte holds before the call


def _fragmentation(case):
    n, m, k, seed, rb = case
    g = erdos_renyi(n, m, n_labels=4, seed=seed)
    return fragment_graph(g, random_partition(g, k, seed), k,
                          reserve_boundary=rb)


def _args(fr, s, t, frags):
    """The engine's arguments for fragments ``frags`` (a list of indices)."""
    qs = query_slots(fr, s, t)
    a = fr.arrays
    names = ("esrc", "edst", "src_local", "src_row", "tgt_local")
    return ([torch.tensor(a[name][frags]) for name in names]
            + [torch.tensor(qs[name][frags]) for name in ("s_local",
                                                         "t_local")])


def _frags(fr, which):
    k = fr.k
    return {"all": list(range(k)), "first": [0],
            "last_two": list(range(max(0, k - 2), k))}[which]


def _storage(B, cap):
    """Padded storage whose every byte is PAD, and its [B, B] view of the
    kind ``cap`` names: bool D (16-byte pitch) or int32 W (4 entries)."""
    width = -(-B // 16) * 16 if cap is None else -(-B // 4) * 16
    buf = torch.full((B, width), PAD, dtype=torch.uint8)
    if cap is None:
        return buf, buf.view(torch.bool)[:, :B]
    return buf, buf.view(torch.int32)[:, :B]


def _assembled(fr, args, cap):
    """The old assembly: the row block written into a zero D or INF W,
    pads included."""
    buf, view = _storage(fr.B, cap)
    if cap is None:
        rows, block = engine.local_eval_reach(*args, n_max=fr.n_max, B=fr.B)
        buf.fill_(0)
    else:
        rows, block = engine.local_eval_dist(*args, cap, n_max=fr.n_max,
                                             B=fr.B)
        buf.view(torch.int32).fill_(INF)
    view[rows] = block
    return buf, rows


def _written(fr, args, cap):
    """The new path: ``out=`` on PAD-filled storage."""
    buf, view = _storage(fr.B, cap)
    if cap is None:
        got = engine.local_eval_reach(*args, n_max=fr.n_max, B=fr.B, out=view)
    else:
        got = engine.local_eval_dist(*args, cap, n_max=fr.n_max, B=fr.B,
                                     out=view)
    assert got is view
    return buf, view


@pytest.mark.parametrize("which", FRAGS)
@pytest.mark.parametrize("cap", CAPS, ids=str)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_out_equals_the_assembled_block(case, cap, which):
    fr = _fragmentation(case)
    rng = np.random.default_rng(case[3])
    frags = _frags(fr, which)
    for s, t in rng.integers(0, fr.g.n, size=(3, 2)):
        args = _args(fr, int(s), int(t), frags)
        want, rows = _assembled(fr, args, cap)
        got, view = _written(fr, args, cap)
        assert torch.equal(got, want), (s, t)
        # the pads and every row outside ``rows`` hold the semiring zero
        zero = False if cap is None else INF
        full = got.view(view.dtype)
        assert bool((full[:, view.shape[1]:] == zero).all())
        free = torch.ones(fr.B, dtype=torch.bool)
        free[rows] = False
        assert bool((view[free] == zero).all())
        assert bool(free[fr.B - 1])                     # the t row


@pytest.mark.parametrize("cap", CAPS, ids=str)
def test_s_and_t_absent_from_the_fragments(cap):
    """Fragments that hold neither s nor t: the s row (B-2) is unowned and
    the t column (B-1) reads nothing, so both hold the semiring zero."""
    fr = _fragmentation(CASES[1])
    zero = False if cap is None else INF
    s, t = 0, 1
    others = [f for f in range(fr.k)
              if f not in (int(fr.part[s]), int(fr.part[t]))]
    assert others
    args = _args(fr, s, t, others)
    assert bool((args[5] == fr.n_max).all() and (args[6] == fr.n_max).all())
    want, _ = _assembled(fr, args, cap)
    got, view = _written(fr, args, cap)
    assert torch.equal(got, want)
    assert bool((view[fr.B - 2] == zero).all())
    assert bool((view[:, fr.B - 1] == zero).all())


@pytest.mark.parametrize("cap", CAPS, ids=str)
def test_spare_boundary_rows_hold_the_zero(cap):
    """Spare boundary positions (``reserve_boundary``) own no source row:
    their rows and columns hold the semiring zero."""
    fr = _fragmentation(CASES[2])
    spare = list(range(fr.nb_active, fr.n_boundary))
    assert spare
    args = _args(fr, 3, 5, _frags(fr, "all"))
    want, _ = _assembled(fr, args, cap)
    got, view = _written(fr, args, cap)
    assert torch.equal(got, want)
    zero = False if cap is None else INF
    assert bool((view[spare] == zero).all())
    assert bool((view[:, spare] == zero).all())


def _good(cap=None):
    fr = _fragmentation(CASES[1])
    args = _args(fr, 3, 5, _frags(fr, "all"))
    return fr, args, _storage(fr.B, cap)[1]


def _bad(kind):
    """Arguments the wrapper must refuse, and the exception it raises."""
    fr, args, out = _good()
    if kind == "out_dtype":
        return TypeError, out.view(torch.uint8), args
    if kind == "input_dtype":
        return TypeError, out, [args[0].long()] + args[1:]
    if kind == "unpadded_pitch":
        return ValueError, torch.zeros((fr.B, fr.B), dtype=torch.bool), args
    if kind == "unaligned_base":
        buf = torch.zeros((fr.B, 16 * (-(-fr.B // 16)) + 16),
                          dtype=torch.bool)
        return ValueError, buf[:, 1:fr.B + 1], args
    if kind == "mixed_devices":
        return ValueError, out, [args[0].to("meta")] + args[1:]
    if kind == "shape":
        return ValueError, out[:-1], args
    if kind == "columns_not_contiguous":
        buf = torch.zeros((fr.B, 2 * 16 * (-(-fr.B // 16))),
                          dtype=torch.bool)
        return ValueError, buf[:, 0:2 * fr.B:2], args
    if kind == "sources_not_contiguous":
        return ValueError, out, args[:2] + [args[2].T.contiguous().T] + \
            args[3:]
    if kind == "storage_short":
        # the last row's pad lies past the storage's end
        buf = torch.zeros(fr.B * 16 * (-(-fr.B // 16)) - 1, dtype=torch.bool)
        return ValueError, buf.as_strided((fr.B, fr.B),
                                          (16 * (-(-fr.B // 16)), 1)), args
    if kind == "kernel_on_cpu":
        # arguments the engine takes on the CPU; the kernel wants the card
        return ValueError, out, args
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", [
    "out_dtype", "input_dtype", "unpadded_pitch", "unaligned_base",
    "mixed_devices", "shape", "columns_not_contiguous",
    "sources_not_contiguous", "storage_short", "kernel_on_cpu"])
def test_wrapper_refuses(kind):
    exc, out, args = _bad(kind)
    before = ops.launches
    with pytest.raises(exc):
        local_eval_reach_into(out, *args, n_max=_good()[0].n_max)
    assert ops.launches == before


def test_wrapper_refuses_the_other_semiring():
    """Reach into an int32 W, dist into a bool D; row lists into neither
    matrix entry, and no matrix into the row-list entry."""
    fr, args, d = _good()
    w = _storage(fr.B, INF)[1]
    lists = tops.row_lists(fr.B, "cpu")
    with pytest.raises(TypeError):
        local_eval_reach_into(w, *args, n_max=fr.n_max)
    with pytest.raises(TypeError):
        local_eval_dist_into(d, *args, 3, n_max=fr.n_max)
    with pytest.raises(TypeError):
        local_eval_dist_into(lists, *args, 3, n_max=fr.n_max)
    with pytest.raises(TypeError):
        local_eval_reach_into(lists, *args, n_max=fr.n_max)
    with pytest.raises(TypeError):
        ops.local_eval_dist_lists(w, *args, 3, n_max=fr.n_max)


# a block's shared memory on the H100 (227 KB) less the kernel's static 4 KB
LIMIT = 232448 - 4224


@pytest.mark.parametrize("n_max,E,limit,want", [
    (9032, 8448, LIMIT, ops.Plan(True, True, 9033 * 12 + 8448 * 8)),
    (2000, 60000, LIMIT, ops.Plan(True, False, 2001 * 12)),
    (30000, 1000, LIMIT, ops.Plan(False, False, 0)),
    (30000, 60000, LIMIT, ops.Plan(False, False, 0)),
    (0, 0, 100, ops.Plan(True, True, 12)),
])
def test_shared_memory_plan(n_max, E, limit, want):
    """What the kernel keeps in shared memory: the BFS state and the edges
    where both fit, else the state, else neither."""
    assert ops._plan(n_max, E, limit) == want


# ---------------------------------------------------------------------------
# the row-list route: W's finite entries, row for row
# ---------------------------------------------------------------------------

#: the dist tests' bounds: none, and the caps 0, 1 and the cell's 6
BOUNDS = [None, 0, 1, 6]


def _list_pairs(fr, seed):
    """(s, t): a drawn pair, s a boundary node, t a boundary node, and
    s == t (the boundary pairs where the graph has a boundary)."""
    rng = np.random.default_rng(seed + 50)
    n = fr.g.n
    s, t = (int(v) for v in rng.integers(0, n, 2))
    pairs = [(s, t), (s, s)]
    if len(fr.bnodes):
        b = [int(v) for v in fr.bnodes]
        pairs += [(b[0], t), (s, b[-1])]
    return pairs


def _finite_entries(rows, block):
    """Row -> the set of its finite (column, distance) pairs."""
    return {int(r): {(int(c), int(block[i, c]))
                     for c in torch.nonzero(block[i] < INF)[:, 0]}
            for i, r in enumerate(rows)}


def _listed(lists):
    """Row -> the set of pairs its list holds (no pair twice)."""
    out = {}
    for r in range(lists.B):
        n = int(lists.count[r])
        got = {tuple(p) for p in lists.pairs[r, :n].tolist()}
        assert len(got) == n, r
        if n:
            out[r] = got
    return out


@pytest.mark.parametrize("which", FRAGS)
@pytest.mark.parametrize("bound", BOUNDS, ids=str)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_row_lists_hold_the_finite_entries(case, bound, which):
    """engine.local_eval_dist into row lists on the CPU: each row's list
    holds exactly the finite entries of _rows_dist's row block, rows no
    source owns stay empty, and meta is [0, the pairs stored]."""
    fr = _fragmentation(case)
    cap = INF if bound is None else bound
    frags = _frags(fr, which)
    for s, t in _list_pairs(fr, case[3]):
        args = _args(fr, s, t, frags)
        rows, block = engine.local_eval_dist(*args, cap, n_max=fr.n_max,
                                             B=fr.B)
        lists = tops.row_lists(fr.B, "cpu")
        got = engine.local_eval_dist(*args, cap, n_max=fr.n_max, B=fr.B,
                                     out=lists)
        assert got is lists
        want = {r: e for r, e in _finite_entries(rows, block).items() if e}
        assert _listed(lists) == want, (s, t)
        assert lists.meta.tolist() == [0, sum(map(len, want.values()))]


def _fan_out(h):
    """Fragment 0 holds node 0 with edges to h nodes of fragment 1: the s
    row of s = 0 has h finite entries, the h stubs."""
    n = 2 * h + 2
    g = Graph(n, np.zeros(h, dtype=np.int64), np.arange(h + 2, 2 * h + 2),
              np.zeros(n, dtype=np.int32))
    return fragment_graph(g, (np.arange(n) > h).astype(np.int64), 2)


@pytest.mark.parametrize("h", [tops.ROW_CAP - 1, tops.ROW_CAP,
                               tops.ROW_CAP + 1, 200])
def test_row_lists_flag_a_row_that_does_not_fit(h):
    """A row of more than ROW_CAP entries keeps its first ROW_CAP, in
    column order, and sets OVER_ROW; one that fits sets nothing."""
    fr = _fan_out(h)
    args = _args(fr, 0, 1, [0, 1])
    rows, block = engine.local_eval_dist(*args, INF, n_max=fr.n_max, B=fr.B)
    lists = engine.local_eval_dist(*args, INF, n_max=fr.n_max, B=fr.B,
                                   out=tops.row_lists(fr.B, "cpu"))
    s_row = fr.B - 2
    entries = sorted(_finite_entries(rows, block)[s_row])
    assert len(entries) == h
    kept = min(h, tops.ROW_CAP)
    assert int(lists.count[s_row]) == kept
    assert lists.pairs[s_row, :kept].tolist() == [list(e) for e in
                                                  entries[:kept]]
    over = h > tops.ROW_CAP
    assert int(lists.meta[0]) == (tops.OVER_ROW if over else 0)


@pytest.mark.parametrize("cap", [tops.RING - 1, INF])
def test_row_lists_flag_a_distance_past_the_ring(cap):
    """A chain of 80 nodes in one fragment whose end points out of it: the
    s row of s = 0 reaches that stub at distance 80, past the ring of the
    settle kernel's levels, unless the cap cuts it off first."""
    n = 82
    src = np.concatenate([np.arange(79), [79, 81]])
    dst = np.concatenate([np.arange(1, 80), [80, 79]])
    g = Graph(n, src, dst, np.zeros(n, dtype=np.int32))
    part = (np.arange(n) >= 80).astype(np.int64)
    fr = fragment_graph(g, part, 2)
    args = _args(fr, 0, 81, [0, 1])
    lists = engine.local_eval_dist(*args, cap, n_max=fr.n_max, B=fr.B,
                                   out=tops.row_lists(fr.B, "cpu"))
    over = cap >= tops.RING
    assert int(lists.meta[0]) == (tops.OVER_HOPS if over else 0)
    d = [w for _, w in lists.pairs[fr.B - 2, :int(lists.count[fr.B - 2])]
         .tolist()]
    assert d == ([80] if over else [])
