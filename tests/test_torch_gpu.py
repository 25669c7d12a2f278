"""The CUDA kernels on the card: each held bit-equal to its plain PyTorch
version, and the session on the card equal to the session on the CPU.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import Dist, GraphDelta, Reach, Rpq
from repro_torch.core import engine, incremental
from repro_torch.core.fragments import fragment_graph, query_slots
from repro_torch.graph import erdos_renyi, random_partition
from repro_torch.graph.graph import Graph
from repro_torch.kernels.bitpack_ops import ops as pops
from repro_torch.kernels.bitpack_ops import (bitpack_matmul,
                                             bitpack_matmul_ref, pack_cols,
                                             pack_rows, pack_rows_ref)
from repro_torch.core.bes import bool_closure_kmajor
from repro_torch.kernels.bool_matmul import ops as bops
from repro_torch.kernels.bool_matmul import (is_kmajor, or_and_fixpoint,
                                             or_and_fixpoint_ref,
                                             or_and_floor_pair,
                                             or_and_floor_pair_ref,
                                             or_and_matmul,
                                             or_and_matmul_nt,
                                             or_and_matmul_ref, padded_zeros,
                                             pitch, rows_aligned)
from repro_torch.kernels.local_eval import ops as leops
from repro_torch.kernels.tropical_matmul import ops as tops
from repro_torch.kernels.tropical_matmul import (INF, min_plus_fixpoint_ref,
                                                 min_plus_matmul,
                                                 min_plus_matmul_ref,
                                                 min_plus_settle,
                                                 min_plus_settle_ref)
from repro_torch.kernels.tropical_matmul.ops import (is_aligned, padded_i32,
                                                     pitch_i32)
from repro_torch.kernels.tropical_matmul import (min_plus_settle_lists,
                                                 min_plus_settle_lists_ref,
                                                 row_lists, write_row_lists)

SHAPES = [(128, 128, 128), (7, 200, 33), (256, 64, 128), (1, 1, 1),
          (130, 257, 5), (64, 512, 64), (5, 0, 7), (300, 1000, 260)]
DENSITIES = [0.0, 0.02, 0.3, 1.0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_or_and_kernel_matches_plain(cuda, shape):
    m, k, n = shape
    rng = np.random.default_rng(1)
    for density in DENSITIES:
        a = torch.tensor(rng.random((m, k)) < density, device=cuda)
        b = torch.tensor(rng.random((k, n)) < density, device=cuda)
        before = bops.launches
        got = or_and_matmul(a, b)
        assert bops.launches == before + 1
        assert got.is_cuda and got.dtype == torch.bool
        assert torch.equal(got, or_and_matmul_ref(a, b))
        # strided operands: a column-major view and a column slice
        at = a.T.contiguous().T
        assert torch.equal(or_and_matmul(at, b[:, ::2]),
                           or_and_matmul_ref(a, b[:, ::2]))


# M and N off the 64 / 128 / 256 tile grid, K around the 32-byte wgmma
# depth and the 128-byte stage
B1_MN = [(65, 257), (130, 300), (1, 513)]
B1_K = [31, 32, 33, 127, 129]


def _storage(x):
    """The padded [rows, pitch] storage behind a kernel output view."""
    return x.as_strided((x.shape[0], x.stride(0)), (x.stride(0), 1))


@pytest.mark.gpu
@pytest.mark.parametrize("k", B1_K)
@pytest.mark.parametrize("mn", B1_MN, ids=str)
def test_or_and_wgmma_ragged_tiles(cuda, mn, k):
    """The tensor-core kernel on ragged tiles: C and the epilogue's C^T
    bit-equal to the plain version, pad bytes zero, one launch a call."""
    m, n = mn
    rng = np.random.default_rng([m, n, k])
    for density in (0.02, 0.3, 1.0):
        a = torch.tensor(rng.random((m, k)) < density, device=cuda)
        b = torch.tensor(rng.random((k, n)) < density, device=cuda)
        want = or_and_matmul_ref(a, b)
        before = bops.launches
        c, ct = or_and_matmul_nt(a, b.T.contiguous(), with_transpose=True)
        assert bops.launches == before + 1
        assert torch.equal(c, want) and torch.equal(ct, want.T)
        assert c.stride(0) == pitch(n) and ct.stride(0) == pitch(m)
        assert not _storage(c)[:, n:].any() and not _storage(ct)[:, m:].any()
        assert torch.equal(or_and_matmul(a, b), want)
        assert bops.launches == before + 2


@pytest.mark.gpu
def test_or_and_wgmma_sums_past_2_14(cuda):
    """All ones over K = 20000: every s32 sum is 20000 > 2^14."""
    a = torch.ones((70, 20000), dtype=torch.bool, device=cuda)
    b = torch.ones((20000, 90), dtype=torch.bool, device=cuda)
    got = or_and_matmul(a, b)
    assert got.all() and torch.equal(got, or_and_matmul_ref(a, b))
    b[:, 7] = False
    a[3] = False
    got = or_and_matmul(a, b)
    assert torch.equal(got, or_and_matmul_ref(a, b))
    assert not got[3].any() and not got[:, 7].any()


@pytest.mark.gpu
def test_or_and_wgmma_unaligned_operands(cuda):
    """Operands at an odd byte offset, with odd row pitches, transposed
    and sliced: each is copied K-major once and the product is unchanged."""
    rng = np.random.default_rng(11)
    big = torch.tensor(rng.random((300, 400)) < 0.1, device=cuda)
    a = big[3:120, 5:206]                  # offset 3 * 400 + 5, pitch 400
    b = big[:201, 1::2]                    # column stride 2
    want = or_and_matmul_ref(a, b)
    assert torch.equal(or_and_matmul(a, b), want)
    assert torch.equal(or_and_matmul(a.T.contiguous().T, b), want)
    assert torch.equal(or_and_matmul_nt(a, b.T), want)


@pytest.mark.gpu
def test_skinny_launches_on_evaldg_not_on_squaring(cuda):
    """evalDG on a padded D is one fixpoint launch, with its steps from the
    kernel equal to the plain version's, and no product launch and no
    copy; the closure's squarings and a batch compose launch the product
    kernel."""
    rng = np.random.default_rng(22)
    B = 1037
    D = padded_zeros(B, B, cuda).copy_(
        torch.tensor(rng.random((B, B)) < 2.0 / B, device=cuda))
    src = torch.zeros(B, dtype=torch.bool, device=cuda)
    src[5] = True
    tgt = torch.ones(B, dtype=torch.bool, device=cuda)
    before = (bops.launches, bops.fixpoint_launches, bops.copies)
    assert engine.evaldg_reach(D, src, tgt) is engine.evaldg_reach(
        D.cpu(), src.cpu(), tgt.cpu())
    assert (bops.launches, bops.fixpoint_launches, bops.copies) == \
        (before[0], before[1] + 1, before[2])
    x, steps = or_and_fixpoint(src, D)
    want_x, want_steps = or_and_fixpoint_ref(src.cpu(), D.cpu())
    assert int(steps) == int(want_steps) > 1 and steps.is_cuda
    assert torch.equal(x.cpu(), want_x)
    before = bops.launches
    C, Ct = bool_closure_kmajor(D)
    or_and_matmul_nt(D[:256], Ct)
    assert bops.launches > before


@pytest.mark.gpu
def test_bool_closure_kmajor_on_card(cuda):
    """The squarings chain through (C, C^T) with no transpose: the pair on
    the card equals the closure on the CPU and its transpose."""
    rng = np.random.default_rng(12)
    D = rng.random((300, 300)) < 0.01
    want = bool_closure_kmajor(torch.tensor(D))[0]
    before = bops.launches
    C, Ct = bool_closure_kmajor(torch.tensor(D, device=cuda))
    assert bops.launches > before
    assert torch.equal(C.cpu(), want) and torch.equal(Ct.cpu(), want.T)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_min_plus_kernel_matches_plain(cuda, shape):
    m, k, n = shape
    rng = np.random.default_rng(2)
    a = rng.integers(0, 50, (m, k)).astype(np.int32)
    b = rng.integers(0, 50, (k, n)).astype(np.int32)
    a[rng.random((m, k)) < 0.3] = INF
    b[rng.random((k, n)) < 0.3] = INF
    a, b = torch.tensor(a, device=cuda), torch.tensor(b, device=cuda)
    before = tops.launches
    got = min_plus_matmul(a, b)
    assert tops.launches == before + 1
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got, min_plus_matmul_ref(a, b))
    assert torch.equal(min_plus_matmul(a.T.contiguous().T, b[:, ::2]),
                       min_plus_matmul_ref(a, b[:, ::2]))


def _tropical(rng, shape, density=0.7, top=50):
    x = rng.integers(0, top, shape).astype(np.int32)
    x[rng.random(shape) >= density] = INF
    return x


def _on_card_padded(x, cuda):
    return padded_i32(*x.shape, cuda).copy_(torch.tensor(x, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 2, 7, 8, 63, 64, 65, 256])
@pytest.mark.parametrize("K", [0, 1, 33, 4099])
def test_min_plus_routes_match_plain(cuda, M, K):
    """Both routes (skinny up to 64 rows, tile above), ragged N, entries at
    INF, with and without the floor ``init=``: bit-equal to the plain
    version, one launch each, no operand copied, the output padded and
    ``init`` untouched."""
    N = 1037
    rng = np.random.default_rng(M * 10007 + K)
    a, b = _tropical(rng, (M, K)), _tropical(rng, (K, N))
    init = _tropical(rng, (M, N), 0.2, top=200)
    ta, tb, ti = (_on_card_padded(x, cuda) for x in (a, b, init))
    held = ti.clone()
    for floor in (None, ti):
        launches, copies = tops.launches, tops.copies
        got = min_plus_matmul(ta, tb, init=floor)
        assert tops.launches == launches + 1 and tops.copies == copies
        assert got.stride() == (pitch_i32(N), 1) and is_aligned(got)
        assert got.data_ptr() != ti.data_ptr()
        assert torch.equal(got, min_plus_matmul_ref(ta, tb, floor))
    assert torch.equal(ti, held)


@pytest.mark.gpu
def test_min_plus_copies_unaligned_operands(cuda):
    """Strided, transposed and offset operands are copied once each into
    padded storage (counted in ``copies``) and give the same product."""
    rng = np.random.default_rng(12)
    a, b = _tropical(rng, (70, 45)), _tropical(rng, (45, 2 * 33))
    init = _tropical(rng, (70, 33), 0.2, top=200)
    ta = torch.tensor(a.T.copy(), device=cuda).T           # column-major
    tb = torch.tensor(b, device=cuda)[:, ::2]              # column slice
    wide = torch.zeros((70, 34), dtype=torch.int32, device=cuda)
    wide[:, 1:] = torch.tensor(init, device=cuda)
    ti = wide[:, 1:]                                       # 4 bytes off
    for m in (70, 1):                                      # tile, skinny
        copies = tops.copies
        got = min_plus_matmul(ta[:m], tb, init=ti[:m])
        want = min_plus_matmul_ref(ta[:m], tb, ti[:m])
        assert torch.equal(got, want)
        # a, b and, on the tile path, init (the skinny path copies the
        # floor into its output whatever its layout)
        assert tops.copies - copies == {70: 3, 1: 2}[m]


@pytest.mark.gpu
def test_min_plus_split_k_is_deterministic(cuda):
    """The skinny path merges its K splits with atomicMin: two launches
    give the same bits, equal to the plain version."""
    rng = np.random.default_rng(13)
    for M in (1, 64):
        a = _tropical(rng, (M, 20011), 0.5, top=1000)
        b = _tropical(rng, (20011, 3001), 0.5, top=1000)
        ta, tb = _on_card_padded(a, cuda), _on_card_padded(b, cuda)
        assert tops._card_route(torch.cuda.current_device(), M, 20011,
                                3001).split > 1
        first, second = min_plus_matmul(ta, tb), min_plus_matmul(ta, tb)
        assert torch.equal(first, second)
        assert torch.equal(first, min_plus_matmul_ref(ta, tb))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + [(9, 31, 9), (9, 32, 9),
                                            (9, 33, 9)])
def test_bitpack_kernel_matches_plain(cuda, shape):
    """B3 on pre-packed words == its plain version == B1 on the unpacked
    operands; the all-ones row sets bit 31 of every word."""
    m, k, n = shape
    rng = np.random.default_rng(3)
    for density in DENSITIES:
        a = torch.tensor(rng.random((m, k)) < density, device=cuda)
        b = torch.tensor(rng.random((k, n)) < density, device=cuda)
        a[0] = True
        ap, bp = pack_rows(a), pack_cols(b)
        assert torch.equal(ap, pack_rows_ref(a))
        before = pops.launches
        got = bitpack_matmul(ap, bp, k)
        assert pops.launches == before + 1
        assert got.is_cuda and got.dtype == torch.bool
        assert torch.equal(got, bitpack_matmul_ref(ap, bp, k))
        assert torch.equal(got, or_and_matmul(a, b))


@pytest.mark.gpu
def test_session_on_card_matches_cpu(cuda):
    g = erdos_renyi(300, 1200, n_labels=3, seed=5)
    part = random_partition(g, 4, seed=5)
    on_cpu, on_card = (fragment_graph(g, part, 4) for _ in range(2))
    rng = np.random.default_rng(5)
    queries = []
    for i, (s, t) in enumerate(rng.integers(0, g.n, size=(64, 2))):
        s, t = int(s), int(t)
        queries.append([Reach(s, t), Dist(s, t), Dist(s, t, bound=3),
                        Rpq(s, t, regex="(0|1)* 2")][i % 4])
    want = repro_torch.connect(on_cpu, device="cpu").run(queries)
    bops.launches = tops.launches = 0
    got = repro_torch.connect(on_card).run(queries)
    assert bops.launches > 0 and tops.launches > 0
    assert on_card.rvset_cache.closure.is_cuda
    assert [(r.answer, r.distance, r.stats) for r in got] == \
        [(r.answer, r.distance, r.stats) for r in want]


# ---------------------------------------------------------------------------
# the one-shot engine and incremental repair on the card
# ---------------------------------------------------------------------------

def _dist_matrix(rng, m, n, density):
    w = rng.integers(0, 6, (m, n)).astype(np.int32)
    w[rng.random((m, n)) >= density] = INF
    return w


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2, 300, 1037])
def test_evaldg_on_card_matches_cpu(cuda, B):
    """evalDG on the card, equal to the CPU: one fixpoint launch per reach
    evalDG and one settle launch per dist evalDG, and no per-step
    product, on D and W as they are stored, padded (no copy) or not (one
    counted copy into padded storage); the or-and kernel's x and steps
    equal to the plain version's."""
    rng = np.random.default_rng(B)
    D = rng.random((B, B)) < 3.0 / B
    W = _dist_matrix(rng, B, B, 3.0 / B)
    for trial in range(3):
        src = np.zeros(B, dtype=bool)
        src[rng.integers(B)] = True
        tgt = rng.random(B) < 0.1
        args = [torch.tensor(x) for x in (D, src, tgt)]
        want = engine.evaldg_reach(*args)
        want_x, want_steps = or_and_fixpoint_ref(args[1], args[0])
        Dc = args[0].to(cuda)
        Dp = padded_zeros(B, B, cuda).copy_(Dc)
        for Dm in (Dc, Dp):
            before = (bops.launches, bops.fixpoint_launches, bops.copies)
            got = engine.evaldg_reach(Dm, args[1].to(cuda), args[2].to(cuda))
            assert got is want
            copies = 0 if rows_aligned(Dm) else 1
            assert (bops.launches, bops.fixpoint_launches, bops.copies) == \
                (before[0], before[1] + 1, before[2] + copies)
            x, steps = or_and_fixpoint(args[1].to(cuda), Dm)
            assert torch.equal(x.cpu(), want_x)
            assert int(steps) == int(want_steps) > 0
        args = [torch.tensor(x) for x in (W, src, tgt)]
        for Wm in (args[0].to(cuda),
                   padded_i32(B, B, cuda).copy_(args[0].to(cuda))):
            before = (tops.launches, tops.settle_launches, tops.copies)
            got = engine.evaldg_dist(Wm, *(a.to(cuda) for a in args[1:]))
            assert got == engine.evaldg_dist(*args)
            copies = 0 if is_aligned(Wm) else 1
            assert (tops.launches, tops.settle_launches, tops.copies) == \
                (before[0], before[1] + 1, before[2] + copies)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1024, 1037])
def test_fixpoints_on_a_chain(cuda, B):
    """A chain walked one hop a step (B steps): the or-and fixpoint kernel
    bit-equal to its plain version, steps included, in one launch; a
    source at the chain's end takes one step."""
    D = torch.zeros((B, B), dtype=torch.bool)
    D[torch.arange(B - 1), torch.arange(1, B)] = True
    Dc = padded_zeros(B, B, cuda).copy_(D.to(cuda))
    for head in (0, B - 1):
        src = torch.zeros(B, dtype=torch.bool)
        src[head] = True
        want, want_steps = or_and_fixpoint_ref(src, D)
        before = bops.fixpoint_launches
        got, steps = or_and_fixpoint(src.to(cuda), Dc)
        assert bops.fixpoint_launches == before + 1
        assert torch.equal(got.cpu(), want)
        assert int(steps) == int(want_steps) == (B if head == 0 else 1)


@pytest.mark.gpu
def test_fixpoints_on_mr_shaped_inputs(cuda):
    """The MR reducer's shape: a D of side B Q with a few rows set, whose
    frontier adds one row a step; the or-and fixpoint kernel bit-equal to
    its plain version, steps included."""
    side = 5 * 1037
    rng = np.random.default_rng(31)
    D = padded_zeros(side, side, cuda)
    hops = rng.choice(side, size=6, replace=False)
    D[torch.tensor(hops[:-1]), torch.tensor(hops[1:])] = True
    extra = rng.integers(0, side, (64, 2))
    D[torch.tensor(extra[:, 0]), torch.tensor(extra[:, 1])] = True
    src = torch.zeros(side, dtype=torch.bool, device=cuda)
    src[int(hops[0])] = True
    x, steps = or_and_fixpoint(src, D)
    want_x, want_steps = or_and_fixpoint_ref(src.cpu(), D.cpu())
    assert torch.equal(x.cpu(), want_x) and int(steps) == int(want_steps)
    assert int(steps) >= 5


def _settled_rows(d, levels):
    """Rows whose final distance d is one of the ``levels`` least distinct
    finite values: those a search in order of distance that settled that
    many levels reads, each once."""
    finite = np.unique(d[d < INF])
    stop = finite[levels] if levels < len(finite) else INF
    return int((d < stop).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2, 300, 1037, 5185])
def test_settle_on_card_matches_plain(cuda, B):
    """min_plus_settle on the card, on random W with zero entries and on
    the same W with every weight tripled (empty levels): answer, levels
    and rows read equal to the plain version's for bounds None, 0, 1, 6
    and past INF; the rows exactly those whose final distance lies below
    the level it stopped at (the final distances from the plain
    Bellman-Ford fixpoint), so no row is read twice; one settle launch
    counted a call, no product, and no copy of padded W;
    engine.evaldg_dist on the card gives the same answer."""
    rng = np.random.default_rng(B + 40)
    W = _dist_matrix(rng, B, B, 3.0 / B)
    for Wn in (W, np.where(W < INF, 3 * W, INF).astype(np.int32)):
        Wt = torch.tensor(Wn)
        Wc = padded_i32(B, B, cuda).copy_(Wt.to(cuda))
        for trial in range(3):
            src = np.zeros(B, dtype=bool)
            src[rng.integers(B)] = True
            tgt = src.copy() if trial == 2 else rng.random(B) < 0.05
            d0 = torch.tensor(np.where(src, 0, INF).astype(np.int32))
            args = [torch.tensor(src).to(cuda), torch.tensor(tgt).to(cuda)]
            d = min_plus_fixpoint_ref(d0, Wt)[0].numpy()
            for bound in (None, 0, 1, 6, 1 << 40):
                want = min_plus_settle_ref(d0, Wt, torch.tensor(tgt), bound)
                before = (tops.launches, tops.settle_launches, tops.copies)
                got = min_plus_settle(d0.to(cuda), Wc, args[1], bound)
                assert (tops.launches, tops.settle_launches, tops.copies) == \
                    (before[0], before[1] + 1, before[2])
                assert torch.equal(got.cpu(), want), (trial, bound)
                _, levels, rows = got.tolist()
                assert rows == _settled_rows(d, levels), (trial, bound)
                assert engine.evaldg_dist(Wc, *args, bound=bound) == \
                    int(want[0])
    Wu = torch.tensor(W, device=cuda)
    before = tops.copies
    src = torch.zeros(B, dtype=torch.int32, device=cuda)
    min_plus_settle(src, Wu, torch.ones(B, dtype=torch.bool, device=cuda))
    assert tops.copies == before + (0 if is_aligned(Wu) else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1024, 1037])
def test_settle_on_a_chain(cuda, B):
    """A chain walked one level a hop: the search reads the rows up to the
    target and no further, stops past the bound, and with no target reads
    every row once, B levels in one launch."""
    W = np.full((B, B), INF, dtype=np.int32)
    W[np.arange(B - 1), np.arange(1, B)] = 1
    Wc = padded_i32(B, B, cuda).copy_(torch.tensor(W, device=cuda))
    d0 = torch.full((B,), INF, dtype=torch.int32, device=cuda)
    d0[0] = 0
    end = torch.zeros(B, dtype=torch.bool, device=cuda)
    end[B - 1] = True
    assert min_plus_settle(d0, Wc, end).tolist() == [B - 1, B - 1, B - 1]
    assert min_plus_settle(d0, Wc, end, 6).tolist() == [INF, 7, 7]
    assert min_plus_settle(d0, Wc, torch.zeros_like(end)).tolist() == \
        [INF, B, B]


def _closure_pair(rng, nb, cuda):
    from repro_torch.core import bes
    D = rng.random((nb, nb)) < 1.5 / nb
    C, Ct = bes.bool_closure_kmajor(torch.tensor(D, device=cuda))
    return C, Ct


@pytest.mark.gpu
@pytest.mark.parametrize("nb,r", [(300, 64), (1037, 128), (50, 50)])
def test_rank_update_bool_keeps_the_pair_kmajor(cuda, nb, r):
    """_rank_update_bool on the card: (C', C'^T) equal the CPU's update,
    stay transposes of each other, and both live in padded K-major
    storage; the old pair is left as it was."""
    rng = np.random.default_rng(nb)
    C, Ct = _closure_pair(rng, nb, cuda)
    rows = torch.tensor(rng.random((r, nb)) < 2.0 / nb, device=cuda)
    idx = rng.choice(nb, size=r, replace=r > nb)
    old = (C.clone(), Ct.clone())
    before = (bops.launches, bops.floor_launches)
    C2, C2t = incremental._rank_update_bool(C, Ct, rows, idx)
    assert bops.launches - before[0] >= 4
    # the P stage is one launch of the floor-pair kernel, C | P and
    # C^T | P^T with no OR pass after it
    assert bops.floor_launches - before[1] == 1
    want, want_t = incremental._rank_update_bool(C.cpu(), Ct.cpu(),
                                                 rows.cpu(), idx)
    assert torch.equal(C2.cpu(), want) and torch.equal(C2t.cpu(), want_t)
    assert torch.equal(C2.T, C2t)
    assert is_kmajor(C2) and is_kmajor(C2t)
    assert not _storage(C2)[:, nb:].any()
    assert not _storage(C2t)[:, nb:].any()
    assert torch.equal(C, old[0]) and torch.equal(Ct, old[1])


# the floor-pair kernel: M and N around the 128-row tiles, K around the
# 32-byte k-steps, the 64-byte slice and the 128-byte stages
FLOOR_MN = [1, 127, 129, 1037, 4113]
FLOOR_K = [1, 16, 63, 64, 65, 128, 129, 1024]


def _floors(rng, m, n, kind, cuda):
    """A floor pair (F [m, n], Ft [n, m]) in padded storage whose pad bytes
    are set (the kernel must not read them): random, all zero or all one;
    Ft is drawn apart from F, so each output must take its own floor."""
    out = []
    for rows, cols in ((m, n), (n, m)):
        x = {"random": lambda: rng.random((rows, cols)) < 0.1,
             "zero": lambda: np.zeros((rows, cols), dtype=bool),
             "one": lambda: np.ones((rows, cols), dtype=bool)}[kind]()
        buf = torch.ones((rows, pitch(cols)), dtype=torch.bool, device=cuda)
        out.append(buf[:, :cols].copy_(torch.tensor(x, device=cuda)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("k", FLOOR_K)
@pytest.mark.parametrize("m", FLOOR_MN)
def test_or_and_floor_pair_matches_plain(cuda, m, k):
    """or_and_floor_pair(a, b_t, F, Ft) on the card: one floor-pair
    launch, (F | P, Ft | P^T) bit-equal to the plain version, both
    outputs' pads zero, both floors unchanged."""
    for n in FLOOR_MN:
        rng = np.random.default_rng([m, n, k])
        a = torch.tensor(rng.random((m, k)) < 0.05, device=cuda)
        b_t = torch.tensor(rng.random((n, k)) < 0.05, device=cuda)
        for kind in ("random", "zero", "one"):
            F, Ft = _floors(rng, m, n, kind, cuda)
            old = (_storage(F).clone(), _storage(Ft).clone())
            want, want_t = or_and_floor_pair_ref(a, b_t, F, Ft)
            before = (bops.launches, bops.floor_launches)
            c, ct = or_and_floor_pair(a, b_t, F, Ft)
            assert (bops.launches - before[0],
                    bops.floor_launches - before[1]) == (1, 1)
            what = f"{m}x{k}x{n} {kind}"
            assert torch.equal(c, want) and torch.equal(ct, want_t), what
            assert c.stride(0) == pitch(n) and ct.stride(0) == pitch(m)
            assert not _storage(c)[:, n:].any(), what
            assert not _storage(ct)[:, m:].any(), what
            assert torch.equal(_storage(F), old[0]), what
            assert torch.equal(_storage(Ft), old[1]), what


@pytest.mark.gpu
def test_or_and_floor_pair_refuses_a_floor_that_is_not_kmajor(cuda):
    """On the card a floor outside padded storage raises: the kernel reads
    it by TMA and the wrapper makes no copy of a closure."""
    a = torch.zeros((33, 64), dtype=torch.bool, device=cuda)
    b_t = torch.zeros((17, 64), dtype=torch.bool, device=cuda)
    F = torch.zeros((33, 17), dtype=torch.bool, device=cuda)
    Ft = padded_zeros(17, 33, cuda)
    with pytest.raises(ValueError):
        or_and_floor_pair(a, b_t, F, Ft)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,r", [(300, 64), (1037, 128)])
def test_rank_update_tropical_matches_cpu(cuda, nb, r):
    rng = np.random.default_rng(nb + 1)
    from repro_torch.core import bes
    Cd = bes.tropical_closure(torch.tensor(_dist_matrix(rng, nb, nb,
                                                        2.0 / nb)))
    rows = torch.tensor(_dist_matrix(rng, r, nb, 3.0 / nb))
    idx = rng.choice(nb, size=r, replace=False)
    want = incremental._rank_update_tropical(Cd, rows, idx)
    before = tops.launches
    got = incremental._rank_update_tropical(Cd.to(cuda), rows.to(cuda), idx)
    assert tops.launches - before >= 3
    assert torch.equal(got.cpu(), want)


def _stream(fr, rng):
    """Inserts in one fragment, a cross insert, a wide insert, a deletion,
    and a delta past the edge reserve: repair, repair, recompute,
    recompute, rebuild."""
    part, n = fr.part, fr.g.n
    f = int(rng.integers(fr.k))
    mine, other = np.nonzero(part == f)[0], np.nonzero(part != f)[0]
    pick = lambda xs: int(rng.choice(xs))
    yield GraphDelta.insert([(pick(mine), pick(mine)) for _ in range(3)])
    yield GraphDelta.insert([(pick(mine), pick(other))])
    yield GraphDelta.insert([(int(rng.integers(n)), int(rng.integers(n)))
                             for _ in range(4 * fr.k)])
    e = rng.choice(fr.g.m, size=3, replace=False)
    yield GraphDelta.delete([(int(fr.g.src[i]), int(fr.g.dst[i]))
                             for i in e])
    yield GraphDelta.insert([(pick(mine), pick(other))
                             for _ in range(fr.e_max)])


@pytest.mark.gpu
def test_delta_stream_on_card_matches_cpu(cuda):
    """The same delta stream through session.apply on the card and on the
    CPU: equal UpdateStats, cache tensors and answers after every delta,
    reaching repair, recompute and rebuild."""
    g = erdos_renyi(400, 1400, n_labels=3, seed=8)
    part = random_partition(g, 4, seed=8)
    reserve = dict(reserve_boundary=16, reserve_edges=32, reserve_stubs=16)
    on_cpu, on_card = (fragment_graph(g, part, 4, **reserve)
                       for _ in range(2))
    cpu = repro_torch.connect(on_cpu, device="cpu").warm(with_dist=True)
    card = repro_torch.connect(on_card).warm(with_dist=True)
    rng = np.random.default_rng(8)
    modes = []
    for delta in _stream(on_cpu, np.random.default_rng(9)):
        want = cpu.apply(delta)
        bops.launches = tops.launches = 0
        got = card.apply(delta)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        modes.append(got.mode)
        if got.mode != "repair" or got.changed_rows:
            assert bops.launches > 0 and tops.launches > 0, got
        for name in ("bl_frontier", "closure", "closure_t", "bl_dist",
                     "dist_closure"):
            t = getattr(on_card.rvset_cache, name)
            assert t.is_cuda and torch.equal(
                t.cpu(), getattr(on_cpu.rvset_cache, name)), name
        assert is_kmajor(on_card.rvset_cache.closure_t)
        pairs = rng.integers(0, g.n, size=(24, 2))
        queries = [q for s, t in pairs for q in
                   (Reach(int(s), int(t)), Dist(int(s), int(t), bound=3))]
        assert [(r.answer, r.distance) for r in card.run(queries)] == \
            [(r.answer, r.distance) for r in cpu.run(queries)]
    assert modes == ["repair", "repair", "recompute", "recompute", "rebuild"]


@pytest.mark.gpu
def test_uncached_session_on_card_matches_cpu(cuda):
    """connect(fr, cache="none") on the card: the one-shot engine through
    the or-and fixpoint and the settle kernel (no product launch), equal
    to the CPU."""
    g = erdos_renyi(300, 1200, n_labels=3, seed=6)
    fr = fragment_graph(g, random_partition(g, 4, seed=6), 4)
    rng = np.random.default_rng(6)
    queries = []
    for i, (s, t) in enumerate(rng.integers(0, g.n, size=(12, 2))):
        s, t = int(s), int(t)
        queries.append([Reach(s, t), Dist(s, t), Dist(s, t, bound=2),
                        Rpq(s, t, regex="(0|1)* 2")][i % 4])
    want = repro_torch.connect(fr, cache="none", device="cpu").run(queries)
    bops.launches = tops.launches = 0
    bops.fixpoint_launches = tops.settle_launches = 0
    got = repro_torch.connect(fr, cache="none").run(queries)
    assert bops.fixpoint_launches > 0 and tops.settle_launches > 0
    assert bops.launches == 0 and tops.launches == 0
    assert fr.rvset_cache is None
    assert [(r.answer, r.distance, r.stats) for r in got] == \
        [(r.answer, r.distance, r.stats) for r in want]


# ---------------------------------------------------------------------------
# the one-shot localEval kernel (kernels/local_eval): each owned row's local
# BFS on chip, written into padded D or W
# ---------------------------------------------------------------------------

LE_PAD = 0x5A       # every byte's value before a call


def _le_args(fr, s, t, frags, device):
    """``engine.local_eval_*``'s arguments for fragments ``frags``."""
    qs = query_slots(fr, s, t)
    names = ("esrc", "edst", "src_local", "src_row", "tgt_local")
    return ([torch.tensor(fr.arrays[n][frags], device=device) for n in names]
            + [torch.tensor(qs[n][frags], device=device)
               for n in ("s_local", "t_local")])


def _le_storage(B, cap, device):
    """LE_PAD-filled padded storage and its [B, B] view: bool D for
    ``cap`` None, int32 W otherwise, with the paths' row pitches."""
    if cap is None:
        buf = torch.full((B, pitch(B)), LE_PAD, dtype=torch.uint8,
                         device=device)
        return buf, buf.view(torch.bool)[:, :B]
    buf = torch.full((B, 4 * pitch_i32(B)), LE_PAD, dtype=torch.uint8,
                     device=device)
    return buf, buf.view(torch.int32)[:, :B]


def _le_call(fr, args, cap, out):
    if cap is None:
        return engine.local_eval_reach(*args, n_max=fr.n_max, B=fr.B, out=out)
    return engine.local_eval_dist(*args, cap, n_max=fr.n_max, B=fr.B,
                                  out=out)


def _le_kernel(fr, args, cap, cuda):
    """One call on the card, with the recorder off: exactly one launch, and
    no host sync (PyTorch raises on one in sync-debug mode "error")."""
    buf, view = _le_storage(fr.B, cap, cuda)
    before = leops.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert _le_call(fr, args, cap, view) is view
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert leops.launches == before + 1
    return buf


def _le_plain(fr, args, cap):
    """The plain version on the arguments' device: the engine's row block
    written into storage holding the semiring zero, pads included, as the
    CPU path writes it."""
    buf, view = _le_storage(fr.B, cap, args[0].device)
    if cap is None:
        rows, block = engine.local_eval_reach(*args, n_max=fr.n_max, B=fr.B)
        buf.fill_(0)
    else:
        rows, block = engine.local_eval_dist(*args, cap, n_max=fr.n_max,
                                             B=fr.B)
        buf.view(torch.int32).fill_(INF)
    view[rows] = block
    return buf


def _le_check(fr, pairs, frags, caps, cuda, on_cpu=True):
    """The kernel's storage, pads included, equal byte for byte to the
    plain version's: on the CPU, or (``on_cpu`` False, for shapes whose
    plain fixpoint takes minutes there) the same plain code on the card."""
    for s, t in pairs:
        card = _le_args(fr, s, t, frags, cuda)
        host = _le_args(fr, s, t, frags, "cpu") if on_cpu else card
        for cap in caps:
            got = _le_kernel(fr, card, cap, cuda)
            want = _le_plain(fr, host, cap)
            assert torch.equal(got.to(want.device), want), (s, t, cap)
            del got, want


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["all", "one"])
def test_local_eval_kernel_at_the_cells_size(cuda, which):
    """The one-shot cell's graph (n = 32768, m = 4n, 8 labels, k = 16):
    reach, exact dist and dist capped at 6, bit-equal to the plain version
    (all 16 fragments: its code on the card; one fragment: on the CPU)."""
    g = erdos_renyi(32768, 131072, n_labels=8, seed=0)
    fr = fragment_graph(g, random_partition(g, 16, seed=0), 16)
    rng = np.random.default_rng(7)
    pairs = [tuple(int(x) for x in p) for p in rng.integers(0, g.n, (2, 2))]
    if which == "all":
        _le_check(fr, pairs, list(range(16)), [None, INF, 6], cuda,
                  on_cpu=False)
    else:
        _le_check(fr, pairs[:1], [int(fr.part[pairs[0][0]])],
                  [None, INF, 6], cuda)


def _le_chain_graph():
    """A 1024-node chain 0 -> ... -> 1023 in fragment 0, each node i also
    pointing at node 1024 + i in fragment 1, which points back at i: every
    chain node is a source, and node 0 reaches every slot of fragment 0
    (the chain and its 1024 stubs) at distances up to 1024."""
    n = 1024
    i = np.arange(n)
    src = np.concatenate([i[:-1], i, n + i])
    dst = np.concatenate([i[1:], n + i, i])
    g = Graph(2 * n, src, dst, np.zeros(2 * n, dtype=np.int32))
    return fragment_graph(g, (np.arange(2 * n) >= n).astype(np.int64), 2)


@pytest.mark.gpu
def test_local_eval_kernel_on_a_chain(cuda):
    """Distances past 255 and one source reaching every slot: 1024 levels
    in one batch; bit-equal to the CPU, exact and capped at 300."""
    fr = _le_chain_graph()
    assert fr.s_max - 1 >= 1024
    _le_check(fr, [(0, 1023), (5, 2047)], [0, 1], [None, INF, 300], cuda)
    buf = _le_kernel(fr, _le_args(fr, 0, 1023, [0, 1], cuda), INF, cuda)
    W = buf.view(torch.int32)[:, :fr.B].cpu()
    assert int(W[fr.B - 2, fr.B - 1]) == 1023        # s = 0 to t = 1023
    assert int(W[fr.B - 2].masked_fill(W[fr.B - 2] == INF, -1).max()) == 1024


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["card", "edges_l2", "all_l2"])
def test_local_eval_kernel_past_shared_memory(cuda, plan, monkeypatch):
    """A dense fragment pair whose edges (8 bytes each) exceed a block's
    shared memory is read through L2; forced plans put the edges, or the
    edges and the BFS state, in device memory on any fragment."""
    g = erdos_renyi(3000, 80000, n_labels=2, seed=4)
    fr = fragment_graph(g, random_partition(g, 2, seed=4), 2)
    assert 8 * fr.e_max > 232448
    if plan != "card":
        state = plan == "edges_l2"
        monkeypatch.setattr(leops, "_plan", lambda n_max, E, limit: leops.Plan(
            state, False, 12 * (n_max + 1) if state else 0))
    leops._card_plan.cache_clear()
    try:
        _le_check(fr, [(7, 2999)], [0, 1], [None, INF, 2], cuda)
    finally:
        leops._card_plan.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("h", [63, 64, 65, 200])
def test_local_eval_kernel_around_the_hit_list(cuda, h):
    """A source that reaches h stubs, so that its row takes h patched
    columns; ten launches each, since a race between the warps that stream
    the rows and the threads that patch them would show in some only."""
    n = 2 * h + 2
    g = Graph(n, np.zeros(h, dtype=np.int64), np.arange(h + 2, 2 * h + 2),
              np.zeros(n, dtype=np.int32))
    fr = fragment_graph(g, (np.arange(n) > h).astype(np.int64), 2)
    assert fr.B == h + 2
    for _ in range(10):
        _le_check(fr, [(0, 1)], [0, 1], [None, INF, 1], cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("frags", [[3], [0, 2, 5, 7]], ids=["F1", "F4"])
def test_local_eval_kernel_on_a_ranks_fragments(cuda, frags):
    """F = 1 and F = 4 of 8 fragments, as a sharded rank holds them: the
    other fragments' rows hold the semiring zero; s and t absent from some
    or all of the fragments."""
    g = erdos_renyi(4000, 16000, n_labels=3, seed=9)
    fr = fragment_graph(g, random_partition(g, 8, seed=9), 8,
                        reserve_boundary=5)
    rng = np.random.default_rng(9)
    pairs = [tuple(int(x) for x in p) for p in rng.integers(0, g.n, (3, 2))]
    _le_check(fr, pairs, frags, [None, INF, 0, 3], cuda)


# ---------------------------------------------------------------------------
# W as row lists on the card: localEval's row-list route and the settle
# kernel over the lists
# ---------------------------------------------------------------------------

def _lists_sets(lists):
    """Row -> the set of (column, distance) pairs its list holds, on the
    host, with the counts and meta."""
    count = lists.count.cpu()
    pairs = lists.pairs.cpu()
    out = {}
    for r in torch.nonzero(count)[:, 0].tolist():
        got = {tuple(p) for p in pairs[r, :int(count[r])].tolist()}
        assert len(got) == int(count[r]), r
        out[r] = got
    return out, count, lists.meta.tolist()


def _le_lists_kernel(fr, args, cap, cuda):
    """The row-list route on the card with the recorder off: one launch of
    the row-list kernel and no host sync."""
    lists = row_lists(fr.B, cuda)
    before = (leops.launches, leops.list_launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert engine.local_eval_dist(*args, cap, n_max=fr.n_max, B=fr.B,
                                      out=lists) is lists
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (leops.launches, leops.list_launches) == (before[0] + 1,
                                                     before[1] + 1)
    return lists


def _le_lists_check(fr, pairs, frags, caps, cuda):
    """The card's row lists hold, row for row, the entry sets of the plain
    version's (on the CPU), with the same counts and meta; where a row did
    not fit, the same flags and counts, and a subset of its entries."""
    for s, t in pairs:
        card = _le_args(fr, s, t, frags, cuda)
        host = _le_args(fr, s, t, frags, "cpu")
        for cap in caps:
            got, count, meta = _lists_sets(_le_lists_kernel(fr, card, cap,
                                                            cuda))
            rows, block = engine.local_eval_dist(*host, cap, n_max=fr.n_max,
                                                 B=fr.B)
            want, want_count, want_meta = _lists_sets(write_row_lists(
                row_lists(fr.B, "cpu"), rows, block))
            assert meta == want_meta and torch.equal(count, want_count), \
                (s, t, cap)
            finite = {int(r): {(int(c), int(block[i, c]))
                               for c in torch.nonzero(block[i] < INF)[:, 0]}
                      for i, r in enumerate(rows)}
            for r, entries in got.items():
                full = len(finite[r]) > tops.ROW_CAP
                assert entries <= finite[r] if full else \
                    entries == want[r], (s, t, cap, r)
            assert set(got) == set(want), (s, t, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("frags", [[3], [0, 2, 5, 7], list(range(8))],
                         ids=["F1", "F4", "F8"])
def test_local_eval_lists_kernel_matches_plain(cuda, frags):
    """The row-list route on 1, 4 and 8 of 8 fragments (spare boundary
    rows among them), exact and capped at 0, 1 and 6, s or t a boundary
    node and s == t: the plain version's entry sets row for row."""
    g = erdos_renyi(4000, 16000, n_labels=3, seed=9)
    fr = fragment_graph(g, random_partition(g, 8, seed=9), 8,
                        reserve_boundary=5)
    rng = np.random.default_rng(19)
    pairs = [tuple(int(x) for x in p) for p in rng.integers(0, g.n, (2, 2))]
    b = [int(x) for x in fr.bnodes]
    pairs += [(b[0], pairs[0][1]), (pairs[0][0], b[-1]), (b[1], b[1])]
    _le_lists_check(fr, pairs, frags, [INF, 0, 1, 6], cuda)


@pytest.mark.gpu
def test_local_eval_lists_kernel_at_the_cells_size(cuda):
    """The one-shot cell's graph: the row lists, written out, are the W of
    the dense route, exact and capped at 6, and meta counts its finite
    entries."""
    g = erdos_renyi(32768, 131072, n_labels=8, seed=0)
    fr = fragment_graph(g, random_partition(g, 16, seed=0), 16)
    B = fr.B
    rng = np.random.default_rng(7)
    for s, t in rng.integers(0, g.n, (2, 2)).tolist():
        args = _le_args(fr, s, t, list(range(16)), cuda)
        for cap in (INF, 6):
            W = padded_i32(B, B, cuda)
            engine.local_eval_dist(*args, cap, n_max=fr.n_max, B=B, out=W)
            lists = _le_lists_kernel(fr, args, cap, cuda)
            live = (torch.arange(tops.ROW_CAP, device=cuda)[None, :]
                    < lists.count[:, None])
            rows = torch.arange(B, device=cuda)[:, None].expand(
                B, tops.ROW_CAP)[live]
            got = torch.full((B, B), INF, dtype=torch.int32, device=cuda)
            got[rows, lists.pairs[:, :, 0][live].long()] = \
                lists.pairs[:, :, 1][live]
            assert torch.equal(got, W), (s, t, cap)
            assert lists.meta.tolist() == [0, int((W < INF).sum())]
            del W, got


@pytest.mark.gpu
@pytest.mark.parametrize("h", [tops.ROW_CAP - 1, tops.ROW_CAP,
                               tops.ROW_CAP + 1, 200])
def test_local_eval_lists_kernel_flags_a_full_row(cuda, h):
    """A source that reaches h stubs: past ROW_CAP the row keeps ROW_CAP
    of its entries and the flag is set, as the plain version sets it; ten
    launches each, as the appends race."""
    n = 2 * h + 2
    g = Graph(n, np.zeros(h, dtype=np.int64), np.arange(h + 2, 2 * h + 2),
              np.zeros(n, dtype=np.int32))
    fr = fragment_graph(g, (np.arange(n) > h).astype(np.int64), 2)
    for _ in range(10):
        _le_lists_check(fr, [(0, 1)], [0, 1], [INF, 1], cuda)


@pytest.mark.gpu
def test_local_eval_lists_kernel_flags_a_far_entry(cuda):
    """The 1024-node chain: distances past the settle kernel's ring set
    OVER_HOPS, as in the plain version; capped below the ring they do
    not."""
    fr = _le_chain_graph()
    args = _le_args(fr, 0, 1023, [0, 1], cuda)
    lists = _le_lists_kernel(fr, args, INF, cuda)
    assert int(lists.meta[0]) & tops.OVER_HOPS
    lists = _le_lists_kernel(fr, args, tops.RING - 1, cuda)
    assert not int(lists.meta[0]) & tops.OVER_HOPS


def _lists_on(W, device):
    Wt = torch.tensor(W, device=device)
    return write_row_lists(row_lists(W.shape[0], device),
                           torch.arange(W.shape[0], device=device), Wt)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2, 300, 1037, 5185])
def test_settle_lists_on_card_matches_plain(cuda, B):
    """min_plus_settle_lists on the card, on the lists of random W with zero
    entries and of the same W with every weight tripled (empty levels):
    its whole state equal to the plain row-list version's, whose first
    three words are min_plus_settle_ref's on W, for bounds None, 0, 1, 6
    and past INF, the source's own row as a target once; one launch a
    call, no host sync; engine.evaldg_dist on the lists answers alike."""
    rng = np.random.default_rng(B + 41)
    W = _dist_matrix(rng, B, B, 3.0 / B)
    for Wn in (W, np.where(W < INF, 3 * W, INF).astype(np.int32)):
        Wt = torch.tensor(Wn)
        lists, host = _lists_on(Wn, cuda), _lists_on(Wn, "cpu")
        for trial in range(3):
            src = np.zeros(B, dtype=bool)
            src[rng.integers(B)] = True
            tgt = src.copy() if trial == 2 else rng.random(B) < 0.05
            d0 = torch.tensor(np.where(src, 0, INF).astype(np.int32))
            srcc, tgtc = torch.tensor(src, device=cuda), torch.tensor(
                tgt, device=cuda)
            for bound in (None, 0, 1, 6, 1 << 40):
                dense = min_plus_settle_ref(d0, Wt, torch.tensor(tgt), bound)
                want = min_plus_settle_lists_ref(torch.tensor(src), host,
                                                 torch.tensor(tgt), bound)
                assert want.tolist()[:3] == dense.tolist()
                before = tops.settle_list_launches
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got = min_plus_settle_lists(srcc, lists, tgtc, bound)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                assert tops.settle_list_launches == before + 1
                assert torch.equal(got.cpu(), want), (trial, bound)
                assert engine.evaldg_dist(lists, srcc, tgtc, bound=bound) \
                    == int(want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1024, 1037])
def test_settle_lists_on_a_chain(cuda, B):
    """A chain walked one level a hop, past the ring of buckets many times:
    the rows up to the target and no further, a stop past the bound, and
    with no target every row once, B levels in one launch."""
    W = np.full((B, B), INF, dtype=np.int32)
    W[np.arange(B - 1), np.arange(1, B)] = 1
    lists = _lists_on(W, cuda)
    src = torch.zeros(B, dtype=torch.bool, device=cuda)
    src[0] = True
    end = torch.zeros(B, dtype=torch.bool, device=cuda)
    end[B - 1] = True
    assert min_plus_settle_lists(src, lists, end).tolist() == \
        [B - 1, B - 1, B - 1, 0, B - 1]
    assert min_plus_settle_lists(src, lists, end, 6).tolist() == \
        [INF, 7, 7, 0, B - 1]
    assert min_plus_settle_lists(src, lists, torch.zeros_like(end)
                                 ).tolist() == [INF, B, B, 0, B - 1]


@pytest.mark.gpu
@pytest.mark.parametrize("bound", [None, 6])
def test_one_shot_dist_past_the_row_lists_on_card(cuda, bound):
    """Two fragments of a dense graph, whose rows overflow the row lists:
    the card answers as the CPU does, through the dense route, and counts
    the fallback once a query."""
    from repro_torch import tracing
    g = erdos_renyi(160, 2400, n_labels=4, seed=7)
    fr = fragment_graph(g, random_partition(g, 2, seed=7), 2)
    queries = [Dist(3, 100, bound=bound), Dist(50, 7, bound=bound),
               Dist(int(fr.bnodes[0]), int(fr.bnodes[-1]), bound=bound)]

    def traced(device):
        tracing.enable()
        try:
            out = repro_torch.connect(fr, cache="none",
                                      device=device).run(queries)
        finally:
            tracing.disable()
        return out, [r.counts for r in tracing.drain()
                     if r.kind == "span" and r.name == "oneshot.query"]
    want, on_cpu = traced("cpu")
    before = (tops.settle_launches, tops.settle_list_launches)
    got, on_card = traced(None)
    assert [(r.answer, r.distance) for r in got] == \
        [(r.answer, r.distance) for r in want]
    fell = [c.get("oneshot.dense_fallbacks", 0) for c in on_card]
    assert fell == [c.get("oneshot.dense_fallbacks", 0) for c in on_cpu]
    assert sum(fell) > 0 or bound is not None
    assert (tops.settle_launches - before[0],
            tops.settle_list_launches - before[1]) == (sum(fell),
                                                       len(queries))


@pytest.mark.gpu
def test_traced_one_shot_query_on_card(cuda):
    """A traced one-shot query on the card: one localEval launch (for a
    dist query the row-list route, then one launch of the row-list settle
    kernel), at most two host syncs (the deepest level read back,
    evalDG's answer), and both again on the dense route for a query whose
    W overflowed the lists, as on the CPU; the same ``fixpoint.steps`` as
    the CPU's host loop, and the same ``evaldg.rows``, ``evaldg.levels``
    and ``oneshot.w_entries`` as the CPU's plain search."""
    from repro_torch import tracing
    g = erdos_renyi(600, 2400, n_labels=3, seed=8)
    fr = fragment_graph(g, random_partition(g, 4, seed=8), 4)
    queries = [Reach(3, 500), Dist(3, 500), Dist(7, 9, bound=2)]

    def traced(device):
        tracing.enable()
        try:
            out = repro_torch.connect(fr, cache="none",
                                      device=device).run(queries)
        finally:
            tracing.disable()
        spans = [r for r in tracing.drain() if r.kind == "span"]
        return out, *([r for r in spans if r.name == name]
                      for name in ("oneshot.query", "oneshot.local_eval"))
    want, on_host, on_cpu = traced("cpu")
    before = (leops.launches, leops.list_launches, tops.settle_list_launches)
    got, queried, on_card = traced(None)
    fell = [q.counts.get("oneshot.dense_fallbacks", 0) for q in queried]
    assert fell == [q.counts.get("oneshot.dense_fallbacks", 0)
                    for q in on_host]
    assert (leops.launches, leops.list_launches,
            tops.settle_list_launches) == (
        before[0] + len(queries) + sum(fell), before[1] + 2, before[2] + 2)
    assert [(r.answer, r.distance) for r in got] == \
        [(r.answer, r.distance) for r in want]
    assert len(queried) == len(queries)
    assert len(on_card) == len(queries) + sum(fell)
    for query, again in zip(queried, fell):
        assert query.counts["oneshot.local_launches"] == 1 + again
        assert query.counts["host.syncs"] <= 2 + 2 * again
    for card, host in zip(on_card, on_cpu):
        assert card.counts["host.syncs"] == 1
        assert card.counts["fixpoint.steps"] == \
            host.counts["fixpoint.steps"] > 0
    for card, host in zip(queried[1:], on_host[1:]):
        for name in ("evaldg.rows", "evaldg.levels", "oneshot.w_entries"):
            assert card.counts[name] == host.counts[name] > 0, name


@pytest.mark.gpu
def test_failed_delta_rolls_back_on_card(cuda, monkeypatch):
    """A delta that fails inside the Boolean rank update, after the
    frontiers and the distance closure were rebound on the card (the
    repair updates the distance closure first), rolls back: versions,
    answers and every cache tensor (the same objects, their contents held
    against clones) are as before."""
    from repro_torch import DeltaApplyFailed
    g = erdos_renyi(400, 1400, n_labels=3, seed=11)
    fr = fragment_graph(g, random_partition(g, 4, seed=11), 4,
                        reserve_boundary=16, reserve_edges=32,
                        reserve_stubs=16)
    sess = repro_torch.connect(fr).warm(with_dist=True)
    rng = np.random.default_rng(11)
    queries = [Dist(int(s), int(t)) for s, t in rng.integers(0, g.n, (32, 2))]
    before = [(r.answer, r.distance) for r in sess.run(queries)]
    cache = fr.rvset_cache
    names = ("bl_frontier", "closure", "closure_t", "bl_dist", "dist_closure")
    held = {n: (getattr(cache, n), getattr(cache, n).clone()) for n in names}
    versions = (fr.arrays_version, sess.cache_version)

    def broken(*args):
        raise RuntimeError("injected")

    monkeypatch.setattr(incremental, "_rank_update_bool", broken)
    monkeypatch.setattr(incremental, "changed_row_ids",
                        lambda fr, dirty: np.arange(fr.nb_active))
    mine = np.nonzero(fr.part == 0)[0]
    with pytest.raises(DeltaApplyFailed):
        sess.apply(GraphDelta.insert([(int(mine[i]), int(mine[-1 - i]))
                                      for i in range(8)]))
    assert (fr.arrays_version, sess.cache_version) == versions
    assert fr.rvset_cache is cache and sess.stats.rollbacks == 1
    for n, (obj, copy) in held.items():
        assert getattr(cache, n) is obj and torch.equal(obj, copy), n
    assert [(r.answer, r.distance) for r in sess.run(queries)] == before


def _check_served(graphs, futs):
    """Every future DONE and equal to the host BFS of its version."""
    from repro_torch.graph import bfs_distances
    for f in futs:
        assert f.status == "done", (f, f.error)
        d = int(bfs_distances(graphs[f.cache_version], f.s)[f.t])
        want = {"reach": d >= 0, "dist": d if d >= 0 else None,
                "bounded": 0 <= d <= 3}[f.kind]
        assert f.value == want, f


@pytest.mark.gpu
@pytest.mark.parametrize("mvcc", [False, True], ids=["barrier", "mvcc"])
def test_query_server_on_card(cuda, mvcc):
    """A warm QueryServer on the card (no device= given): one flush of
    mixed requests around a repair delta, answers equal to the host BFS
    of their version, both kernels launched, no operand copied."""
    from repro_torch.graph import Graph
    from repro_torch.serve import QueryServer
    g = erdos_renyi(400, 1400, n_labels=3, seed=12)
    fr = fragment_graph(g, random_partition(g, 4, seed=12), 4,
                        reserve_boundary=16, reserve_edges=32,
                        reserve_stubs=16)
    srv = QueryServer(fr, with_dist=True, batch_size=32, start=False,
                      mvcc=mvcc)
    assert srv.session.device.type == "cuda"
    rng = np.random.default_rng(12)
    mine = np.nonzero(fr.part == 0)[0]
    delta = GraphDelta.insert([(int(rng.choice(mine)), int(rng.choice(mine)))
                               for _ in range(4)])
    v0 = srv.session.cache_version
    graphs = {v0: g, v0 + 1: Graph(g.n, np.concatenate([g.src,
                                                        delta.add_src]),
                                   np.concatenate([g.dst, delta.add_dst]),
                                   g.labels)}
    kinds = ("reach", "dist", "bounded")

    def submit(count):
        return [srv.submit(int(s), int(t), kind=kinds[i % 3],
                           bound=3 if i % 3 == 2 else None)
                for i, (s, t) in enumerate(rng.integers(0, g.n, (count, 2)))]

    bops.launches = tops.launches = tops.copies = 0
    futs = submit(48)
    upd = srv.submit_delta(delta)
    futs += submit(48)
    srv.flush()
    futs += submit(24)                   # after the commit point
    srv.flush()
    srv.close()
    torch.cuda.synchronize()
    assert upd.status == "applied" and upd.value.mode == "repair"
    _check_served(graphs, futs)
    assert {f.cache_version for f in futs} == {v0, v0 + 1}
    assert bops.launches > 0 and tops.launches > 0 and tops.copies == 0
    assert srv.retries == 0 and not srv.dead_letters
    assert srv.session.stats.degraded_groups == 0


@pytest.fixture
def nccl_rank(cuda, tmp_path):
    """A one-rank NCCL process group on the card, destroyed after."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_repair_on_card_matches_host_repair(nccl_rank):
    """apply on a shard_map session (one NCCL rank, every fragment on the
    card) is a sharded repair with one collective of traffic_bits_update
    bits, B1 launched, and leaves the closure, its K-major copy and
    bl_frontier bit-equal to the host repair of the same deltas."""
    from repro_torch.core import distributed as D
    g = erdos_renyi(400, 1400, n_labels=3, seed=13)
    part = random_partition(g, 8, seed=13)
    reserve = dict(reserve_boundary=16, reserve_edges=32, reserve_stubs=16)
    on_host, sharded = (fragment_graph(g, part, 8, **reserve)
                        for _ in range(2))
    host = repro_torch.connect(on_host).warm()
    sess = repro_torch.connect(sharded, backend="shard_map").warm()
    rng = np.random.default_rng(13)
    for f in (0, 3, 5):
        mine = np.nonzero(part == f)[0]
        other = np.nonzero(part != f)[0]
        delta = GraphDelta.insert(
            [(int(rng.choice(mine)), int(rng.choice(mine))) for _ in range(4)]
            + [(int(rng.choice(mine)), int(rng.choice(other)))])
        host.apply(delta)
        D.collectives = D.payload_bits = bops.launches = 0
        st = sess.apply(delta)
        assert st.mode == "repair_sharded" and st.changed_rows > 0
        r = len(incremental.pad_row_ids(np.arange(st.changed_rows),
                                        cap=sharded.n_boundary))
        assert D.collectives == 1
        assert D.payload_bits == sharded.traffic_bits_update(r)
        assert bops.launches >= 4          # T, the r x r closure, left, P
        for name in ("bl_frontier", "closure", "closure_t"):
            t = getattr(sharded.rvset_cache, name)
            assert t.is_cuda and torch.equal(
                t, getattr(on_host.rvset_cache, name)), name
        pairs = rng.integers(0, g.n, size=(32, 2))
        queries = [Reach(int(s), int(t)) for s, t in pairs]
        assert [r.answer for r in sess.run(queries)] == \
            [r.answer for r in host.run(queries)]


@pytest.mark.gpu
def test_mr_drpq_on_card_matches_one_shot_rpq(cuda):
    """mr_drpq on the card (a reduced graph) answers as the one-shot RPQ
    does, its reducer one launch of B1's fixpoint kernel, with the
    reference's cost-model counts."""
    from repro_torch.core.automaton import build_query_automaton
    from repro_torch.core.mapreduce import mr_drpq
    from repro_torch.core.session import exec_rpq
    g = erdos_renyi(512, 2048, n_labels=4, seed=14)
    fr = fragment_graph(g, random_partition(g, 8, seed=14), 8)
    qa = build_query_automaton("(0|1)* 2", int)
    rng = np.random.default_rng(14)
    answers = []
    for s, t in rng.integers(0, g.n, size=(6, 2)):
        s, t = int(s), int(t)
        bops.launches = bops.fixpoint_launches = 0
        got = mr_drpq(fr, s, t, qa)
        assert (bops.fixpoint_launches, bops.launches) == \
            ((0, 0) if s == t else (1, 0))
        assert got.answer == exec_rpq(fr, s, t, qa).answer
        assert got == mr_drpq(fr, s, t, qa, device="cpu")
        answers.append(got.answer)
    assert len(answers) == 6


@pytest.mark.gpu
def test_baselines_on_card_match_cpu(cuda):
    from repro_torch.core.baselines import dis_reach_m, dis_reach_n
    g = erdos_renyi(300, 900, seed=15)
    fr = fragment_graph(g, random_partition(g, 4, seed=15), 4)
    for s, t in np.random.default_rng(15).integers(0, g.n, size=(8, 2)):
        for fn in (dis_reach_n, dis_reach_m):
            assert fn(fr, int(s), int(t)) == fn(fr, int(s), int(t),
                                                device="cpu")


# ---------------------------------------------------------------------------
# the LM family on the card
# ---------------------------------------------------------------------------

def _lm_smoke(arch_id="qwen2-1.5b", **kw):
    import dataclasses
    from repro_torch.configs import LM_ARCHS
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(LM_ARCHS[arch_id].smoke_cfg, **kw)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return cfg, params


def _to(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to(device), tree)


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_lm_forward_and_decode_on_card_match_cpu(cuda, arch_id):
    from repro_torch.models import transformer as T
    cfg, params = _lm_smoke(arch_id)
    toks = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab, (2, 10)))
    with torch.no_grad():
        want, aux = T.forward(cfg, params, toks)
        got, aux_c = T.forward(cfg, _to(params, cuda), toks.to(cuda))
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=2e-4, rtol=2e-3)
        np.testing.assert_allclose(aux_c.cpu().numpy(), aux.numpy(),
                                   atol=2e-4, rtol=2e-3)
        caches = (T.init_cache(cfg, 2, 16, device="cpu"),
                  T.init_cache(cfg, 2, 16, device=cuda))
        for i in range(10):
            pos = torch.full((2,), i)
            lg, _ = T.decode_step(cfg, params, caches[0], toks[:, i], pos)
            lg_c, _ = T.decode_step(cfg, _to(params, cuda), caches[1],
                                    toks[:, i].to(cuda), pos.to(cuda))
            np.testing.assert_allclose(lg_c.cpu().numpy(), lg.numpy(),
                                       atol=2e-4, rtol=2e-3)


@pytest.mark.gpu
def test_serve_engine_on_card_matches_cpu(cuda):
    from repro_torch.serve import Request, ServeEngine
    cfg, params = _lm_smoke(kv_quant_int8=True, decode_chunk=8)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (3, 7, 1, 5)]
    out = [[r.generated for r in ServeEngine(
        cfg, params, batch=2, max_len=16, device=dev).generate(
            [Request(prompt=p, max_new_tokens=5) for p in prompts])]
        for dev in ("cpu", None)]
    assert out[0] == out[1]


def _train_step(device, params, cfg, tmp_path):
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path / str(device)),
                               grad_accum=2),
                 adamw.AdamWConfig(lr=1e-3, warmup_steps=0),
                 lambda p, b: T.lm_loss(cfg, p, b["tokens"], b["targets"]),
                 params, device=device)
    batch = TokenStream(vocab=cfg.vocab, batch=4, seq_len=12,
                        device=device).batch_at(0)
    m = tr.step({k: v.reshape(2, 2, -1) for k, v in batch.items()})
    return float(m["loss"]), tr.state["params"]


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda, tmp_path):
    from repro_torch.tree import leaves
    cfg, params = _lm_smoke(remat=True)
    loss, want = _train_step("cpu", params, cfg, tmp_path)
    loss_c, got = _train_step("cuda", params, cfg, tmp_path)
    assert abs(loss - loss_c) < 1e-4
    for a, b in zip(leaves(want), leaves(got)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.gpu
def test_trainer_replay_on_card_is_bitwise(cuda, tmp_path, monkeypatch):
    """Crash at step 7, restore, replay: bit-equal to a clean run on the
    card.  That needs deterministic kernels: the test sets
    ``torch.use_deterministic_algorithms(True)`` and
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which PyTorch requires with it,
    and restores both.  Other tests of the session may have started
    cuBLAS before the variable was set; chip_smoke.py runs the same
    replay in a process that has it from the start."""
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import leaves
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg, params = _lm_smoke()
    stream = TokenStream(vocab=cfg.vocab, batch=4, seq_len=12)

    def run(path, fail):
        tr = Trainer(TrainerConfig(ckpt_dir=str(path), ckpt_every=5,
                                   ckpt_async=False),
                     adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                       total_steps=20),
                     lambda p, b: T.lm_loss(cfg, p, b["tokens"],
                                            b["targets"]), params)
        fired = []

        def hook(step):
            if fail and step == 7 and not fired:
                fired.append(step)
                raise RuntimeError("simulated node failure")
        tr.run(stream.batch_at, 10, fail_hook=hook)
        return tr

    torch.use_deterministic_algorithms(True)
    try:
        clean, failed = run(tmp_path / "a", False), run(tmp_path / "b", True)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(leaves(clean.state["params"]),
                    leaves(failed.state["params"])):
        assert torch.equal(a, b)
    assert int(failed.state["step"]) == 10


@pytest.mark.gpu
def test_segment_ops_on_card_match_cpu(cuda):
    """The GNN substrate's segment ops and the embedding bags on the card
    against their CPU results (the card's atomic sums add in another
    order: f32 within 1e-5)."""
    from repro_torch.models.gnn import common
    from repro_torch.recsys import embedding_bag
    rng = np.random.default_rng(18)
    n, e = 300, 2000
    s, r = rng.integers(0, n - 10, e), rng.integers(0, n - 10, e)
    graphs = [common.pad_graph(s, r, n - 5, e + 48, n, device=dev)
              for dev in ("cpu", cuda)]
    msgs = torch.from_numpy(rng.normal(size=(e + 48, 6)).astype(np.float32))
    table = torch.from_numpy(rng.normal(size=(40, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 40, 500))
    bags = torch.from_numpy(np.sort(rng.integers(0, 64, 500)))
    w = torch.from_numpy(rng.normal(size=500).astype(np.float32))

    def run(g, dev):
        out = [common.segment_mp(msgs.to(dev), g.receivers, n, red)
               for red in ("sum", "max", "mean")]
        out.append(common.edge_softmax(msgs[:, :3].to(dev), g.receivers,
                                       g.edge_mask, n))
        out += [embedding_bag(table.to(dev), ids.to(dev), bags.to(dev), 70,
                              mode, weights=w.to(dev))
                for mode in ("sum", "mean", "max")]
        return out

    for want, got in zip(run(graphs[0], "cpu"), run(graphs[1], cuda)):
        assert got.is_cuda
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_bert4rec_score_topk_on_card_matches_torch_topk(cuda):
    """score_topk on the card (chunked, one- and two-stage) against
    torch.topk of score_next on the same chunks of rows (cuBLAS may round
    a product of another shape differently): equal values, and equal item
    ids wherever the row has no tied score among its top k + 1."""
    import dataclasses
    from repro_torch.models import bert4rec as B
    cfg = dataclasses.replace(B.Bert4RecConfig(), n_items=20_000,
                              seq_len=32)
    params = B.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    items = torch.randint(2, cfg.n_items, (96, cfg.seq_len), device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(1))
    with torch.no_grad():
        scores = torch.cat([B.score_next(cfg, params, items[lo:lo + 40])
                            for lo in range(0, len(items), 40)])
        want_v, want_i = torch.topk(scores, 51)
        for ways in (0, 16):
            v, i = B.score_topk(dataclasses.replace(cfg, topk_ways=ways),
                                params, items, k=50, chunk=40)
            assert torch.equal(v, want_v[:, :50])
            assert torch.equal(torch.gather(scores, 1, i), v)
            untied = (want_v[:, 1:] != want_v[:, :-1]).all(dim=1)
            assert torch.equal(i[untied], want_i[untied, :50])


@pytest.mark.gpu
def test_reduced_cell_on_card_matches_cpu(cuda):
    """The reduced qwen2-1.5b train_4k cell: one step on the card equal to
    the same step on the CPU (f32, within 1e-4 of each output's scale), at
    an optimizer step past the warm-up, where the update of params, m and
    v is held within tests/torch_update.py's UPDATE_TOL of its scale."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.families.base import zeros_from_abstract
    from repro_torch.tree import leaves, tree_map
    from torch_update import UPDATE_TOL, at_step, update_errors
    prog = get_arch("qwen2-1.5b").build("train_4k", reduced=True)
    args = zeros_from_abstract(prog.abstract_args, seed=2, device="cpu")
    args = at_step(args)
    want = prog.step_fn(*args)
    got = prog.step_fn(*tree_map(lambda x: x.to(cuda), args))
    for g, w in zip(leaves(got), leaves(want)):
        assert g.is_cuda and g.dtype == w.dtype
        if w.dtype.is_floating_point:
            scale = w.abs().max().item()
            assert (g.cpu() - w).abs().max().item() <= 1e-4 * scale
        else:
            assert torch.equal(g.cpu(), w)
    for path, err in update_errors(args, got, want).items():
        assert err <= UPDATE_TOL, (path, err)
