"""The min-plus kernel's operand layout and route choice on the CPU: int32
matrices in padded storage (rows 16 bytes apart), the copy counter, the
skinny / tile dispatch, the fused floor ``init=`` against the JAX package's
Pallas kernel (interpret mode, as tests/test_kernels.py runs it), and the
paths' functions on padded operands, bit-equal to the JAX functions.

The kernel reads its operands 16 bytes at a time; the wrapper prepares
them in plain PyTorch, which is what these tests reach.  The kernel itself
is held against the same plain version by tests/test_torch_gpu.py on the
card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bes as jbes
from repro.core import cache as jcache
from repro.core import engine as jengine
from repro.core import incremental as jinc
from repro.kernels.tropical_matmul import min_plus_chunked, tropical_matmul
import repro_torch
from repro_torch import Dist
from repro_torch.core import bes as tbes
from repro_torch.core import cache as tcache
from repro_torch.core import engine as tengine
from repro_torch.core import incremental as tinc
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import erdos_renyi, random_partition
from repro_torch.kernels.tropical_matmul import ops as tops
from repro_torch.kernels.tropical_matmul import (INF, min_plus_fixpoint,
                                                 min_plus_matmul,
                                                 min_plus_matmul_ref)
from repro_torch.kernels.tropical_matmul.ops import (
    ALIGN, SKINNY_MAX_M, SKINNY_MIN_K, SKINNY_THREADS, Route, _route,
    aligned, is_aligned, padded_i32, pitch_i32)

# ragged and aligned widths, a single row or column, and empty matrices
LAYOUT_SHAPES = [(0, 0), (0, 5), (5, 0), (1, 1), (7, 33), (16, 16), (3, 17),
                 (40, 129)]
# products around the skinny / tile threshold, K = 0 and a ragged K
SHAPES = [(1, 200, 33), (2, 64, 7), (7, 33, 9), (64, 130, 65), (65, 40, 12),
          (128, 128, 128), (130, 257, 5), (5, 0, 7), (1, 1, 1)]


def _storage(x):
    """The [rows, pitch] storage behind a padded view."""
    return x.as_strided((x.shape[0], x.stride(0)), (x.stride(0), 1))


def _dist(rng, shape, density=0.5, top=50):
    """int32 distances in [0, top) where present, INF elsewhere."""
    x = rng.integers(0, top, shape).astype(np.int32)
    x[rng.random(shape) >= density] = INF
    return x


def _padded(x: np.ndarray) -> torch.Tensor:
    return padded_i32(*x.shape, "cpu").copy_(torch.tensor(x))


def _views(rows, cols, rng):
    """The same [rows, cols] values as a padded view, a contiguous tensor,
    a transposed view, a column slice, and a view at a 4-byte offset."""
    x = _dist(rng, (rows, cols))
    base = torch.tensor(x)
    wide = torch.zeros((rows, 2 * cols), dtype=torch.int32)
    wide[:, ::2] = base
    shifted = torch.zeros((rows + 1, cols + 5), dtype=torch.int32)
    shifted[1:, 1:cols + 1] = base
    return x, {"padded": _padded(x), "contiguous": base,
               "transposed": base.T.contiguous().T,
               "column_slice": wide[:, ::2],
               "offset": shifted[1:, 1:cols + 1]}


# ---------------------------------------------------------------------------
# padded storage and the copy counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", LAYOUT_SHAPES, ids=str)
def test_padded_i32_rows_start_16_bytes_apart(shape):
    rows, cols = shape
    p = padded_i32(rows, cols, "cpu")
    assert p.dtype == torch.int32 and tuple(p.shape) == shape
    assert p.stride() == (pitch_i32(cols), 1)
    assert pitch_i32(cols) % 4 == 0 and pitch_i32(cols) >= max(cols, 1)
    assert p.data_ptr() % ALIGN == 0 and is_aligned(p)
    assert _storage(p).shape == (rows, pitch_i32(cols))


@pytest.mark.parametrize("shape", LAYOUT_SHAPES, ids=str)
def test_aligned_copies_only_what_it_must(shape):
    rows, cols = shape
    x, views = _views(rows, cols, np.random.default_rng(rows * 131 + cols))
    for name, v in views.items():
        before = tops.copies
        out = aligned(v)
        np.testing.assert_array_equal(out.numpy(), x, err_msg=name)
        assert is_aligned(out), name
        if is_aligned(v):
            assert out is v and tops.copies == before, name
        else:
            assert out is not v and tops.copies == before + 1, name
            assert out.stride() == (pitch_i32(cols), 1), name
        # an aligned result is taken as it is
        before = tops.copies
        assert aligned(out) is out and tops.copies == before


def test_is_aligned_rejects_what_the_kernel_cannot_read():
    x = torch.zeros((4, 8), dtype=torch.int32)
    assert is_aligned(x)                         # pitch 32 bytes
    assert not is_aligned(torch.zeros((4, 5), dtype=torch.int32))
    assert not is_aligned(x[:, 1:])              # base 4 bytes off
    assert not is_aligned(x.T)                   # inner stride 8
    assert is_aligned(x[:, :5])                  # padded view of the rows
    # one row: any pitch, but the storage must hold its last 16 bytes
    assert is_aligned(torch.zeros((1, 8), dtype=torch.int32))
    assert not is_aligned(torch.zeros((1, 7), dtype=torch.int32))
    assert is_aligned(padded_i32(1, 7, "cpu"))
    assert is_aligned(padded_i32(3, 7, "cpu")[0][None, :])
    # a row pitch below the width overlaps the rows
    over = torch.zeros(64, dtype=torch.int32).as_strided((4, 8), (4, 1))
    assert not is_aligned(over)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,rows,cols", [(1, 1, 4), (2, 2, 4), (3, 4, 4),
                                         (33, 64, 2), (64, 64, 2)])
def test_route_takes_the_skinny_path_up_to_64_rows(M, rows, cols):
    for K, N in [(16041, 16041), (16103, 16103), (4099, 7), (64, 1)]:
        r = _route(M, K, N)
        assert r.kind == "skinny" and (r.rows, r.cols) == (rows, cols)
        assert r.rows >= M and r.rows * r.cols <= 128
        strips = -(-N // (SKINNY_THREADS * cols))
        # fills the card's slots once at most, each split >= SKINNY_MIN_K
        assert 1 <= r.split <= max(1, K // SKINNY_MIN_K)
        assert r.split == 1 or strips * r.split <= 132 * \
            tops.PER_SM_GUESS[rows]
        assert r.split == 1 or -(-K // r.split) >= SKINNY_MIN_K


def test_route_splits_to_fill_the_card():
    # evalDG's step: 32 strips of 512 columns, 5 blocks an SM
    r = _route(1, 16041, 16041, sms=132, per_sm=5)
    assert r == Route("skinny", 1, 4, 132 * 5 // 32)
    # the rank update's T: 63 strips of 256 columns, 3 blocks an SM
    assert _route(64, 16103, 16103, sms=132, per_sm=3) == \
        Route("skinny", 64, 2, 396 // 63)
    # a product with more strips than slots is not split
    assert _route(1, 4096, 1 << 20, sms=4, per_sm=1).split == 1


@pytest.mark.parametrize("M", [65, 256, 16039])
def test_route_takes_the_tile_path_above_64_rows(M):
    assert M > SKINNY_MAX_M
    assert _route(M, 16039, 16039) == Route("tile")
    assert _route(M, 0, 5).kind == "tile"


@pytest.mark.parametrize("M", [1, 7, 64])
def test_route_at_k_0_is_one_launch(M):
    r = _route(M, 0, 1000)
    assert r.kind == "skinny" and r.split == 1


# ---------------------------------------------------------------------------
# the fused floor against the JAX package
# ---------------------------------------------------------------------------

def _jax_product(a, b):
    """The JAX package's Pallas kernel; its chunked form at K = 0, where
    the Pallas grid has no block to take."""
    mp = tropical_matmul if a.shape[1] else min_plus_chunked
    return mp(jnp.asarray(a), jnp.asarray(b))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_floor_matches_pallas(shape):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a, b = _dist(rng, (m, k), 0.7), _dist(rng, (k, n), 0.7)
    init = _dist(rng, (m, n), 0.3, top=80)
    init[0, 0] = INF
    want = np.asarray(jnp.minimum(jnp.asarray(init), _jax_product(a, b)))
    ta, tb, ti = torch.tensor(a), torch.tensor(b), torch.tensor(init)
    for got in (min_plus_matmul_ref(ta, tb, ti),
                min_plus_matmul(_padded(a), _padded(b), init=_padded(init))):
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
        np.testing.assert_array_equal(got.numpy(), want)
    # without a floor: the plain product, INF where K = 0
    want = np.asarray(_jax_product(a, b))
    np.testing.assert_array_equal(min_plus_matmul_ref(ta, tb).numpy(), want)


def test_floor_is_read_never_written():
    rng = np.random.default_rng(5)
    a, b = torch.tensor(_dist(rng, (6, 9))), torch.tensor(_dist(rng, (9, 4)))
    init = torch.tensor(_dist(rng, (6, 4), 0.5, top=5))
    held = init.clone()
    out = min_plus_matmul(a, b, init=init)
    assert out.data_ptr() != init.data_ptr()
    assert torch.equal(init, held)
    assert torch.equal(out, torch.minimum(init, min_plus_matmul(a, b)))
    # a floor above INF is clipped, as the product is
    big = torch.full((6, 4), 2 * INF, dtype=torch.int32)
    assert int(min_plus_matmul(a[:, :0], b[:0], init=big).max()) == INF


def test_floor_rejects_bad_shapes():
    a = torch.zeros((3, 4), dtype=torch.int32)
    b = torch.zeros((4, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        min_plus_matmul(a, b, init=torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        min_plus_matmul(a, b, init=torch.zeros((3, 5), dtype=torch.int64))


# ---------------------------------------------------------------------------
# the paths' functions on padded operands, against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 9, 130])
def test_tropical_closure_on_padded_input(B):
    rng = np.random.default_rng(B)
    W = _dist(rng, (B, B), 3.0 / B, top=6)
    want = np.asarray(jbes.tropical_closure(jnp.asarray(W)))
    for given in (_padded(W), torch.tensor(W)):
        got = tbes.tropical_closure(given)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.stride() == (pitch_i32(B), 1) and is_aligned(got)


@pytest.mark.parametrize("B", [2, 37, 131])
def test_evaldg_dist_on_padded_input(B):
    rng = np.random.default_rng(B + 1)
    W = _dist(rng, (B, B), 3.0 / B, top=5)
    for trial in range(3):
        src = np.zeros(B, dtype=bool)
        src[rng.integers(B)] = True
        tgt = rng.random(B) < 0.2
        want = int(jengine.evaldg_dist(jnp.asarray(W), jnp.asarray(src),
                                       jnp.asarray(tgt)))
        assert tengine.evaldg_dist(_padded(W), torch.tensor(src),
                                   torch.tensor(tgt)) == want


@pytest.mark.parametrize("nb,r", [(37, 8), (130, 64), (20, 20)])
def test_rank_update_tropical_on_padded_input(nb, r):
    rng = np.random.default_rng(nb * 7 + r)
    Cd = np.asarray(jbes.tropical_closure(jnp.asarray(
        _dist(rng, (nb, nb), 2.0 / nb, top=6))))
    rows = _dist(rng, (r, nb), 3.0 / nb, top=6)
    idx = rng.choice(nb, size=r, replace=False)
    want = np.asarray(jinc._rank_update_tropical(
        jnp.asarray(Cd), jnp.asarray(rows), jnp.asarray(idx)))
    tCd = _padded(Cd)
    held = tCd.clone()
    got = tinc._rank_update_tropical(tCd, _padded(rows), idx)
    np.testing.assert_array_equal(got.numpy(), want)
    # a fresh tensor: rollback keeps a reference to the old closure
    assert got.data_ptr() != tCd.data_ptr() and torch.equal(tCd, held)


@pytest.mark.parametrize("N,nb", [(1, 5), (16, 37), (40, 130)])
def test_combine_dist_on_padded_input(N, nb):
    rng = np.random.default_rng(N * 100 + nb)
    Cd = np.asarray(jbes.tropical_closure(jnp.asarray(
        _dist(rng, (nb, nb), 2.0 / nb, top=6))))
    sb = _dist(rng, (N, nb), 0.3, top=6)
    tc = _dist(rng, (N, nb), 0.3, top=6)
    direct = _dist(rng, (N,), 0.2, top=20)
    want = np.asarray(jcache.combine_dist(*map(jnp.asarray,
                                               (direct, sb, tc, Cd))))
    got = tcache.combine_dist(torch.tensor(direct), _padded(sb),
                              torch.tensor(tc), _padded(Cd))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the paths hand the product nothing to copy
# ---------------------------------------------------------------------------

class _Spy:
    """Stands in for ``min_plus_matmul`` in the modules that call it, and
    for ``min_plus_fixpoint`` in the engine's evalDG, and records, per
    caller, whether every operand it was given (and the floor) can be read
    by the kernel as it is."""

    def __init__(self, monkeypatch):
        self.calls = {}
        for mod in (tbes, tcache, tinc):
            monkeypatch.setattr(mod, "min_plus_matmul", self._wrap(mod))

        def fixpoint(d0, W):
            self.calls.setdefault("engine", []).append(is_aligned(W))
            return min_plus_fixpoint(d0, W)
        monkeypatch.setattr(tengine, "min_plus_fixpoint", fixpoint)

    def _wrap(self, mod):
        name = mod.__name__.rsplit(".", 1)[1]

        def spy(a, b, init=None):
            ok = is_aligned(a) and is_aligned(b) and (
                init is None or is_aligned(init))
            self.calls.setdefault(name, []).append(ok)
            return min_plus_matmul(a, b, init=init)
        return spy


def test_paths_pass_aligned_operands(monkeypatch):
    """Cache build (closure squarings), composes, one-shot evalDG's
    fixpoint and a repair's rank update: every min-plus operand is already
    in the kernel's layout, so on the card none is copied."""
    spy = _Spy(monkeypatch)
    g = erdos_renyi(24, 40, n_labels=3, seed=7)
    fr = fragment_graph(g, random_partition(g, 4, 7), 4, reserve_boundary=8,
                        reserve_edges=24, reserve_stubs=12)
    assert fr.n_boundary % 4 != 0              # ragged rows
    sess = repro_torch.connect(fr, device="cpu").warm(with_dist=True)
    rng = np.random.default_rng(1)
    pairs = rng.integers(0, g.n, size=(12, 2))
    sess.run([Dist(int(s), int(t)) for s, t in pairs])
    repro_torch.connect(fr, cache="none", device="cpu").run(
        [Dist(int(s), int(t)) for s, t in pairs[:3] if s != t])
    cross = np.nonzero(fr.part[g.src] != fr.part[g.dst])[0]
    u = int(g.src[cross[0]])
    mine = np.nonzero(fr.part == fr.part[u])[0]
    v = int(next(x for x in mine if x != u))
    stats = sess.apply(repro_torch.GraphDelta.insert([(v, u)]))
    assert stats.mode == "repair" and stats.changed_rows > 0
    assert set(spy.calls) == {"bes", "cache", "engine", "incremental"}
    for name, oks in spy.calls.items():
        assert all(oks), name
