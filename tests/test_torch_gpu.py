"""The CUDA kernels on the card: each held bit-equal to its plain PyTorch
version, and the session on the card equal to the session on the CPU.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import Dist, Reach, Rpq
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import erdos_renyi, random_partition
from repro_torch.kernels.bitpack_ops import ops as pops
from repro_torch.kernels.bitpack_ops import (bitpack_matmul,
                                             bitpack_matmul_ref, pack_cols,
                                             pack_rows, pack_rows_ref)
from repro_torch.core.bes import bool_closure_kmajor
from repro_torch.kernels.bool_matmul import ops as bops
from repro_torch.kernels.bool_matmul import (or_and_matmul, or_and_matmul_nt,
                                             or_and_matmul_ref, pitch)
from repro_torch.kernels.tropical_matmul import ops as tops
from repro_torch.kernels.tropical_matmul import (INF, min_plus_matmul,
                                                 min_plus_matmul_ref)

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
