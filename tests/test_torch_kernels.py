"""The port's semiring products, word packing and closures vs the JAX
package's Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py runs them).

Boolean and int32 results must be bit-equal: these semirings do not round.
On the CPU the port's wrappers take their plain PyTorch versions; the
CUDA kernels themselves are held against the same plain versions by
tests/test_torch_gpu.py on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bes as jbes
from repro.kernels import bitpack_ops as jpack
from repro.kernels.bool_matmul import bool_matmul, bool_matmul_ref
from repro.kernels.tropical_matmul import min_plus_chunked, tropical_matmul
from repro_torch.core import bes as tbes
from repro_torch.kernels import bitpack_ops as tpack
from repro_torch.kernels.bitpack_ops import ops as pops
from repro_torch.kernels.bool_matmul import ops as bops
from repro_torch.kernels.bool_matmul import or_and_matmul
from repro_torch.kernels.tropical_matmul import ops as tops
from repro_torch.kernels.tropical_matmul import (INF, min_plus_matmul,
                                                 min_plus_matmul_ref)

SHAPES = [(128, 128, 128), (7, 200, 33), (256, 64, 128), (1, 1, 1),
          (130, 257, 5), (64, 512, 64)]
DENSITIES = [0.0, 0.02, 0.3, 1.0]


def _bool_operands(shape, density, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    return rng.random((m, k)) < density, rng.random((k, n)) < density


def _tropical_operands(shape, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 50, (m, k)).astype(np.int32)
    b = rng.integers(0, 50, (k, n)).astype(np.int32)
    a[rng.random((m, k)) < 0.3] = INF          # absent edges
    b[rng.random((k, n)) < 0.3] = INF
    return a, b


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("density", DENSITIES)
def test_or_and_matches_pallas(shape, density):
    a, b = _bool_operands(shape, density, hash(shape) % 2**32)
    want = np.asarray(bool_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = or_and_matmul(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_min_plus_matches_pallas(shape):
    a, b = _tropical_operands(shape, hash(shape) % 2**31)
    want = np.asarray(tropical_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = min_plus_matmul(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 100, 256])
def test_packing_matches_reference(k):
    """pack_rows / pack_cols / pack_payload give the JAX package's uint32
    words bit for bit (int32 here), and unpack_rows inverts them."""
    rng = np.random.default_rng(k)
    a = rng.random((17, k)) < 0.4
    a[3] = True                                 # bit 31 set in every word
    ta = torch.tensor(a)
    words = tpack.pack_rows(ta)
    assert words.dtype == torch.int32 and words.shape == (17, (k + 31) // 32)
    want = np.asarray(jpack.pack_rows(jnp.asarray(a)))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tpack.pack_rows_ref(ta).numpy(),
                                  words.numpy())
    np.testing.assert_array_equal(
        tpack.pack_payload(ta).numpy().view(np.uint32),
        np.asarray(jpack.pack_payload(jnp.asarray(a))))
    np.testing.assert_array_equal(
        tpack.pack_cols(ta.T).numpy().view(np.uint32),
        np.asarray(jpack.pack_cols(jnp.asarray(a.T))))
    assert tpack.pack_cols(ta.T).is_contiguous()
    np.testing.assert_array_equal(tpack.unpack_rows(words, k).numpy(), a)
    np.testing.assert_array_equal(tpack.unpack_payload(words, k).numpy(), a)
    assert tpack.packed_bits(17, k) == jpack.packed_bits(17, k) == \
        words.numel() * 32


@pytest.mark.parametrize("shape", [(5, 0), (0, 7), (1, 1), (40, 65)])
def test_packing_in_row_chunks_and_empty(shape, monkeypatch):
    """The packing helpers go by row chunks (CHUNK_ELEMENTS) so that a
    6.4 GB wire needs no 26 GB temporary: chunks of a few rows give the
    same words as the plain version, and K = 0 or M = 0 give empty
    words."""
    m, k = shape
    rng = np.random.default_rng(m + k)
    ta = torch.tensor(rng.random((m, k)) < 0.5)
    want = tpack.pack_rows_ref(ta)
    for chunk in (pops.CHUNK_ELEMENTS, 64, 1):
        monkeypatch.setattr(pops, "CHUNK_ELEMENTS", chunk)
        words = tpack.pack_rows(ta)
        assert words.shape == (m, (k + 31) // 32)
        assert torch.equal(words, want)
        assert torch.equal(tpack.unpack_rows(words, k), ta)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("density", [0.02, 0.3])
def test_bitpack_matmul_matches_pallas(shape, density):
    """The plain bit-packed product (the CPU side of bitpack_matmul) ==
    the JAX package's bitpack_bool_matmul driving its Pallas kernel."""
    a, b = _bool_operands(shape, density, hash(shape) % 2**30)
    want = np.asarray(jpack.bitpack_bool_matmul(jnp.asarray(a),
                                                jnp.asarray(b)))
    ta, tb = torch.tensor(a), torch.tensor(b)
    got = tpack.bitpack_matmul(tpack.pack_rows(ta), tpack.pack_cols(tb),
                               shape[1])
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpack.bitpack_bool_matmul(ta, tb).numpy(),
                                  want)


def test_empty_contraction():
    """K = 0: or-and gives all-false, min-plus INF (min over nothing)."""
    a, b = np.zeros((5, 0), bool), np.zeros((0, 7), bool)
    want = np.asarray(bool_matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    got = or_and_matmul(torch.tensor(a), torch.tensor(b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.any()
    ai, bi = np.zeros((5, 0), np.int32), np.zeros((0, 7), np.int32)
    want = np.asarray(min_plus_chunked(jnp.asarray(ai), jnp.asarray(bi)))
    got = min_plus_matmul(torch.tensor(ai), torch.tensor(bi))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == INF).all()


def test_plain_min_plus_chunking_is_exact():
    """One chunk of rows; chunks of 4 rows with a ragged last one (9 rows,
    K * N = 2^22); one row per chunk (K * N above the chunk budget)."""
    for shape in ((37, 19, 11), (9, 2048, 2048), (3, 4100, 4100)):
        a, b = _tropical_operands(shape, 3)
        want = np.stack([np.minimum((row[:, None].astype(np.int64) + b)
                                    .min(0), INF) for row in a])
        got = min_plus_matmul_ref(torch.tensor(a), torch.tensor(b))
        np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_reject_bad_operands():
    with pytest.raises(TypeError):
        or_and_matmul(torch.zeros(2, 2, dtype=torch.int32),
                      torch.zeros(2, 2, dtype=torch.bool))
    with pytest.raises(ValueError):
        or_and_matmul(torch.zeros(2, 3, dtype=torch.bool),
                      torch.zeros(2, 2, dtype=torch.bool))
    with pytest.raises(TypeError):
        min_plus_matmul(torch.zeros(2, 2), torch.zeros(2, 2))
    with pytest.raises(ValueError):
        min_plus_matmul(torch.zeros(2, 3, dtype=torch.int32),
                        torch.zeros(2, 2, dtype=torch.int32))
    words = torch.zeros(2, 1, dtype=torch.int32)
    with pytest.raises(TypeError):
        tpack.bitpack_matmul(words.bool(), words.T, 32)
    with pytest.raises(ValueError):                 # 33 columns need 2 words
        tpack.bitpack_matmul(words, words.T, 33)
    # neither the CPU nor a CUDA device: no kernel and no plain fallback
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        or_and_matmul(torch.zeros(2, 2, dtype=torch.bool, device=meta),
                      torch.zeros(2, 2, dtype=torch.bool, device=meta))
    with pytest.raises(ValueError, match="cpu or cuda"):
        min_plus_matmul(torch.zeros(2, 2, dtype=torch.int32, device=meta),
                        torch.zeros(2, 2, dtype=torch.int32, device=meta))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpack.bitpack_matmul(torch.zeros(2, 1, dtype=torch.int32, device=meta),
                             torch.zeros(1, 2, dtype=torch.int32, device=meta),
                             32)


def test_cpu_path_launches_no_kernel():
    """A CPU tensor takes the plain version; the launch counters count
    kernel launches only."""
    before = (bops.launches, tops.launches, pops.launches)
    or_and_matmul(torch.ones(3, 3, dtype=torch.bool),
                  torch.ones(3, 3, dtype=torch.bool))
    min_plus_matmul(torch.zeros(3, 3, dtype=torch.int32),
                    torch.zeros(3, 3, dtype=torch.int32))
    tpack.bitpack_bool_matmul(torch.ones(3, 3, dtype=torch.bool),
                              torch.ones(3, 3, dtype=torch.bool))
    assert (bops.launches, tops.launches, pops.launches) == before


def test_closures_match_pallas_closures():
    """bes closures: the port == the JAX package driving its Pallas
    kernels (use_pallas=True)."""
    rng = np.random.default_rng(0)
    D = rng.random((50, 50)) < 0.05
    want = np.asarray(jbes.bool_closure(jnp.asarray(D), use_pallas=True))
    np.testing.assert_array_equal(
        tbes.bool_closure(torch.tensor(D)).numpy(), want)
    W = rng.integers(0, 9, (40, 40)).astype(np.int32)
    W[rng.random((40, 40)) < 0.6] = INF
    want = np.asarray(jbes.tropical_closure(jnp.asarray(W), use_pallas=True))
    np.testing.assert_array_equal(
        tbes.tropical_closure(torch.tensor(W)).numpy(), want)


@pytest.mark.parametrize("B", [0, 1, 2, 33])
def test_closures_match_reference_on_edge_sizes(B):
    """Empty, single-node and path-shaped matrices; a path of length B-1
    needs every allowed squaring."""
    D = np.zeros((B, B), bool)
    D[np.arange(B - 1), np.arange(1, B)] = True
    W = np.where(D, 1, INF).astype(np.int32)
    np.testing.assert_array_equal(
        tbes.bool_closure(torch.tensor(D)).numpy(),
        np.asarray(jbes.bool_closure(jnp.asarray(D))))
    np.testing.assert_array_equal(
        tbes.tropical_closure(torch.tensor(W)).numpy(),
        np.asarray(jbes.tropical_closure(jnp.asarray(W))))
