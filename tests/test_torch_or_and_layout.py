"""The or-and kernel's operand layout on the CPU: K-major copies with a
padded row pitch, the K-major entry point ``or_and_matmul_nt`` against the
JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py runs
it), and the closure's K-major copy through ``bool_closure_kmajor`` and
``combine_bool``.

The kernel reads both operands K-major with rows 16 bytes apart; the
wrappers prepare them in plain PyTorch, which is what these tests reach.
The kernel itself is held against the same results by
tests/test_torch_gpu.py on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bes as jbes
from repro.core import cache as jcache
from repro.kernels.bool_matmul import bool_matmul, bool_matmul_ref
from repro_torch.core import bes as tbes
from repro_torch.core import cache as tcache
from repro_torch.kernels.bool_matmul import ops as bops
from repro_torch.kernels.bool_matmul import (ALIGN, is_kmajor, kmajor,
                                             kmajor_copy, or_and_matmul_nt,
                                             padded, pitch)

# ragged and aligned widths, a single row or column, and empty matrices
LAYOUT_SHAPES = [(0, 0), (0, 5), (5, 0), (1, 1), (7, 33), (16, 16), (3, 17),
                 (40, 129)]
# K around the kernel's 32-byte wgmma depth and 128-byte stage
NT_SHAPES = [(7, 31, 9), (9, 32, 7), (5, 33, 12), (65, 127, 130),
             (130, 129, 65), (1, 1, 1), (4, 0, 3)]


def _storage(x):
    """The [rows, pitch] storage behind a padded view."""
    return x.as_strided((x.shape[0], x.stride(0)), (x.stride(0), 1))


def _views(rows, cols, rng):
    """The same [rows, cols] values as a contiguous tensor, a transposed
    view, a column slice, and a view at an odd byte offset."""
    x = rng.random((rows, cols)) < 0.4
    base = torch.tensor(x)
    wide = torch.zeros((rows, 2 * cols), dtype=torch.bool)
    wide[:, ::2] = base
    shifted = torch.zeros((rows + 1, cols + 3), dtype=torch.bool)
    shifted[1:, 3:] = base
    return x, {"contiguous": base, "transposed": base.T.contiguous().T,
               "column_slice": wide[:, ::2], "offset": shifted[1:, 3:]}


@pytest.mark.parametrize("shape", LAYOUT_SHAPES, ids=str)
def test_kmajor_copy_pads_to_16_bytes(shape):
    rows, cols = shape
    x, views = _views(rows, cols, np.random.default_rng(rows * 131 + cols))
    for name, v in views.items():
        out = kmajor_copy(v)
        assert out.dtype == torch.bool and out.shape == (rows, cols), name
        assert out.stride() == (pitch(cols), 1), name
        assert pitch(cols) % ALIGN == 0 and pitch(cols) >= cols, name
        assert out.data_ptr() % ALIGN == 0 and is_kmajor(out), name
        np.testing.assert_array_equal(out.numpy(), x, err_msg=name)
        assert not _storage(out)[:, cols:].any(), name   # zero pad
        # an operand that is K-major already is taken as it is
        assert kmajor(out) is out
        moved = kmajor(v)
        assert is_kmajor(moved) and np.array_equal(moved.numpy(), x), name


def test_kmajor_rejects_unaligned_layouts():
    x = torch.ones((4, 32), dtype=torch.bool)
    assert is_kmajor(x)                          # pitch 32, base aligned
    assert not is_kmajor(torch.ones((4, 33), dtype=torch.bool))
    assert not is_kmajor(x[:, 1:])               # base off by one byte
    assert not is_kmajor(x.T)                    # K not contiguous
    assert not is_kmajor(x.to(torch.uint8))
    assert pitch(0) == pitch(1) == pitch(16) == 16 and pitch(17) == 32
    p = padded(3, 17, "cpu")
    assert p.shape == (3, 17) and p.stride() == (32, 1)


@pytest.mark.parametrize("shape", NT_SHAPES, ids=str)
@pytest.mark.parametrize("density", [0.02, 0.3, 1.0])
def test_or_and_nt_matches_pallas(shape, density):
    """The K-major entry on the CPU == the JAX package's bool_matmul (its
    Pallas kernel in interpret mode), C and C^T, on the K-major copy of b."""
    m, k, n = shape
    rng = np.random.default_rng([m, k, n, int(density * 100)])
    a = rng.random((m, k)) < density
    b = rng.random((k, n)) < density
    # the Pallas kernel takes no empty contraction: K = 0 goes to its ref
    jax_fn = bool_matmul if k else bool_matmul_ref
    want = np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(b)))
    ta = torch.tensor(a)
    bt = kmajor_copy(torch.tensor(b).T)
    before = bops.launches
    c = or_and_matmul_nt(ta, bt)
    c2, ct = or_and_matmul_nt(ta, bt, with_transpose=True)
    assert bops.launches == before                # the CPU launches nothing
    assert c.dtype == ct.dtype == torch.bool
    np.testing.assert_array_equal(c.numpy(), want)
    np.testing.assert_array_equal(c2.numpy(), want)
    np.testing.assert_array_equal(ct.numpy(), want.T)


def test_or_and_nt_rejects_bad_operands():
    a = torch.zeros((2, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="do not chain"):
        or_and_matmul_nt(a, torch.zeros((3, 2), dtype=torch.bool))
    with pytest.raises(TypeError):
        or_and_matmul_nt(a, torch.zeros((4, 3), dtype=torch.uint8))
    meta = torch.zeros((4, 3), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        or_and_matmul_nt(a.to("meta"), meta)


@pytest.mark.parametrize("B", [0, 1, 17, 60])
def test_bool_closure_kmajor_copy(B):
    """The closure equals the JAX package's (Pallas kernel) and its
    K-major copy equals the closure's transpose."""
    rng = np.random.default_rng(B)
    D = rng.random((B, B)) < 0.05
    want = np.asarray(jbes.bool_closure(jnp.asarray(D), use_pallas=True))
    C, Ct = tbes.bool_closure_kmajor(torch.tensor(D))
    np.testing.assert_array_equal(C.numpy(), want)
    np.testing.assert_array_equal(Ct.numpy(), want.T)
    np.testing.assert_array_equal(tbes.bool_closure(torch.tensor(D)).numpy(),
                                  want)


@pytest.mark.parametrize("side", [1, 33, 70])
def test_combine_bool_through_kmajor_copy(side):
    """combine_bool through the closure's K-major copy == the JAX
    package's combine_bool through the closure."""
    rng = np.random.default_rng(side)
    N = 9
    D = rng.random((side, side)) < 0.04
    C = np.asarray(jbes.bool_closure(jnp.asarray(D), use_pallas=True))
    direct = rng.random(N) < 0.2
    sb = rng.random((N, side)) < 0.1
    tc = rng.random((N, side)) < 0.1
    want = np.asarray(jcache.combine_bool(jnp.asarray(direct), jnp.asarray(sb),
                                          jnp.asarray(tc), jnp.asarray(C)))
    _, Ct = tbes.bool_closure_kmajor(torch.tensor(D))
    got = tcache.combine_bool(torch.tensor(direct), torch.tensor(sb),
                              torch.tensor(tc), Ct)
    np.testing.assert_array_equal(got.numpy(), want)
