"""Or-and matrix product: the hand-written CUDA kernel on a CUDA tensor,
the plain version (``ref.py``) on a CPU tensor.

The kernel, ``csrc/or_and_matmul.cu``, replaces the TPU kernel
``src/repro/kernels/bool_matmul/bool_matmul.py::bool_matmul_pallas``.  It
squares the boundary closure (``core.bes.bool_closure_kmajor``), each RPQ
product closure, and composes every batched reach and RPQ answer
(``core.cache.combine_bool``).

Layout rule.  The kernel runs on Hopper's 8-bit tensor cores, which read
both operands K-major: the left operand ``a [M, K]`` and the right one as
``b_t [N, K]`` (the transpose of ``b [K, N]``), each row-major with K
contiguous and every row starting on a 16-byte boundary (:data:`ALIGN`),
as the tensor-memory copies need.  :func:`kmajor` makes such an operand
(one padded copy, or the tensor itself when it already is one), and the
kernel's outputs are allocated that way (:func:`padded`), so a chain of
products, and a closure's pair ``(C, C^T)``, never copies.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple, Union

import torch

from .ref import or_and_matmul_nt_ref, or_and_matmul_ref

#: launches of the CUDA kernel since the count was last set to 0
launches = 0

# guards the read-modify-write of the counters: the scheduler thread and
# the repair worker of a server launch kernels at the same time
_count_lock = threading.Lock()


def _count_launch() -> None:
    """Add one to :data:`launches`, atomically: the scheduler thread and
    the repair worker of a server launch kernels at the same time."""
    global launches
    with _count_lock:
        launches += 1

#: byte alignment of a K-major operand's base and row pitch
ALIGN = 16


def pitch(cols: int) -> int:
    """Row pitch in bytes of a padded ``[rows, cols]`` bool matrix: ``cols``
    rounded up to a multiple of :data:`ALIGN` (at least one)."""
    return -(-max(cols, 1) // ALIGN) * ALIGN


def padded(rows: int, cols: int, device) -> torch.Tensor:
    """An uninitialised bool ``[rows, cols]`` view of ``[rows, pitch(cols)]``
    storage: rows start 16 bytes apart."""
    buf = torch.empty((rows, pitch(cols)), dtype=torch.bool, device=device)
    return buf[:, :cols]


def is_kmajor(x: torch.Tensor) -> bool:
    """Whether ``x`` [rows, K] can be the kernel's operand as it is: K
    contiguous, row pitch and base a multiple of :data:`ALIGN`."""
    return (x.dim() == 2 and x.dtype == torch.bool and x.stride(1) == 1
            and x.stride(0) % ALIGN == 0 and x.stride(0) >= x.shape[1]
            and x.data_ptr() % ALIGN == 0)


def kmajor_copy(x: torch.Tensor) -> torch.Tensor:
    """A fresh padded copy of ``x`` [rows, K] whose pad bytes are zero."""
    rows, cols = x.shape
    buf = torch.empty((rows, pitch(cols)), dtype=torch.bool, device=x.device)
    buf[:, cols:] = False
    return buf[:, :cols].copy_(x)


def kmajor(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when it is a K-major operand, else :func:`kmajor_copy`.
    The right operand ``b`` of a product enters as ``kmajor(b.T)``."""
    return x if is_kmajor(x) else kmajor_copy(x)


@functools.cache
def _entry():
    from .._build import library
    lib = library("or_and_matmul")
    fn = lib.or_and_matmul_nt
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(a: torch.Tensor, b: torch.Tensor, k_dim: int, name: str) -> None:
    if a.dtype != torch.bool or b.dtype != torch.bool:
        raise TypeError(f"{name} takes bool tensors, got {a.dtype} and "
                        f"{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[k_dim]:
        raise ValueError(f"{name} shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not chain")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {a.device}")


def or_and_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i, j] = OR_k (a[i, k] AND b[k, j]) for bool a [M, K], b [K, N].

    On the card ``b`` is first copied K-major (:func:`kmajor`); a caller
    that keeps ``b``'s K-major copy calls :func:`or_and_matmul_nt`."""
    _check(a, b, 0, "or_and_matmul")
    if a.device.type == "cpu":
        return or_and_matmul_ref(a, b)
    return or_and_matmul_nt(a, kmajor(b.T))


def or_and_matmul_nt(a: torch.Tensor, b_t: torch.Tensor, *,
                     with_transpose: bool = False
                     ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """C[i, j] = OR_k (a[i, k] AND b_t[j, k]) for bool a [M, K] and the
    right operand given K-major, b_t [N, K]: ``C = a @ b_t.T``.

    With ``with_transpose`` the same launch also writes C^T [N, M] and the
    pair ``(C, C^T)`` is returned.  On the card both are padded views
    (:func:`padded`), ready to be a later product's K-major operands, and
    an operand that is not K-major is copied once (:func:`kmajor`)."""
    _check(a, b_t, 1, "or_and_matmul_nt")
    if a.device.type == "cpu":
        c = or_and_matmul_nt_ref(a, b_t)
        return (c, c.T.contiguous()) if with_transpose else c
    M, K = a.shape
    N = b_t.shape[0]
    c = padded(M, N, a.device)
    ct = padded(N, M, a.device) if with_transpose else None
    if M > 0 and N > 0:
        _launch(kmajor(a), kmajor(b_t), c, ct)
    return (c, ct) if with_transpose else c


def _launch(a: torch.Tensor, b_t: torch.Tensor, c: torch.Tensor,
            ct) -> None:
    M, K = a.shape
    N = b_t.shape[0]
    ints = (M, N, K, a.stride(0), b_t.stride(0), c.stride(0),
            0 if ct is None else ct.stride(0))
    if max(ints) >= 2 ** 31:
        raise ValueError("sizes and row pitches must fit in int32")
    lib, fn = _entry()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = fn(a.data_ptr(), b_t.data_ptr(), c.data_ptr(),
                  None if ct is None else ct.data_ptr(), *ints, stream)
    _count_launch()
    from .._build import check
    check(lib, "or_and_matmul", code)
