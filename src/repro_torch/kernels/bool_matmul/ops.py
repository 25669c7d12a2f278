"""Or-and matrix product: the hand-written CUDA kernel on a CUDA tensor,
the plain version (``ref.py``) on a CPU tensor.

The kernel, ``csrc/or_and_matmul.cu``, replaces the TPU kernel
``src/repro/kernels/bool_matmul/bool_matmul.py::bool_matmul_pallas``.  It
squares the boundary closure (``core.bes.bool_closure``), each RPQ
product closure, and composes every batched reach and RPQ answer
(``core.cache.combine_bool``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .ref import or_and_matmul_ref

#: launches of the CUDA kernel since the count was last set to 0
launches = 0


@functools.cache
def _entry():
    from .._build import library
    lib = library("or_and_matmul")
    fn = lib.or_and_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def or_and_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i, j] = OR_k (a[i, k] AND b[k, j]) for bool a [M, K], b [K, N]."""
    if a.dtype != torch.bool or b.dtype != torch.bool:
        raise TypeError(f"or_and_matmul takes bool tensors, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"or_and_matmul shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not chain")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return or_and_matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"or_and_matmul runs on cpu or cuda, not {a.device}")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.bool, device=a.device)
    if M == 0 or N == 0:
        return out
    W = (K + 31) // 32
    ap = torch.empty((M, W), dtype=torch.int32, device=a.device)
    bp = torch.empty((W, N), dtype=torch.int32, device=a.device)
    ints = (M, K, N, *a.stride(), *b.stride(), out.stride(0))
    if max(ints) >= 2 ** 31:
        raise ValueError("sizes and strides must fit in int32")
    lib, fn = _entry()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), ap.data_ptr(),
                  bp.data_ptr(), M, K, N, a.stride(0), a.stride(1), b.stride(0),
                  b.stride(1), out.stride(0), stream)
    global launches
    launches += 1
    from .._build import check
    check(lib, "or_and_matmul", code)
    return out
