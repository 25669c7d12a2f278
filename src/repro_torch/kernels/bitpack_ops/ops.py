"""Word packing for the sharded wire, and the bit-packed or-and product:
the hand-written CUDA kernel on a CUDA tensor, the plain version
(``ref.py``) on a CPU tensor.

Words are ``torch.int32`` with the uint32 bit layout: bit ``b`` of word
``w`` stands for column ``32 w + b``.  torch has thin uint32 support, and
the collectives reduce int32 (``core.distributed`` merges Boolean payloads
with a SUM over these words, exact because every bit is set on one rank
only).

The kernel, ``csrc/bitpack_matmul.cu``, replaces the TPU kernel
``src/repro/kernels/bitpack_ops/bitpack_ops.py::bitpack_matmul_pallas``.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from .ref import bitpack_matmul_ref

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

_SHIFTS8 = (0, 8, 16, 24)


def packed_bits(rows: int, cols: int) -> int:
    """Bits actually shipped for a [rows, cols] Boolean payload once packed:
    rows x ceil(cols/32) 32-bit words."""
    return rows * ((cols + 31) // 32) * 32


#: elements of the widest temporary per chunk of rows in the packing
#: helpers (2^27: 512 MiB of int32), so that packing the wire of a
#: product-automaton matrix (6.4 GB at full size) needs no 26 GB temporary
CHUNK_ELEMENTS = 1 << 27


def _row_chunks(rows: int, per_row: int):
    """Row slices of at most ``CHUNK_ELEMENTS // per_row`` rows (one at
    least) covering ``rows``."""
    step = max(1, CHUNK_ELEMENTS // max(1, per_row))
    return [slice(r, r + step) for r in range(0, rows, step)]


def pack_rows(a: torch.Tensor) -> torch.Tensor:
    """[M, K] bool -> [M, ceil(K/32)] int32 (bit b of word w = a[:, 32w+b]).

    Bytes first (eight bits each, summed in uint8), then words built in
    int64 from four bytes and cut to their low 32 bits, so that bit 31
    lands as the sign bit without an int32 overflow.  Rows go in chunks
    (:data:`CHUNK_ELEMENTS`)."""
    M, K = a.shape
    W = (K + 31) // 32
    out = torch.empty((M, W), dtype=torch.int32, device=a.device)
    shift8 = torch.arange(8, dtype=torch.uint8, device=a.device)
    shift32 = torch.tensor(_SHIFTS8, dtype=torch.int64, device=a.device)
    for rows in _row_chunks(M, W * 32):
        block = a[rows]
        n = block.shape[0]
        bits = torch.zeros((n, W * 32), dtype=torch.uint8, device=a.device)
        bits[:, :K] = block
        octets = (bits.view(n, W, 4, 8) << shift8).sum(-1, dtype=torch.uint8)
        words = (octets.long() << shift32).sum(-1)
        out[rows] = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return out


def pack_cols(b: torch.Tensor) -> torch.Tensor:
    """[K, N] bool -> [ceil(K/32), N] int32 (bit b of word w = b[32w+b, :]),
    contiguous."""
    return pack_rows(b.T).T.contiguous()


def unpack_rows(ap: torch.Tensor, K: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse of :func:`pack_rows`, written into ``out`` (a bool [M, K]
    tensor of any strides, such as a view of padded storage; a fresh
    contiguous one when None) and returned.  ``(w >> b) & 1`` reads bit 31
    right even though int32 shifts are arithmetic.  Rows go in chunks
    (:data:`CHUNK_ELEMENTS`)."""
    M, W = ap.shape
    if out is None:
        out = torch.empty((M, K), dtype=torch.bool, device=ap.device)
    elif out.dtype != torch.bool or tuple(out.shape) != (M, K):
        raise ValueError(f"out must be bool [{M}, {K}], got {out.dtype} "
                         f"{tuple(out.shape)}")
    shifts = torch.arange(32, dtype=torch.int32, device=ap.device)
    for rows in _row_chunks(M, W * 32):
        bits = (ap[rows, :, None] >> shifts) & 1
        out[rows] = bits.reshape(bits.shape[0], W * 32)[:, :K]
    return out


def pack_payload(m: torch.Tensor) -> torch.Tensor:
    """Pack a Boolean payload matrix [R, C] into int32 words
    [R, ceil(C/32)] for the one collective of ``core.distributed``."""
    return pack_rows(m.bool())


def unpack_payload(p: torch.Tensor, n_cols: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse of :func:`pack_payload` on the replicated side, into
    ``out`` when given (:func:`unpack_rows`)."""
    return unpack_rows(p, n_cols, out)


@functools.cache
def _entry():
    from .._build import library
    lib = library("bitpack_matmul")
    fn = lib.bitpack_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def bitpack_matmul(ap: torch.Tensor, bp: torch.Tensor, K: int) -> torch.Tensor:
    """C[i, j] = (OR_w ap[i, w] & bp[w, j]) != 0 for ap [M, W] row-packed
    and bp [W, N] column-packed int32 words, W = ceil(K/32), with zero bits
    past K (as :func:`pack_rows` / :func:`pack_cols` leave them)."""
    if ap.dtype != torch.int32 or bp.dtype != torch.int32:
        raise TypeError(f"bitpack_matmul takes int32 words, got {ap.dtype} "
                        f"and {bp.dtype}")
    W = (K + 31) // 32
    if (ap.dim() != 2 or bp.dim() != 2 or K < 0 or ap.shape[1] != W
            or bp.shape[0] != W):
        raise ValueError(f"bitpack_matmul shapes {tuple(ap.shape)} x "
                         f"{tuple(bp.shape)} do not chain over K={K} "
                         f"({W} words)")
    if ap.device != bp.device:
        raise ValueError(f"operands on {ap.device} and {bp.device}")
    if ap.device.type == "cpu":
        return bitpack_matmul_ref(ap, bp, K)
    if ap.device.type != "cuda":
        raise ValueError(f"bitpack_matmul runs on cpu or cuda, not {ap.device}")
    if not (ap.is_contiguous() and bp.is_contiguous()):
        raise ValueError("bitpack_matmul takes contiguous word tensors")
    M, N = ap.shape[0], bp.shape[1]
    out = torch.empty((M, N), dtype=torch.bool, device=ap.device)
    if M == 0 or N == 0:
        return out
    if max(M, N, W * N, M * W) >= 2 ** 31:
        raise ValueError("sizes must fit in int32")
    lib, fn = _entry()
    with torch.cuda.device(ap.device):
        stream = torch.cuda.current_stream(ap.device).cuda_stream
        code = fn(ap.data_ptr(), bp.data_ptr(), out.data_ptr(), M, W, N, K,
                  out.stride(0), stream)
    _count_launch()
    from .._build import check
    check(lib, "bitpack_matmul", code)
    return out


def bitpack_bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Or-and product of bool a [M, K] and b [K, N] through 32-fold
    bit packing: packs both operands, then :func:`bitpack_matmul`."""
    return bitpack_matmul(pack_rows(a), pack_cols(b), a.shape[1])
