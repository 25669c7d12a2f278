"""(min, +) matrix product: the hand-written CUDA kernel on a CUDA tensor,
the plain version (``ref.py``) on a CPU tensor.

The kernel, ``csrc/min_plus_matmul.cu``, replaces the TPU kernel
``src/repro/kernels/tropical_matmul/tropical_matmul.py::
tropical_matmul_pallas``.  It squares the distance closure
(``core.bes.tropical_closure``), composes every batched distance answer
(``core.cache.combine_dist``), runs evalDG's vector-matrix steps
(``core.engine.evaldg_dist``) and the rank update of a repair
(``core.incremental._rank_update_tropical``).  Operands must lie in
[0, INF].

Two routes, chosen in Python by :func:`_route` so that the CPU tests reach
the choice: a skinny path for at most :data:`SKINNY_MAX_M` rows, which
splits K over many blocks and merges their partial minima with
``atomicMin`` into an output filled first, and a tile path of 128 x 128
output tiles fed by a ring of ``cp.async`` stages.  Each product is one
launch on either route.

Layout rule.  The kernel reads 16 bytes at a time: both operands must have
a contiguous inner dimension, a base and a row pitch that are multiples of
16 bytes (:data:`ALIGN`), and storage up to the next multiple of four
columns of their last row (:func:`is_aligned`).  :func:`padded_i32` makes
such storage and the kernel's outputs are allocated that way, so a chain of
products never copies; :func:`aligned` copies anything else, and counts the
copy in :data:`copies`.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from .ref import INF, min_plus_matmul_ref

#: launches of the CUDA kernel since the count was last set to 0
launches = 0

#: operand copies made by :func:`aligned` since the count was last set to 0
copies = 0

# guards the read-modify-write of the counters: the scheduler thread and
# the repair worker of a server launch kernels at the same time
_count_lock = threading.Lock()


def _count_launch() -> None:
    """Add one to :data:`launches`, atomically."""
    global launches
    with _count_lock:
        launches += 1


def _count_copy() -> None:
    """Add one to :data:`copies`, atomically."""
    global copies
    with _count_lock:
        copies += 1

#: byte alignment of an operand's base and row pitch
ALIGN = 16

#: products with at most this many rows take the skinny (split-K) route
SKINNY_MAX_M = 64

#: threads of a skinny block, each owning ``cols`` adjacent columns
SKINNY_THREADS = 128

#: fewest contraction steps a skinny block is given
SKINNY_MIN_K = 64


def pitch_i32(cols: int) -> int:
    """Row pitch in elements of a padded ``[rows, cols]`` int32 matrix:
    ``cols`` rounded up to a multiple of four (16 bytes), at least four."""
    return -(-max(cols, 1) // 4) * 4


def padded_i32(rows: int, cols: int, device) -> torch.Tensor:
    """An uninitialised int32 ``[rows, cols]`` view of ``[rows,
    pitch_i32(cols)]`` storage: rows start 16 bytes apart."""
    pitch = pitch_i32(cols)
    buf = torch.empty((rows, pitch), dtype=torch.int32, device=device)
    return buf if pitch == cols else buf.as_strided((rows, cols), (pitch, 1))


def is_aligned(x: torch.Tensor) -> bool:
    """Whether the kernel can read the int32 matrix ``x`` [rows, cols] as it
    is, 16 bytes at a time: inner stride 1, base and (for more than one
    row) row pitch multiples of 16 bytes, and the storage reaching the end
    of the last row's last 16-byte group."""
    rows, cols = x.shape
    if rows == 0 or cols == 0:
        return True
    s0, s1 = x.stride()
    if (s1 != 1 and cols > 1) or x.data_ptr() % ALIGN:
        return False
    if rows > 1 and (s0 % 4 or s0 < cols):
        return False
    if cols % 4 == 0:              # the last 16-byte group ends the row
        return True
    end = x.storage_offset() + (rows - 1) * s0 + pitch_i32(cols)
    return end * 4 <= x.untyped_storage().nbytes()


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when :func:`is_aligned`, else a padded copy (counted in
    :data:`copies`)."""
    if is_aligned(x):
        return x
    _count_copy()
    return padded_i32(*x.shape, x.device).copy_(x)


class Route(NamedTuple):
    """How one product is launched: ``kind`` "skinny" (``rows`` rows held
    per thread, ``cols`` adjacent columns per thread, K cut into ``split``
    ranges, one block each per column strip) or "tile" (the other fields
    unused)."""
    kind: str
    rows: int = 0
    cols: int = 0
    split: int = 1


#: skinny blocks resident on one SM, by rows per thread, where the card is
#: not asked (the CPU tests): the counts the H100 gave for this kernel; on
#: the card the kernel's occupancy is read
PER_SM_GUESS = {1: 5, 2: 4, 4: 4, 8: 3, 16: 3, 32: 2, 64: 3}


def _route(M: int, K: int, N: int, sms: int = 132,
           per_sm: Optional[int] = None) -> Route:
    """The route of an [M, K] x [K, N] product on a card of ``sms`` SMs,
    each holding ``per_sm`` skinny blocks at once.

    Up to :data:`SKINNY_MAX_M` rows: the skinny path, with the rows held in
    registers (``rows`` the least power of two >= M; up to 32 rows a
    thread owns 4 columns, 64 rows 2, so that it keeps at most 128 partial
    minima), and K split so that the column strips times the splits fill
    the card's block slots once, each block taking at least
    :data:`SKINNY_MIN_K` steps.  K = 0 still takes one split: the launch
    merges INF into the floor.  Otherwise the tile path."""
    if M > SKINNY_MAX_M:
        return Route("tile")
    rows = 1
    while rows < M:
        rows *= 2
    cols = 2 if rows > 32 else 4
    if per_sm is None:
        per_sm = PER_SM_GUESS[rows]
    strips = -(-N // (SKINNY_THREADS * cols))
    split = max(1, min(sms * per_sm // strips, K // SKINNY_MIN_K, 65535))
    return Route("skinny", rows, cols, split)


@functools.cache
def _entries():
    from .._build import library
    lib = library("min_plus_matmul")
    tile = lib.min_plus_tile
    tile.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    tile.restype = ctypes.c_int
    skinny = lib.min_plus_skinny
    skinny.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
    skinny.restype = ctypes.c_int
    per_sm = lib.min_plus_skinny_blocks_per_sm
    per_sm.argtypes = [ctypes.c_int] * 2
    per_sm.restype = ctypes.c_int
    from .._build import check
    return lib, tile, skinny, per_sm, check


@functools.cache
def _card_route(index: int, M: int, K: int, N: int) -> Route:
    """:func:`_route` with the card's SM count and the skinny kernel's
    occupancy read from the card."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    plan = _route(M, K, N, sms)
    if plan.kind == "tile":
        return plan
    with torch.cuda.device(index):
        per_sm = _entries()[3](plan.rows, plan.cols)
    if per_sm <= 0:
        raise RuntimeError(f"min_plus_skinny occupancy query failed for "
                           f"{plan.rows} rows, {plan.cols} columns")
    return _route(M, K, N, sms, per_sm)


def min_plus_matmul(a: torch.Tensor, b: torch.Tensor,
                    init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[i, j] = min(init[i, j], min_k (a[i, k] + b[k, j]), INF) for int32
    a [M, K], b [K, N] and the optional floor ``init`` [M, N] (INF when
    absent).

    The result is a fresh tensor, never ``init`` updated in place: a view
    of padded storage (:func:`padded_i32`), ready to be a later product's
    operand.  On the card, operands that are not :func:`is_aligned` are
    copied once (:func:`aligned`)."""
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"min_plus_matmul takes int32 tensors, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"min_plus_matmul shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not chain")
    dev = a.device
    if dev != b.device:
        raise ValueError(f"operands on {dev} and {b.device}")
    M, K = a.shape
    N = b.shape[1]
    if init is not None:
        if init.dtype != torch.int32 or tuple(init.shape) != (M, N):
            raise ValueError(f"init must be int32 [{M}, {N}], got "
                             f"{init.dtype} {tuple(init.shape)}")
        if init.device != dev:
            raise ValueError(f"init on {init.device}, operands on {dev}")
    if dev.type == "cpu":
        # the card's output layout, so that a chain of products on the CPU
        # hands the next product what the card would
        return padded_i32(M, N, dev).copy_(min_plus_matmul_ref(a, b, init))
    if dev.type != "cuda":
        raise ValueError(f"min_plus_matmul runs on cpu or cuda, not {dev}")
    out = padded_i32(M, N, dev)
    if M == 0 or N == 0:
        return out
    a, b = aligned(a), aligned(b)
    index = dev.index
    if index == torch._C._cuda_getDevice():
        _launch(index, a, b, init, out)
    else:
        with torch.cuda.device(index):
            _launch(index, a, b, init, out)
    return out


def _launch(index: int, a, b, init, out) -> None:
    """One launch of the route :func:`_card_route` picks, on the current
    stream of device ``index`` (the current device)."""
    M, K = a.shape
    N = b.shape[1]
    route = _card_route(index, M, K, N)
    lib, tile, skinny, _, check = _entries()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if route.kind == "skinny":
        # the blocks merge their partial minima into the floor with
        # atomicMin, on the same stream after this fill
        if init is None:
            out.fill_(INF)
        else:
            torch.clamp_max(init, INF, out=out)
        ints = (M, K, N, a.stride(0), b.stride(0), out.stride(0),
                route.rows, route.cols, route.split)
        _check_ints(ints)
        code = skinny(a.data_ptr(), b.data_ptr(), out.data_ptr(), *ints,
                      stream)
    else:
        # the tile path's epilogue reads the floor 16 bytes at a time
        init = None if init is None else aligned(init)
        ints = (M, K, N, a.stride(0), b.stride(0),
                0 if init is None else init.stride(0), out.stride(0))
        _check_ints(ints)
        code = tile(a.data_ptr(), b.data_ptr(),
                    None if init is None else init.data_ptr(),
                    out.data_ptr(), *ints, stream)
    _count_launch()
    check(lib, "min_plus_matmul", code)


def _check_ints(ints) -> None:
    if max(ints) >= 2 ** 31:
        raise ValueError("sizes and row pitches must fit in int32")
