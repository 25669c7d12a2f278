"""Or-and matrix product: the hand-written CUDA kernels on a CUDA tensor,
the plain version (``ref.py``) on a CPU tensor.

The kernels replace the TPU kernel
``src/repro/kernels/bool_matmul/bool_matmul.py::bool_matmul_pallas``, on
two routes that :func:`_route` picks (a pure function of the shape and of
the right operand's layout, so that the CPU tests reach the choice):

- the tile route, ``csrc/or_and_matmul.cu``, on Hopper's 8-bit tensor
  cores.  It squares the boundary closure (``core.bes.bool_closure_kmajor``)
  and each RPQ product closure, and composes every batched reach and RPQ
  answer (``core.cache.combine_bool``);
- the skinny route, ``csrc/or_and_skinny.cu``, for at most
  :data:`SKINNY_MAX_M` rows with the right operand read as it is stored.

The rank update's last product takes a floor pair,
:func:`or_and_floor_pair` ``(a, b_t, C, Ct)``: one persistent launch of a
second kernel in the tile route's source writes ``C | P`` and ``Ct | P^T``
(counted also in :data:`floor_launches`), so no OR pass over the closure
follows the product.

evalDG's whole fixpoint (``core.engine.evaldg_reach``) is one launch of a
third kernel in the skinny route's source, :func:`or_and_fixpoint`: each
step reads only the rows of D that the step before added to the frontier,
on D as it is stored, so that no query copies its dependency matrix.

Layout rule.  The tile route reads both operands K-major: the left operand
``a [M, K]`` and the right one as ``b_t [N, K]`` (the transpose of ``b [K,
N]``), each row-major with K contiguous and every row starting on a
16-byte boundary (:data:`ALIGN`), as the tensor-memory copies need.
:func:`kmajor` makes such an operand (one padded copy, counted in
:data:`copies`, or the tensor itself when it already is one), and the
kernels' outputs are allocated that way (:func:`padded`), so a chain of
products, and a closure's pair ``(C, C^T)``, never copies.  The skinny
route reads ``b [K, N]`` itself, rows a multiple of 16 bytes apart and its
storage reaching the last row's last 16-byte group (:func:`rows_aligned`):
D is made that way from the start (:func:`padded_zeros`).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple, Union

import torch

from .. import _fixpoint
from .ref import (or_and_fixpoint_ref, or_and_floor_pair_ref,
                  or_and_matmul_nt_ref, or_and_matmul_ref)

#: launches of the CUDA kernels (both routes) since the count was last set
#: to 0
launches = 0

#: launches of the skinny route alone, also counted in :data:`launches`
skinny_launches = 0

#: launches of the floor-pair kernel alone (:func:`or_and_floor_pair`),
#: also counted in :data:`launches`
floor_launches = 0

#: launches of the fixpoint kernel (:func:`or_and_fixpoint`), which are not
#: in :data:`launches`
fixpoint_launches = 0

#: padded copies made by :func:`kmajor_copy` and :func:`rows_copy` since the
#: count was last set to 0
copies = 0

# guards the read-modify-write of the counters: the scheduler thread and
# the repair worker of a server launch kernels at the same time
_count_lock = threading.Lock()


def _count_launch(skinny: bool = False, floor: bool = False) -> None:
    """Add one to :data:`launches` (and to :data:`skinny_launches` for the
    skinny route, :data:`floor_launches` for the floor pair), atomically:
    the scheduler thread and the repair worker of a server launch kernels
    at the same time."""
    global launches, skinny_launches, floor_launches
    with _count_lock:
        launches += 1
        if skinny:
            skinny_launches += 1
        if floor:
            floor_launches += 1


def _count_fixpoint() -> None:
    """Add one to :data:`fixpoint_launches`, atomically."""
    global fixpoint_launches
    with _count_lock:
        fixpoint_launches += 1


def _count_copy() -> None:
    """Add one to :data:`copies`, atomically."""
    global copies
    with _count_lock:
        copies += 1

#: byte alignment of a K-major operand's base and row pitch
ALIGN = 16

#: rows of at least :data:`LINE_MIN` bytes start :data:`LINE` bytes apart
LINE, LINE_MIN = 128, 2048


def pitch(cols: int) -> int:
    """Row pitch in bytes of a padded ``[rows, cols]`` bool matrix: ``cols``
    rounded up to a multiple of :data:`ALIGN` (at least one) and, from
    :data:`LINE_MIN` columns on, of :data:`LINE`, so that every row of a
    wide matrix starts on a 128-byte L2 line.  Tiles whose rows straddle
    lines slow the tensor-memory copies: the floor-pair product at nb =
    16103, K = 64 took 0.658 ms at a pitch of 16112 bytes and 0.399 ms at
    16128, and the squaring at nb = 16039 6.559 ms at 16048 and 4.680 ms
    at 16128 (``tools/or_and_tile_ab.py``, H100 80GB HBM3, 700 W).  Only
    such wide rows (nb of 16039 to 80205 on the paths) were measured;
    :data:`LINE_MIN` is not a measured break-even but the width from which
    the rounding costs at most 112 / 2048 = 5.5 % more bytes, and narrower
    rows keep the 16-byte rounding."""
    align = LINE if cols >= LINE_MIN else ALIGN
    return -(-max(cols, 1) // align) * align


def padded(rows: int, cols: int, device) -> torch.Tensor:
    """An uninitialised bool ``[rows, cols]`` view of ``[rows, pitch(cols)]``
    storage: rows start :func:`pitch` bytes apart, a multiple of 16."""
    buf = torch.empty((rows, pitch(cols)), dtype=torch.bool, device=device)
    return buf[:, :cols]


def padded_zeros(rows: int, cols: int, device) -> torch.Tensor:
    """:func:`padded` storage with every byte, pads included, zero: the
    layout in which the paths make a matrix that the skinny route reads,
    such as evalDG's D."""
    buf = torch.zeros((rows, pitch(cols)), dtype=torch.bool, device=device)
    return buf[:, :cols]


def is_kmajor(x: torch.Tensor) -> bool:
    """Whether ``x`` [rows, K] can be the kernel's operand as it is: K
    contiguous, row pitch and base a multiple of :data:`ALIGN`."""
    return (x.dim() == 2 and x.dtype == torch.bool and x.stride(1) == 1
            and x.stride(0) % ALIGN == 0 and x.stride(0) >= x.shape[1]
            and x.data_ptr() % ALIGN == 0)


def kmajor_copy(x: torch.Tensor) -> torch.Tensor:
    """A fresh padded copy of ``x`` [rows, K] whose pad bytes are zero,
    counted in :data:`copies`."""
    _count_copy()
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
    floor = lib.or_and_matmul_floor
    floor.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p])
    floor.restype = ctypes.c_int
    return lib, fn, floor


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


#: products with at most this many rows may take the skinny route
SKINNY_MAX_M = 8

#: threads of a skinny block, and rows of K in each of its chunks
SKINNY_THREADS = 128

#: columns (bytes) a skinny thread owns: one 16-byte load of a row of b
SKINNY_COLS = 16

#: skinny blocks resident on one SM, by rows per thread, where the card is
#: not asked (the CPU tests): the counts the H100 gave for this kernel; on
#: the card the kernel's occupancy is read
PER_SM_GUESS = {1: 16, 2: 10, 4: 9, 8: 6}


class Route(NamedTuple):
    """How one ``a [M, K] (or-and) b [K, N]`` product is launched: ``kind``
    "skinny" (``rows`` accumulators a thread, M rounded up to a power of
    two; K cut into ``split`` ranges of whole chunks, one block each per
    column strip) or "tile" (the other fields unused)."""
    kind: str
    rows: int = 0
    split: int = 1


def rows_aligned(b: torch.Tensor) -> bool:
    """Whether the skinny route can read ``b [K, N]`` as it is stored:
    bool, N contiguous, base and row pitch multiples of :data:`ALIGN`, and
    the storage reaching the end of the last row's last 16-byte group (the
    kernel loads that group whole and masks the bytes past N), as
    :func:`padded_zeros` makes it."""
    if not is_kmajor(b):
        return False
    K, N = b.shape
    if K == 0 or N == 0:
        return True
    end = b.storage_offset() + (K - 1) * b.stride(0) + -(-N // ALIGN) * ALIGN
    return end <= b.untyped_storage().nbytes()


def _route(M: int, K: int, N: int, aligned: bool, sms: int = 132,
           per_sm: Optional[int] = None) -> Route:
    """The route of an [M, K] x [K, N] product whose right operand is
    :func:`rows_aligned` or not, on a card of ``sms`` SMs holding
    ``per_sm`` skinny blocks each.

    Up to :data:`SKINNY_MAX_M` rows and an aligned ``b``: the skinny route,
    with K split so that the column strips times the splits fill the
    card's block slots once, in whole chunks of :data:`SKINNY_THREADS`
    rows (no split is left empty; K = 0 takes one split, which ORs in
    ``init``).  Otherwise the tile route, which reads ``kmajor(b.T)``."""
    if M > SKINNY_MAX_M or not aligned:
        return Route("tile")
    rows = 1
    while rows < M:
        rows *= 2
    if per_sm is None:
        per_sm = PER_SM_GUESS[rows]
    strips = max(1, -(-N // (SKINNY_THREADS * SKINNY_COLS)))
    chunks = max(1, -(-K // SKINNY_THREADS))
    split = max(1, min(sms * per_sm // strips, chunks, 65535))
    per = -(-chunks // split)                 # chunks a K range
    return Route("skinny", rows, -(-chunks // per))


@functools.cache
def _skinny_entries():
    from .._build import check, library
    lib = library("or_and_skinny")
    fn = lib.or_and_skinny
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    per_sm = lib.or_and_skinny_blocks_per_sm
    per_sm.argtypes = [ctypes.c_int]
    per_sm.restype = ctypes.c_int
    return lib, fn, per_sm, check


@functools.cache
def _card_route(index: int, M: int, K: int, N: int, aligned: bool) -> Route:
    """:func:`_route` with the card's SM count and the skinny kernel's
    occupancy read from the card."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    plan = _route(M, K, N, aligned, sms)
    if plan.kind == "tile":
        return plan
    with torch.cuda.device(index):
        per_sm = _skinny_entries()[2](plan.rows)
    if per_sm <= 0:
        raise RuntimeError(f"or_and_skinny occupancy query failed for "
                           f"{plan.rows} rows")
    return _route(M, K, N, aligned, sms, per_sm)


def or_and_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[i, j] = init[i, j] OR (OR_k (a[i, k] AND b[k, j])) for bool
    a [M, K], b [K, N] and the optional init [M, N] (no init: zeros).

    On the card the route is :func:`_route`'s: the skinny route reads
    ``b`` as it is stored (at most :data:`SKINNY_MAX_M` rows, ``b``
    :func:`rows_aligned`) and merges ``init`` in the same launch; the tile
    route reads ``kmajor(b.T)``, a counted copy unless a caller keeps
    ``b``'s K-major copy and calls :func:`or_and_matmul_nt`, and ORs
    ``init`` into its output.  Either way the card's result is a fresh
    view of zero-padded storage (:func:`padded`), never ``init`` updated
    in place; on the CPU the plain version's."""
    _check(a, b, 0, "or_and_matmul")
    M, K = a.shape
    N = b.shape[1]
    if init is not None:
        if init.dtype != torch.bool or tuple(init.shape) != (M, N):
            raise ValueError(f"init must be bool [{M}, {N}], got "
                             f"{init.dtype} {tuple(init.shape)}")
        if init.device != a.device:
            raise ValueError(f"init on {init.device}, operands on "
                             f"{a.device}")
    if a.device.type == "cpu":
        return or_and_matmul_ref(a, b, init=init)
    index = a.device.index
    route = _card_route(index, M, K, N, rows_aligned(b))
    if route.kind == "tile":
        c = or_and_matmul_nt(a, kmajor(b.T))
        if init is not None:
            c |= init
        return c
    c = padded_zeros(M, N, a.device)
    if M == 0 or N == 0:
        return c
    if index == torch._C._cuda_getDevice():
        _launch_skinny(index, route, a, b, init, c)
    else:
        with torch.cuda.device(index):
            _launch_skinny(index, route, a, b, init, c)
    return c


def _launch_skinny(index: int, route: Route, a, b, init, c) -> None:
    """One launch of the skinny route on the current stream of device
    ``index`` (the current device); ``c`` is zero, pads included."""
    M, K = a.shape
    N = b.shape[1]
    ints = (M, K, N, *a.stride(), b.stride(0),
            *((0, 0) if init is None else init.stride()), c.stride(0),
            route.rows, route.split)
    if max(ints) >= 2 ** 31:
        raise ValueError("sizes and row pitches must fit in int32")
    lib, fn, _, check = _skinny_entries()
    stream = torch._C._cuda_getCurrentRawStream(index)
    code = fn(a.data_ptr(), b.data_ptr(),
              None if init is None else init.data_ptr(), c.data_ptr(), *ints,
              stream)
    _count_launch(skinny=True)
    check(lib, "or_and_skinny", code)


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


def or_and_floor_pair(a: torch.Tensor, b_t: torch.Tensor, init: torch.Tensor,
                      init_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(init | C, init_t | C^T)`` with C = a @ b_t.T as in
    :func:`or_and_matmul_nt`, for the floor pair ``init`` [M, N] and
    ``init_t`` [N, M] (bool, on the operands' device and, on the card,
    K-major, as the paths keep a closure and its copy C^T).  Each output is
    a fresh view of zero-padded storage; the floors are left as they were.
    On the card that is one launch of the floor-pair kernel, which reads
    each floor from its own matrix; on the CPU the plain version's."""
    _check(a, b_t, 1, "or_and_floor_pair")
    M, N = a.shape[0], b_t.shape[0]
    for name, x, shape in (("init", init, (M, N)), ("init_t", init_t, (N, M))):
        if x.dtype != torch.bool:
            raise TypeError(f"{name} must be bool, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(x.shape)}")
        if x.device != a.device:
            raise ValueError(f"{name} on {x.device}, operands on {a.device}")
        if a.device.type == "cuda" and not is_kmajor(x):
            raise ValueError(f"{name} must be K-major (padded storage, as "
                             "padded() makes it)")
    if a.device.type == "cpu":
        c, ct = or_and_floor_pair_ref(a, b_t, init, init_t)
        return (padded_zeros(M, N, a.device).copy_(c),
                padded_zeros(N, M, a.device).copy_(ct))
    if M == 0 or N == 0:
        return padded_zeros(M, N, a.device), padded_zeros(N, M, a.device)
    c, ct = padded(M, N, a.device), padded(N, M, a.device)
    _launch_floor(kmajor(a), kmajor(b_t), init, init_t, c, ct)
    return c, ct


def _launch(a: torch.Tensor, b_t: torch.Tensor, c: torch.Tensor,
            ct) -> None:
    M, K = a.shape
    N = b_t.shape[0]
    ints = (M, N, K, a.stride(0), b_t.stride(0), c.stride(0),
            0 if ct is None else ct.stride(0))
    if max(ints) >= 2 ** 31:
        raise ValueError("sizes and row pitches must fit in int32")
    lib, fn, _ = _entry()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = fn(a.data_ptr(), b_t.data_ptr(), c.data_ptr(),
                  None if ct is None else ct.data_ptr(), *ints, stream)
    _count_launch()
    from .._build import check
    check(lib, "or_and_matmul", code)


def _launch_floor(a: torch.Tensor, b_t: torch.Tensor, init: torch.Tensor,
                  init_t: torch.Tensor, c: torch.Tensor,
                  ct: torch.Tensor) -> None:
    """One launch of the floor-pair kernel: c = init | a b_t^T, ct = init_t
    | (a b_t^T)^T, pads of both written as zeros."""
    M, K = a.shape
    N = b_t.shape[0]
    ints = (M, N, K, a.stride(0), b_t.stride(0), init.stride(0),
            init_t.stride(0), c.stride(0), ct.stride(0))
    if max(ints) >= 2 ** 31:
        raise ValueError("sizes and row pitches must fit in int32")
    lib, _, fn = _entry()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = fn(a.data_ptr(), b_t.data_ptr(), init.data_ptr(),
                  init_t.data_ptr(), c.data_ptr(), ct.data_ptr(), *ints,
                  stream)
    _count_launch(floor=True)
    from .._build import check
    check(lib, "or_and_matmul_floor", code)


def rows_copy(b: torch.Tensor) -> torch.Tensor:
    """A :func:`padded_zeros` copy of ``b`` [K, N], which the skinny route
    and the fixpoint read as it is stored, counted in :data:`copies`."""
    _count_copy()
    return padded_zeros(*b.shape, b.device).copy_(b)


# ---------------------------------------------------------------------------
# evalDG's fixpoint in one launch
# ---------------------------------------------------------------------------

#: columns of D in one strip of the fixpoint's grid
FIXPOINT_STRIP = SKINNY_THREADS * SKINNY_COLS


def _fixpoint_route(K: int, N: int, sms: int = 132,
                    per_sm: Optional[int] = None) -> _fixpoint.FixRoute:
    """The or-and fixpoint's grid (:func:`.._fixpoint.route`, blocks of
    :data:`SKINNY_THREADS` threads over strips of :data:`FIXPOINT_STRIP`
    bytes)."""
    return _fixpoint.route(K, N, FIXPOINT_STRIP, sms, per_sm)


def _card_fixpoint_route(index: int, B: int) -> _fixpoint.FixRoute:
    """:func:`_fixpoint_route` with the card's SMs and occupancy."""
    return _fixpoint.card_route("or_and_skinny", "or_and_fixpoint",
                                FIXPOINT_STRIP, index, B)


def or_and_fixpoint(x0: torch.Tensor, D: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """evalDG's single-source fixpoint on bool D [B, B] from bool x0 [B]:
    ``x := x | x (or-and) D`` until a step changes nothing.  Returns
    ``(x, steps)``: x [B] bool and the steps taken as a 0-d int32 tensor on
    x0's device, counted as the naive loop counts its products (0 when x0
    is empty).

    On the card it is one launch (``csrc/or_and_skinny.cu``, counted in
    :data:`fixpoint_launches`) that reads nothing back: each step reads
    only the rows of D that the step before added to x.  D is read as it
    is stored when :func:`rows_aligned`, as every path makes it
    (:func:`padded_zeros`); any other D is copied once (:func:`rows_copy`,
    counted).  x is a view of zero-padded storage.  On the CPU it is the
    plain version's loop."""
    if x0.dtype != torch.bool or D.dtype != torch.bool:
        raise TypeError(f"or_and_fixpoint takes bool tensors, got "
                        f"{x0.dtype} and {D.dtype}")
    B = x0.shape[0] if x0.dim() == 1 else -1
    if D.dim() != 2 or tuple(D.shape) != (B, B):
        raise ValueError(f"or_and_fixpoint takes x0 [B] and D [B, B], got "
                         f"{tuple(x0.shape)} and {tuple(D.shape)}")
    dev = x0.device
    if D.device != dev:
        raise ValueError(f"operands on {dev} and {D.device}")
    if dev.type == "cpu":
        return or_and_fixpoint_ref(x0, D)
    if dev.type != "cuda":
        raise ValueError(f"or_and_fixpoint runs on cpu or cuda, not {dev}")
    x = padded(1, B, dev)[0]
    state = torch.zeros(3, dtype=torch.int32, device=dev)
    if B == 0:
        return x, state[0]
    if not rows_aligned(D):
        D = rows_copy(D)
    if max(B, D.stride(0), x0.stride(0)) >= 2 ** 31:
        raise ValueError("sizes and row pitches must fit in int32")
    # acc (16-byte aligned, one word for every 4 bytes of x's storage),
    # then the list of rows
    work = torch.empty(pitch(B) // 4 + B, dtype=torch.int32, device=dev)
    _fixpoint.launch("or_and_skinny", "or_and_fixpoint", FIXPOINT_STRIP, x0,
                     D, x, work, work[pitch(B) // 4:], state)
    _count_fixpoint()
    return x, state[0]
