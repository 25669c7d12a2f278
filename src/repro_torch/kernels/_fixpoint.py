"""The launch plan and the binding shared by evalDG's two fixpoint kernels,
``bool_matmul.or_and_fixpoint`` (``bool_matmul/csrc/or_and_skinny.cu``)
and ``tropical_matmul.min_plus_fixpoint``
(``tropical_matmul/csrc/min_plus_matmul.cu``), whose device code shares
``fixpoint.cuh``.  Both are one cooperative launch with the same C
signature; they differ in the library, the entry point and the width of
a column strip, which each ``ops.py`` passes in.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

#: most fixpoint blocks an SM is given: four blocks of 128 threads, each
#: with eight 16-byte loads in flight, keep 64 KB a SM in flight, more than
#: the card's memory needs to stream, and fewer blocks wait at each grid
#: barrier
MAX_PER_SM = 4

#: rows a fixpoint block should have at least, in the largest step the
#: matrix allows, before the grid grows by another block
MIN_ROWS = 32


class FixRoute(NamedTuple):
    """How one fixpoint is launched: ``blocks`` co-resident blocks over
    ``strips`` column strips."""
    blocks: int
    strips: int


def route(K: int, N: int, strip: int, sms: int = 132,
          per_sm: Optional[int] = None) -> FixRoute:
    """The grid of a fixpoint on a [K, N] matrix (K = N = B) cut into
    column strips of ``strip`` columns, on a card of ``sms`` SMs that holds
    ``per_sm`` fixpoint blocks each (the most a cooperative launch may have
    resident; the CPU tests assume :data:`MAX_PER_SM`).

    A step's list of new rows is cut over (row range x column strip)
    items, so no grid is useful past one block for every :data:`MIN_ROWS`
    rows of K in every strip; and past :data:`MAX_PER_SM` blocks an SM the
    grid barriers cost more than the loads gain.  K = 0 still takes one
    block."""
    strips = max(1, -(-N // strip))
    per_sm = MAX_PER_SM if per_sm is None else per_sm
    slots = max(1, sms * min(per_sm, MAX_PER_SM))
    useful = max(1, -(-K // MIN_ROWS)) * strips
    return FixRoute(min(slots, useful), strips)


@functools.cache
def _entries(source: str, name: str):
    """The fixpoint entry point ``name`` of library ``source`` and its
    occupancy query ``<name>_blocks_per_sm``."""
    from ._build import library
    lib = library(source)
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    per_sm = getattr(lib, f"{name}_blocks_per_sm")
    per_sm.argtypes = []
    per_sm.restype = ctypes.c_int
    return lib, fn, per_sm


@functools.cache
def card_route(source: str, name: str, strip: int, index: int,
               B: int) -> FixRoute:
    """:func:`route` with the card's SM count and the kernel's occupancy
    read from the card."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    with torch.cuda.device(index):
        per_sm = _entries(source, name)[2]()
    if per_sm <= 0:
        raise RuntimeError(f"{name} occupancy query failed")
    return route(B, B, strip, sms, per_sm)


def launch(source: str, name: str, strip: int, v0: torch.Tensor,
           M: torch.Tensor, out: torch.Tensor, acc: torch.Tensor,
           rows: torch.Tensor, state: torch.Tensor) -> None:
    """One cooperative launch of fixpoint ``name`` from the vector v0 [B]
    on M [B, B] on torch's current stream, on the grid of
    :func:`card_route`: ``out`` gets the fixpoint, ``state[0]`` the steps;
    ``acc`` and ``rows`` are scratch.  Raises ``KernelError`` if the launch
    fails.  The caller checks shapes, layouts and int32 limits, and counts
    the launch."""
    from ._build import check
    B = v0.shape[0]
    index = out.device.index
    with torch.cuda.device(index):
        blocks = card_route(source, name, strip, index, B).blocks
        lib, fn, _ = _entries(source, name)
        code = fn(v0.data_ptr(), v0.stride(0), M.data_ptr(), M.stride(0),
                  out.data_ptr(), acc.data_ptr(), rows.data_ptr(),
                  state.data_ptr(), B, blocks,
                  torch._C._cuda_getCurrentRawStream(index))
    check(lib, name, code)
