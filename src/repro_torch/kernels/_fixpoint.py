"""The launch plan and the binding shared by evalDG's two cooperative
kernels, ``bool_matmul.or_and_fixpoint`` (``bool_matmul/csrc/
or_and_skinny.cu``) and ``tropical_matmul.min_plus_settle``
(``tropical_matmul/csrc/min_plus_matmul.cu``), whose device code shares
``fixpoint.cuh``.  Each C entry point ends in (B, blocks, stream); the
library, the entry point, the arguments before that tail and the width of
a column strip are what each ``ops.py`` passes to :func:`call`.
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
def _entries(source: str, name: str, argtypes: tuple):
    """The entry point ``name`` of library ``source``, whose C arguments
    are ``argtypes`` then (B, blocks, stream)."""
    from ._build import library
    lib = library(source)
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes) + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _blocks_per_sm(source: str, name: str):
    """The occupancy query ``<name>_blocks_per_sm`` of library ``source``."""
    from ._build import library
    per_sm = getattr(library(source), f"{name}_blocks_per_sm")
    per_sm.argtypes = []
    per_sm.restype = ctypes.c_int
    return per_sm


@functools.cache
def card_route(source: str, name: str, strip: int, index: int,
               B: int) -> FixRoute:
    """:func:`route` with the card's SM count and kernel ``name``'s
    occupancy read from the card."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    with torch.cuda.device(index):
        per_sm = _blocks_per_sm(source, name)()
    if per_sm <= 0:
        raise RuntimeError(f"{name} occupancy query failed")
    return route(B, B, strip, sms, per_sm)


def call(source: str, name: str, strip: int, index: int, B: int,
         argtypes: tuple, args: tuple) -> None:
    """One cooperative launch of kernel ``name`` of library ``source`` on
    card ``index``, on torch's current stream and the grid of
    :func:`card_route`: its C arguments are ``args`` (of ``argtypes``)
    then B, the blocks and the stream.  Raises ``KernelError`` if the
    launch fails."""
    from ._build import check
    with torch.cuda.device(index):
        blocks = card_route(source, name, strip, index, B).blocks
        lib, fn = _entries(source, name, argtypes)
        code = fn(*args, B, blocks,
                  torch._C._cuda_getCurrentRawStream(index))
    check(lib, name, code)
