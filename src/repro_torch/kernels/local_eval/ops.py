"""localEval of the one-shot algorithms written straight into the
dependency matrix by a hand-written CUDA kernel.

The kernels, ``csrc/local_eval.cu``, replace no TPU kernel: the JAX
package's localEval is ``jnp`` gather and scatter.  They serve
``core.engine.local_eval_reach`` / ``local_eval_dist`` when they are given
``out=`` on the card: every owned source row of F fragments, reach (D,
bool) or hop distance capped at ``cap`` (W, int32), is computed by a local
BFS on chip and written into ``out`` once, and every row that no source of
the F fragments owns gets the semiring zero (0, INF).  Each row is written
over its whole pitch: its pads hold the semiring zero too.  Given W's row
lists (``tropical_matmul.ops.RowLists``) instead, the same BFS stores each
owned row as the list of its finite (column, distance) pairs, and nothing
else (:func:`local_eval_dist_lists`).  One launch a call, counted in
:data:`launches` (the row-list route also in :data:`list_launches`) and in
the ``oneshot.local_launches`` count of :mod:`repro_torch.tracing`;
nothing is read back unless the recorder is on, when the launch's deepest
level is read once and counted as ``fixpoint.steps`` (and
``host.syncs``).

The plain version, which the engine runs on the CPU and the card tests
hold the kernels to, is the engine's own: the fixpoint of
``core.engine._propagate_*``, the gather of the ``[r, B]`` row block, and
the block written into ``out`` filled with the zero, or into the lists
(``tropical_matmul.ops.write_row_lists``).

Layout rule (:func:`check_args`, on every device): ``out`` is ``[B, B]``
with contiguous rows whose base and pitch are multiples of 16 bytes and
whose storage holds the last row's pitch, as ``bool_matmul.padded`` and
``tropical_matmul.padded_i32`` make it, or W's row lists as
``tropical_matmul.ops.row_lists`` makes them (contiguous, the pairs 16
bytes aligned); every input is int32 with contiguous rows.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Tuple

import torch

from ... import tracing
from ..tropical_matmul.ops import ROW_CAP, RowLists

#: core.engine.INF: the distance of a slot not reached
INF = 1 << 29

#: sources a batch of the kernel (one bit each of a word): the scratch of
#: a dist launch holds one distance a source and slot
BATCH = 32

#: launches of either kernel since the count was last set to 0
launches = 0

#: launches of the row-list route since the count was last set to 0
list_launches = 0

#: the C entry point's modes: D, W, W's row lists
REACH, DIST, LISTS = 0, 1, 2

# guards the read-modify-write of the counter: a server's threads may
# launch at once
_count_lock = threading.Lock()


def _count_launch(mode: int) -> None:
    """Add one to :data:`launches` (and to :data:`list_launches` for the
    row-list route), atomically."""
    global launches, list_launches
    with _count_lock:
        launches += 1
        list_launches += mode == LISTS


class Plan(NamedTuple):
    """What a block keeps in shared memory: the BFS state (three words a
    slot), the fragment's edges (two ints an edge), and the dynamic shared
    memory that takes.  What is not shared is read from device memory."""
    state_shared: bool
    edges_shared: bool
    smem: int


def _plan(n_max: int, E: int, limit: int) -> Plan:
    """The shared-memory plan for fragments of ``n_max + 1`` slots and
    ``E`` edges on a card that gives a block ``limit`` bytes: state and
    edges where both fit, else the state alone (the edges then come
    through L2), else neither."""
    state, edges = 12 * (n_max + 1), 8 * E
    if state + edges <= limit:
        return Plan(True, True, state + edges)
    if state <= limit:
        return Plan(True, False, state)
    return Plan(False, False, 0)


@functools.cache
def _entries():
    from .._build import check, library
    lib = library("local_eval")
    fn = lib.local_eval
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.local_eval_smem_limit.argtypes = []
    lib.local_eval_smem_limit.restype = ctypes.c_int
    lib.local_eval_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.local_eval_blocks_per_sm.restype = ctypes.c_int
    return lib, fn, check


@functools.cache
def _card_plan(index: int, n_max: int, E: int, mode: int
               ) -> Tuple[Plan, int]:
    """:func:`_plan` with the card's shared memory, and the grid: every
    block the card holds at once."""
    lib = _entries()[0]
    with torch.cuda.device(index):
        limit = lib.local_eval_smem_limit()
        if limit < 0:
            raise RuntimeError("local_eval shared-memory query failed")
        plan = _plan(n_max, E, limit)
        per_sm = lib.local_eval_blocks_per_sm(mode, plan.smem)
    if per_sm <= 0:
        raise RuntimeError(f"local_eval occupancy query failed for "
                           f"{plan.smem} bytes of shared memory")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return plan, sms * per_sm


def check_args(dist: bool, out, esrc, edst, src_local, src_row, tgt_local,
               s_local, t_local) -> None:
    """Raise unless the arguments are what the kernels take (the layout
    rule of the module docstring), on one device: ``out`` int32 for
    ``dist``, bool for reach, or, for ``dist``, W's row lists."""
    if isinstance(out, RowLists):
        if not dist:
            raise TypeError("row lists hold W: dist only")
        _check_lists(out)
        _check_inputs(out.B, out.device, esrc, edst, src_local, src_row,
                      tgt_local, s_local, t_local)
        return
    dtype = torch.int32 if dist else torch.bool
    if out.dtype != dtype:
        raise TypeError(f"out must be {dtype}, got {out.dtype}")
    B = out.shape[0] if out.dim() == 2 else -1
    if tuple(out.shape) != (B, B):
        raise ValueError(f"out must be [B, B], got {tuple(out.shape)}")
    _check_inputs(B, out.device, esrc, edst, src_local, src_row, tgt_local,
                  s_local, t_local)
    size = out.element_size()
    if (out.stride(1) != 1 or out.stride(0) < B
            or out.stride(0) * size % 16 or out.data_ptr() % 16):
        raise ValueError(f"out must be padded storage: contiguous rows "
                         f"whose base and pitch are multiples of 16 bytes "
                         f"(strides {out.stride()}, {size}-byte entries)")
    if (out.untyped_storage().nbytes()
            < (out.storage_offset() + B * out.stride(0)) * size):
        raise ValueError("out's storage ends before its last row's pitch")


def _check_lists(out: RowLists) -> None:
    """Raise unless ``out`` is row lists as ``row_lists`` makes them."""
    B = out.B
    for name, x, shape in (("pairs", out.pairs, (B, ROW_CAP, 2)),
                           ("count", out.count, (B,)),
                           ("meta", out.meta, (2,))):
        if x.dtype != torch.int32:
            raise TypeError(f"row lists' {name} must be int32, got "
                            f"{x.dtype}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"row lists' {name} must be contiguous "
                             f"{shape}, got {tuple(x.shape)}")
        if x.device != out.count.device:
            raise ValueError(f"row lists' {name} on {x.device}")
    if out.pairs.data_ptr() % 16:
        raise ValueError("row lists' pairs must start 16 bytes aligned")


def _check_inputs(B: int, device, esrc, edst, src_local, src_row,
                  tgt_local, s_local, t_local) -> None:
    """The inputs' dtypes, devices, shapes and layouts against a matrix of
    ``B`` rows on ``device``."""
    named = dict(esrc=esrc, edst=edst, src_local=src_local, src_row=src_row,
                 tgt_local=tgt_local, s_local=s_local, t_local=t_local)
    for name, x in named.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, out on {device}")
    F, E = esrc.shape if esrc.dim() == 2 else (-1, -1)
    S = src_local.shape[1] if src_local.dim() == 2 else -1
    want = dict(esrc=(F, E), edst=(F, E), src_local=(F, S),
                src_row=(F, S), tgt_local=(F, B), s_local=(F,),
                t_local=(F,))
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, "
                             f"expected {shape}")
    if F < 0 or S < 1 or B < 2:
        raise ValueError(f"out must be [B, B] with B >= 2 and sources "
                         f"[F, S >= 1], got B = {B} and "
                         f"{tuple(src_local.shape)}")
    for name in ("esrc", "edst", "src_local", "src_row", "s_local",
                 "t_local"):
        if not named[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tgt_local.stride(1) != 1:
        raise ValueError("tgt_local's rows must be contiguous")


def _local_eval(mode: int, out, esrc, edst, src_local, src_row, tgt_local,
                s_local, t_local, cap: int, n_max: int):
    args = (esrc, edst, src_local, src_row, tgt_local, s_local, t_local)
    lists = mode == LISTS
    if isinstance(out, RowLists) != lists:
        raise TypeError("row lists go to local_eval_dist_lists, a matrix to "
                        "local_eval_reach_into / local_eval_dist_into")
    check_args(mode != REACH, out, *args)
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"the local_eval kernel runs on cuda, not {dev}; "
                         f"core.engine.local_eval_* take the CPU")
    F, E = esrc.shape
    S, B = src_local.shape[1], out.B if lists else out.shape[0]
    if max(F * S, F * E, B, n_max + 1, tgt_local.stride(0),
           B if lists else out.stride(0)) >= 2 ** 31:
        raise ValueError("sizes and row pitches must fit in int32")
    cap = max(-1, min(int(cap), INF))
    index = dev.index
    if index == torch._C._cuda_getDevice():
        _launch(index, mode, out, args, cap, n_max)
    else:
        with torch.cuda.device(index):
            _launch(index, mode, out, args, cap, n_max)
    return out


def _launch(index: int, mode: int, out, args, cap: int, n_max: int) -> None:
    """One launch on the current stream of device ``index``, with its
    scratch; reads the deepest level back only while the recorder is on."""
    esrc, edst, src_local, src_row, tgt_local, s_local, t_local = args
    F, E = esrc.shape
    S = src_local.shape[1]
    plan, blocks = _card_plan(index, n_max, E, mode)
    lists = mode == LISTS
    dev = out.device
    B = out.B if lists else out.shape[0]
    slots = n_max + 1
    state = (None if plan.state_shared else
             torch.empty(blocks * 3 * slots, dtype=torch.int32, device=dev))
    dws = (torch.empty(blocks * BATCH * slots, dtype=torch.int32, device=dev)
           if mode != REACH else None)
    steps = (torch.zeros(1, dtype=torch.int32, device=dev) if tracing.ON
             else None)
    lib, fn, check = _entries()
    ptr = (lambda t: None if t is None else t.data_ptr())
    if lists:
        target = (out.pairs.data_ptr(), 0, out.count.data_ptr(),
                  out.meta.data_ptr())
    else:
        target = (out.data_ptr(), out.stride(0), None, None)
    code = fn(mode, *(a.data_ptr() for a in args[:5]),
              tgt_local.stride(0), s_local.data_ptr(), t_local.data_ptr(),
              *target, ptr(state), ptr(dws), ptr(steps), F, S, E, B, n_max,
              cap, int(plan.state_shared), int(plan.edges_shared),
              plan.smem, blocks, torch._C._cuda_getCurrentRawStream(index))
    _count_launch(mode)
    tracing.count("oneshot.local_launches")
    check(lib, "local_eval", code)
    if steps is not None:
        tracing.count("host.syncs")
        tracing.count("fixpoint.steps", int(steps[0]))


def local_eval_reach_into(out: torch.Tensor, esrc, edst, src_local, src_row,
                          tgt_local, s_local, t_local, *, n_max: int
                          ) -> torch.Tensor:
    """The reach rows of F fragments written into the bool ``out`` [B, B]
    (see the module docstring); returns ``out``."""
    return _local_eval(REACH, out, esrc, edst, src_local, src_row,
                       tgt_local, s_local, t_local, INF, n_max)


def local_eval_dist_into(out: torch.Tensor, esrc, edst, src_local, src_row,
                         tgt_local, s_local, t_local, cap: int = INF, *,
                         n_max: int) -> torch.Tensor:
    """The hop-distance rows of F fragments, capped at ``cap``, written
    into the int32 ``out`` [B, B]; returns ``out``."""
    return _local_eval(DIST, out, esrc, edst, src_local, src_row, tgt_local,
                       s_local, t_local, cap, n_max)


def local_eval_dist_lists(out: RowLists, esrc, edst, src_local, src_row,
                          tgt_local, s_local, t_local, cap: int = INF, *,
                          n_max: int) -> RowLists:
    """The hop-distance rows of F fragments, capped at ``cap``, stored as
    the lists of their finite (column, distance) pairs in ``out``, made by
    ``tropical_matmul.ops.row_lists`` (counts and meta zero): rows that no
    source owns keep the count 0, and a row that does not fit sets the
    overflow flags in ``out.meta[0]``; returns ``out``."""
    return _local_eval(LISTS, out, esrc, edst, src_local, src_row,
                       tgt_local, s_local, t_local, cap, n_max)
