"""localEval of the one-shot algorithms written straight into the
dependency matrix by a hand-written CUDA kernel.

The kernel, ``csrc/local_eval.cu``, replaces no TPU kernel: the JAX
package's localEval is ``jnp`` gather and scatter.  It serves
``core.engine.local_eval_reach`` / ``local_eval_dist`` when they are given
``out=`` on the card: every owned source row of F fragments, reach (D,
bool) or hop distance capped at ``cap`` (W, int32), is computed by a local
BFS on chip and written into ``out`` once, and every row that no source of
the F fragments owns gets the semiring zero (0, INF).  Each row is written
over its whole pitch: its pads hold the semiring zero too.  One launch a
call, counted in :data:`launches` and in the ``oneshot.local_launches``
count of :mod:`repro_torch.tracing`; nothing is read back unless the
recorder is on, when the launch's deepest level is read once and counted
as ``fixpoint.steps`` (and ``host.syncs``).

The plain version, which the engine runs on the CPU and the card tests
hold the kernel to, is the engine's own: the fixpoint of
``core.engine._propagate_*``, the gather of the ``[r, B]`` row block, and
the block written into ``out`` filled with the zero.

Layout rule (:func:`check_args`, on every device): ``out`` is ``[B, B]``
with contiguous rows whose base and pitch are multiples of 16 bytes and
whose storage holds the last row's pitch, as ``bool_matmul.padded`` and
``tropical_matmul.padded_i32`` make it; every input is int32 with
contiguous rows.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Tuple

import torch

from ... import tracing

#: core.engine.INF: the distance of a slot not reached
INF = 1 << 29

#: sources a batch of the kernel (one bit each of a word): the scratch of
#: a dist launch holds one distance a source and slot
BATCH = 32

#: launches of the kernel since the count was last set to 0
launches = 0

# guards the read-modify-write of the counter: a server's threads may
# launch at once
_count_lock = threading.Lock()


def _count_launch() -> None:
    """Add one to :data:`launches`, atomically."""
    global launches
    with _count_lock:
        launches += 1


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
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.local_eval_smem_limit.argtypes = []
    lib.local_eval_smem_limit.restype = ctypes.c_int
    lib.local_eval_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.local_eval_blocks_per_sm.restype = ctypes.c_int
    return lib, fn, check


@functools.cache
def _card_plan(index: int, n_max: int, E: int, dist: bool
               ) -> Tuple[Plan, int]:
    """:func:`_plan` with the card's shared memory, and the grid: every
    block the card holds at once."""
    lib = _entries()[0]
    with torch.cuda.device(index):
        limit = lib.local_eval_smem_limit()
        if limit < 0:
            raise RuntimeError("local_eval shared-memory query failed")
        plan = _plan(n_max, E, limit)
        per_sm = lib.local_eval_blocks_per_sm(int(dist), plan.smem)
    if per_sm <= 0:
        raise RuntimeError(f"local_eval occupancy query failed for "
                           f"{plan.smem} bytes of shared memory")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return plan, sms * per_sm


def check_args(dist: bool, out: torch.Tensor, esrc, edst, src_local,
               src_row, tgt_local, s_local, t_local) -> None:
    """Raise unless the arguments are what the kernel takes (the layout
    rule of the module docstring), on one device: ``out`` int32 for
    ``dist``, bool for reach."""
    dtype = torch.int32 if dist else torch.bool
    if out.dtype != dtype:
        raise TypeError(f"out must be {dtype}, got {out.dtype}")
    named = dict(esrc=esrc, edst=edst, src_local=src_local, src_row=src_row,
                 tgt_local=tgt_local, s_local=s_local, t_local=t_local)
    for name, x in named.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != out.device:
            raise ValueError(f"{name} on {x.device}, out on {out.device}")
    F, E = esrc.shape if esrc.dim() == 2 else (-1, -1)
    S = src_local.shape[1] if src_local.dim() == 2 else -1
    B = out.shape[0] if out.dim() == 2 else -1
    want = dict(esrc=(F, E), edst=(F, E), src_local=(F, S),
                src_row=(F, S), tgt_local=(F, B), s_local=(F,),
                t_local=(F,))
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, "
                             f"expected {shape}")
    if F < 0 or S < 1 or B < 2 or tuple(out.shape) != (B, B):
        raise ValueError(f"out must be [B, B] with B >= 2 and sources "
                         f"[F, S >= 1], got {tuple(out.shape)} and "
                         f"{tuple(src_local.shape)}")
    for name in ("esrc", "edst", "src_local", "src_row", "s_local",
                 "t_local"):
        if not named[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tgt_local.stride(1) != 1:
        raise ValueError("tgt_local's rows must be contiguous")
    size = out.element_size()
    if (out.stride(1) != 1 or out.stride(0) < B
            or out.stride(0) * size % 16 or out.data_ptr() % 16):
        raise ValueError(f"out must be padded storage: contiguous rows "
                         f"whose base and pitch are multiples of 16 bytes "
                         f"(strides {out.stride()}, {size}-byte entries)")
    if (out.untyped_storage().nbytes()
            < (out.storage_offset() + B * out.stride(0)) * size):
        raise ValueError("out's storage ends before its last row's pitch")


def _local_eval(dist: bool, out, esrc, edst, src_local, src_row, tgt_local,
                s_local, t_local, cap: int, n_max: int) -> torch.Tensor:
    args = (esrc, edst, src_local, src_row, tgt_local, s_local, t_local)
    check_args(dist, out, *args)
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"the local_eval kernel runs on cuda, not {dev}; "
                         f"core.engine.local_eval_* take the CPU")
    F, E = esrc.shape
    S, B = src_local.shape[1], out.shape[0]
    if max(F * S, F * E, B, n_max + 1, tgt_local.stride(0),
           out.stride(0)) >= 2 ** 31:
        raise ValueError("sizes and row pitches must fit in int32")
    cap = max(-1, min(int(cap), INF))
    index = dev.index
    if index == torch._C._cuda_getDevice():
        _launch(index, dist, out, args, cap, n_max)
    else:
        with torch.cuda.device(index):
            _launch(index, dist, out, args, cap, n_max)
    return out


def _launch(index: int, dist: bool, out, args, cap: int, n_max: int) -> None:
    """One launch on the current stream of device ``index``, with its
    scratch; reads the deepest level back only while the recorder is on."""
    esrc, edst, src_local, src_row, tgt_local, s_local, t_local = args
    F, E = esrc.shape
    S, B = src_local.shape[1], out.shape[0]
    plan, blocks = _card_plan(index, n_max, E, dist)
    dev = out.device
    slots = n_max + 1
    state = (None if plan.state_shared else
             torch.empty(blocks * 3 * slots, dtype=torch.int32, device=dev))
    dws = (torch.empty(blocks * BATCH * slots, dtype=torch.int32, device=dev)
           if dist else None)
    steps = (torch.zeros(1, dtype=torch.int32, device=dev) if tracing.ON
             else None)
    lib, fn, check = _entries()
    ptr = (lambda t: None if t is None else t.data_ptr())
    code = fn(int(dist), *(a.data_ptr() for a in args[:5]),
              tgt_local.stride(0), s_local.data_ptr(), t_local.data_ptr(),
              out.data_ptr(), out.stride(0), ptr(state), ptr(dws),
              ptr(steps), F, S, E, B, n_max, cap, int(plan.state_shared),
              int(plan.edges_shared), plan.smem, blocks,
              torch._C._cuda_getCurrentRawStream(index))
    _count_launch()
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
    return _local_eval(False, out, esrc, edst, src_local, src_row, tgt_local,
                       s_local, t_local, INF, n_max)


def local_eval_dist_into(out: torch.Tensor, esrc, edst, src_local, src_row,
                         tgt_local, s_local, t_local, cap: int = INF, *,
                         n_max: int) -> torch.Tensor:
    """The hop-distance rows of F fragments, capped at ``cap``, written
    into the int32 ``out`` [B, B]; returns ``out``."""
    return _local_eval(True, out, esrc, edst, src_local, src_row, tgt_local,
                       s_local, t_local, cap, n_max)
