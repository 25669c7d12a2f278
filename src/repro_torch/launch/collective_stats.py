"""The collectives a step issues, and their bytes: the port's counterpart
of ``repro.launch.hlo_stats``.

The reference parses them out of a lowered HLO module.  PyTorch has no
HLO to parse: DTensor issues its collectives eagerly, as functional
collectives (``torch.ops._c10d_functional``) from ``redistribute`` and
its op rules, and ``distribute_tensor`` as ``torch.ops.c10d`` calls.
:func:`record_step_collectives` is a dispatch mode that records each one
as it is issued, as ``torch.distributed.tensor.debug.CommDebugMode``
counts them: it lets DTensor's own dispatch run first (a DTensor op
returns ``NotImplemented`` to the mode), so the mode sees the
collectives that op turns into.  :func:`collective_bytes` sums the sizes
of their results under the reference's kind names, as the reference
does.

Some redistributions of the port's model code have no counterpart in
the reference's program: each steps around a DTensor gap (a departure
from GSPMD, listed in PERF.md).  Such a call runs through
:func:`departure`, which labels every collective it starts, in the
forward and in its backward, with the departure's name, so that the
dry run can count them apart (:func:`split_departures`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Tuple, TypeVar

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

# (substring of the op's name, the reference's kind), first match wins
_KINDS = (("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_gather", "all-gather"),
          ("allgather", "all-gather"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("broadcast", "collective-broadcast"),
          ("scatter", "collective-broadcast"))
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
# HLO's element type names, for the schedule's strings
_HLO_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64",
              torch.int32: "s32", torch.int64: "s64", torch.int8: "s8",
              torch.uint8: "u8", torch.bool: "pred"}


@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str                                   # the reference's kind name
    results: Tuple[Tuple[torch.dtype, Tuple[int, ...]], ...]
    nbytes: int                                 # bytes of its results
    departure: str = ""                         # its departure's name, if any


# the names of the departures being run, innermost last: a departure's
# backward runs inside the autograd engine, after its forward has returned
_DEPARTING: List[str] = []
T = TypeVar("T")


def departure(name: str, redistribute: Callable[[], T]) -> T:
    """``redistribute()``, a redistribution that GSPMD would not make,
    with every collective it starts labelled ``name``: those of the call
    itself and, through hooks on the result's autograd node, those of its
    backward."""
    _DEPARTING.append(name)
    try:
        out = redistribute()
    finally:
        _DEPARTING.pop()
    node = getattr(out, "grad_fn", None)
    if node is not None:
        def enter(grads_out):
            _DEPARTING.append(name)

        def leave(grads_in, grads_out):
            _DEPARTING.pop()

        node.register_prehook(enter)
        node.register_hook(leave)
    return out


def _kind(func) -> str:
    packet = func.overloadpacket
    if getattr(packet, "_qualified_op_name", "").split("::")[0] \
            not in _NAMESPACES:
        return ""
    name = packet.__name__
    if name.startswith("wait"):
        return ""
    for key, kind in _KINDS:
        if key in name:
            return kind
    return ""


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


class _Recorder(TorchDispatchMode):
    def __init__(self, record: List[Collective]):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor first; its comms come back
        out = func(*args, **(kwargs or {}))
        kind = _kind(func)
        if kind:
            res = _tensors(out)
            self.record.append(Collective(
                kind, tuple((t.dtype, tuple(t.shape)) for t in res),
                sum(t.numel() * t.element_size() for t in res),
                _DEPARTING[-1] if _DEPARTING else ""))
        return out


@contextlib.contextmanager
def record_step_collectives() -> Iterator[List[Collective]]:
    """``with record_step_collectives() as record:`` — ``record`` is the
    list of every collective issued inside the block, in order."""
    record: List[Collective] = []
    _DEPARTING.clear()          # a failed backward may have left one behind
    with _Recorder(record):
        yield record


def collective_bytes(record: List[Collective]) -> Dict[str, int]:
    """{kind: bytes, ..., 'total': bytes, 'count': n}: the sizes of every
    recorded collective's results, summed by kind."""
    out: Dict[str, int] = {}
    for c in record:
        out[c.kind] = out.get(c.kind, 0) + c.nbytes
    out["total"] = sum(out.values())
    out["count"] = len(record)
    return out


def split_departures(record: List[Collective]
                     ) -> Tuple[List[Collective], Dict[str, List[Collective]]]:
    """(the collectives GSPMD would make too, {departure name: its
    collectives}), each in the order they were started."""
    kept, apart = [], {}
    for c in record:
        if c.departure:
            apart.setdefault(c.departure, []).append(c)
        else:
            kept.append(c)
    return kept, apart


def _hlo_type(dtype, shape) -> str:
    return f"{_HLO_TYPES.get(dtype, str(dtype))}[{','.join(map(str, shape))}]"


def collective_schedule(record: List[Collective],
                        limit: int = 12) -> List[str]:
    """The first ``limit`` collectives with their result types, as the
    reference writes them: ``all-gather(f32[32,4096])``."""
    items = []
    for c in record[:limit]:
        shapes = ", ".join(_hlo_type(d, s) for d, s in c.results)
        shape = shapes if len(c.results) == 1 else f"({shapes})"
        items.append(f"{c.kind}({shape})")
    return items
