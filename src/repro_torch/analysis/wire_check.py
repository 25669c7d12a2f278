"""Wire invariant checker: machine-check the paper's theorems on the
collectives a program really issues.

The reference package lowers each sharded program to HLO text and parses
the collectives out of it.  Torch lowers no program; instead every
collective of the port goes through ``core.distributed._all_reduce``,
which records it while :func:`repro_torch.core.distributed.
record_collectives` is open (op, dtype, shape, bits, and whether a
fixpoint loop of the engine was running).  :func:`model_of` turns one such
record into a :class:`ProgramModel`, and :func:`check_program` verifies,
per program, the reference's rules under the reference's ids:

* **HLO001** exactly one collective per program (Theorem 1: one visit per
  site == one communication round);
* **HLO002** no collective inside a fixpoint loop (a loop around the wire
  silently breaks the one-round bound);
* **HLO003** the collective payload bits equal the
  :meth:`Fragmentation.traffic_bits` (or ``traffic_bits_update``) wire
  model;
* **HLO004** no wire dimension scales with ``|V|`` or ``|E|`` (Theorem 2:
  traffic independent of ``|G|``).

The programs are run for real, on every rank of the process group at
once, so :func:`verify_fragmentation` is called by every rank.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .report import Violation

_DTYPE_BITS = {
    "bool": 8, "int8": 8, "uint8": 8, "int16": 16, "uint16": 16,
    "float16": 16, "bfloat16": 16, "int32": 32, "uint32": 32,
    "float32": 32, "int64": 64, "uint64": 64, "float64": 64,
}


def _dtype_bits(dtype: str) -> int:
    try:
        return _DTYPE_BITS[dtype]
    except KeyError:
        raise ValueError(
            f"unknown element type {dtype!r} on the wire; add it to "
            "repro_torch.analysis.wire_check._DTYPE_BITS") from None


@dataclasses.dataclass(frozen=True)
class TensorType:
    """One tensor crossing the wire."""

    dtype: str
    dims: Tuple[int, ...]

    @property
    def bits(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n * _dtype_bits(self.dtype)

    @property
    def bytes(self) -> int:
        return self.bits // 8

    def __str__(self) -> str:
        return f"{self.dtype}[{','.join(str(d) for d in self.dims)}]"


@dataclasses.dataclass
class CollectiveOp:
    """One collective of a program run (an in-place all-reduce: its
    operand and its result are the same tensor)."""

    kind: str                     # "all-reduce"
    op: str                       # the reduction: "sum" | "min"
    index: int                    # position in the program's collectives
    in_loop: bool                 # issued inside a fixpoint loop
    operands: List[TensorType]
    results: List[TensorType]

    @property
    def payload_bits(self) -> int:
        return sum(t.bits for t in self.results)

    def describe(self) -> str:
        res = ", ".join(str(t) for t in self.results)
        return f"{self.kind}<{self.op}>({res}) #{self.index}"


@dataclasses.dataclass
class ProgramModel:
    """Structured view of one program run."""

    collectives: List[CollectiveOp]
    n_fixpoints: int              # fixpoint loops the run entered

    @property
    def payload_bits(self) -> int:
        return sum(c.payload_bits for c in self.collectives)


def model_of(record) -> ProgramModel:
    """The :class:`ProgramModel` of a
    :class:`~repro_torch.core.distributed.CollectiveRecord`: the role the
    reference's HLO parser plays for a lowered program."""
    ops = []
    for i, e in enumerate(record.entries):
        t = TensorType(e.dtype, tuple(e.shape))
        if t.bits != e.bits:
            raise ValueError(f"collective #{i} records {e.bits} bits, but "
                             f"{t} holds {t.bits}")
        ops.append(CollectiveOp(kind=e.kind, op=e.op, index=i,
                                in_loop=e.in_fixpoint, operands=[t],
                                results=[t]))
    return ProgramModel(ops, record.fixpoints)


# --------------------------------------------------------------------------
# Invariant checks


def check_program(model: ProgramModel, *, program: str = "<program>",
                  expect_count: Optional[int] = 1,
                  expected_bits: Optional[int] = None,
                  forbidden_dims: Sequence[int] = (),
                  allowed_dims: Sequence[int] = ()) -> List[Violation]:
    """Run HLO001-HLO004 against one program's model."""
    vs: List[Violation] = []
    if expect_count is not None and len(model.collectives) != expect_count:
        vs.append(Violation(
            "HLO001",
            f"expected exactly {expect_count} collective(s), found "
            f"{len(model.collectives)}",
            where=program,
            context=", ".join(c.describe() for c in model.collectives)))
    for c in model.collectives:
        if c.in_loop:
            vs.append(Violation(
                "HLO002",
                f"{c.kind} issued inside a fixpoint loop — breaks the "
                "one-visit-per-site bound",
                where=program, context=c.describe()))
    if expected_bits is not None:
        got = model.payload_bits
        if got != expected_bits:
            vs.append(Violation(
                "HLO003",
                f"collective payload {got} bits != traffic_bits model "
                f"{expected_bits} bits",
                where=program,
                context=", ".join(c.describe() for c in model.collectives)))
    if forbidden_dims:
        forbidden = set(forbidden_dims) - set(allowed_dims)
        for c in model.collectives:
            seen = set()
            for t in list(c.operands) + list(c.results):
                for d in t.dims:
                    if d in forbidden and d not in seen:
                        seen.add(d)
                        vs.append(Violation(
                            "HLO004",
                            f"wire tensor {t} carries graph-sized dim {d} — "
                            "traffic must not scale with |G|",
                            where=program))
    return vs


def _words(cols: int) -> int:
    return (cols + 31) // 32


def _wire_model(fr, kind: str, batch: int, states: int
                ) -> Tuple[int, Tuple[int, int]]:
    """Expected (bits, (rows, cols)) of the one collective of a program:
    a fused batch of ``kind``, the one-shot disReach (``"oneshot"``) or
    the cache update over ``batch`` changed rows (``"update"``)."""
    if kind == "oneshot":
        return fr.traffic_bits("reach"), (fr.B, _words(fr.B))
    if kind == "update":
        cols = _words(fr.n_boundary) + _words(fr.n_max + 1)
        return fr.traffic_bits_update(batch), (batch, cols)
    side = fr.n_boundary * states
    rows, cols = side + 2 * batch, side + 1
    if kind in ("reach", "rpq"):
        cols = _words(cols)
    return fr.traffic_bits(kind, states=states, batch=batch), (rows, cols)


KINDS = ("reach", "dist", "rpq", "oneshot", "update")


def verify_fragmentation(fr, *, batch: int = 2, qa=None, placement=None,
                         group=None, device=None,
                         kinds: Sequence[str] = KINDS,
                         tag: str = "") -> List[Violation]:
    """Run each program on ``fr`` once under a collective record over the
    process group ``group`` and check HLO001-HLO004 against the wire
    model: the fused batch of ``batch`` pairs for ``"reach"``, ``"dist"``
    and ``"rpq"``; the one-shot disReach (``"oneshot"``); and the cache
    update over the first changed rows (``"update"``: it reads the reach
    cache, which is built on ``device`` if ``fr`` has none).  Every rank
    of the group calls it; the programs run for real."""
    from ..core import distributed, incremental
    from ..core.automaton import build_query_automaton
    from ..core.cache import prepare_rvset_cache
    from ..core.session import _resolve_device

    if qa is None:
        qa = build_query_automaton("(0|1)*", lambda x: int(x))
    n = fr.g.n
    pairs = [(i % n, (i + 1) % n) for i in range(batch)]
    forbidden = {int(fr.g.n), int(fr.g.src.size)}
    vs: List[Violation] = []
    for kind in kinds:
        states = qa.n_states if kind == "rpq" else 1
        size = batch
        if kind == "oneshot":
            rec = distributed.trace_reach_collectives(
                fr, 0, n - 1, group=group, placement=placement,
                device=device)
        elif kind == "update":
            if fr.nb_active == 0:
                continue             # no boundary row can change
            if fr.rvset_cache is None:
                prepare_rvset_cache(fr, _resolve_device(device))
            rows = incremental.pad_row_ids(np.arange(min(3, fr.nb_active)),
                                           pad=8, cap=fr.n_boundary)
            size = len(rows)
            rec = distributed.trace_update_collectives(
                fr, rows, group=group, placement=placement)
        else:
            rec = distributed.trace_batch_collectives(
                fr, pairs, kind, qa=qa if kind == "rpq" else None,
                group=group, placement=placement, device=device)
        bits, (rows_, cols) = _wire_model(fr, kind, size, states)
        vs.extend(check_program(
            model_of(rec), program=f"{tag}{kind}[batch={size}]",
            expect_count=1, expected_bits=bits, forbidden_dims=forbidden,
            allowed_dims=(rows_, cols)))
    return vs


def verify_session(session, *, batch: int = 2, qa=None,
                   kinds: Sequence[str] = KINDS) -> List[Violation]:
    """Public entry point: verify the paper's guarantees on the wire of a
    user's sharded :class:`~repro_torch.core.session.QuerySession` (its
    group, placement and device).  Every rank calls it.  Returns the
    (empty on success) violation list."""
    if session.backend != "shard_map":
        raise ValueError("verify_session checks the collectives of a "
                         "backend='shard_map' session; this one runs "
                         f"{session.backend!r}")
    return verify_fragmentation(
        session.fr, batch=batch, qa=qa, placement=session.placement,
        group=session.group, device=session.device, kinds=kinds)


def verify_store(store, *, batch: int = 2, qa=None,
                 kinds: Sequence[str] = KINDS) -> List[Violation]:
    """Verify every live MVCC version of a
    :class:`~repro_torch.core.versions.VersionedCacheStore`: one collective
    on every snapshot a reader can still pin."""
    session = store.session
    if session.backend != "shard_map":
        raise ValueError("verify_store checks a store over a "
                         "backend='shard_map' session")
    vs: List[Violation] = []
    for ver in store.live():
        vs.extend(verify_fragmentation(
            ver.fr, batch=batch, qa=qa, placement=session.placement,
            group=session.group, device=session.device, kinds=kinds,
            tag=f"v{ver.vid}:"))
    return vs
