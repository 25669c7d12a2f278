"""Sharded backend: fragments packed onto the ranks of a torch.distributed
process group (d <= k), ONE collective per fused batch.

A :class:`~repro_torch.core.fragments.Placement` maps every fragment to a
rank (several fragments per rank when ``k > d``).  Every rank builds the
same fragmentation and placement, runs the local stage of its owned
fragments with no communication (``core.cache.local_stage_*_packed``),
joins the single collective that assembles the boundary dependency matrix
and the per-pair rows, and then runs the closure and the combine
replicated, so every rank returns the same answers.

Performance-guarantee mapping (checked by tests/test_torch_sharded.py):
  * "each site visited once"  -> exactly one collective per fused batch,
    none inside a fixpoint loop: every collective goes through
    :func:`_all_reduce`, which counts calls and payload bits;
  * "traffic O(|V_f|^2)" bits -> the payload is ``[side + 2N, side + 1]``
    (``side = |V_f|``, or ``|V_f| |Q|`` for RPQs; one s-row and one t-row
    per pair; the extra column carries the per-pair direct answer):
    bitpacked 32-bit words for the Boolean kinds, raw int32 for the
    tropical one, so the bits equal ``Fragmentation.traffic_bits(kind,
    states, batch=N)`` and do not depend on |G|.

The Boolean wire is merged with SUM over int32 words: every bit is set on
exactly one rank (d0/sb rows by their owner, tc columns by frag(u)), so
no carry occurs and SUM equals OR.  MAX would not do: a word with bit 31
set is negative and loses to the zero words of the other ranks, and NCCL
has no bitwise-OR reduce.  The tropical wire is merged with MIN, exact
because non-owners ship INF, the tropical zero.

The single-query :func:`dis_reach_sharded` / :func:`dis_rpq_sharded` are
the paper's one-shot algorithms over the same group: each rank assembles
its owned fragments' rvset row blocks into one dependency matrix, ONE
bitpacked collective merges them (``traffic_bits("reach")`` or
``traffic_bits("rpq", states=Q)`` bits), and evalDG runs replicated.

:func:`apply_delta_sharded` repairs a reach cache for an insert-only
delta over the same group: each rank resumes the fixpoints of the dirty
fragments it owns, and ONE bitpacked collective ships only the changed
boundary rows (``traffic_bits_update(r)`` bits); the rank-style closure
update then runs replicated.

Every collective is recorded by :func:`record_collectives` (op, dtype,
shape, bits, and whether a fixpoint loop was running): the port's
counterpart of the reference's lowered programs, which
``repro_torch.analysis.wire_check`` checks as the reference checks HLO.
``trace_reach_collectives``, ``trace_batch_collectives`` and
``trace_update_collectives`` run one program under a record.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import cache as _cache
from . import engine
from ..kernels.bitpack_ops.ops import pack_payload, unpack_payload
from ..kernels.bool_matmul.ops import padded_zeros
from .automaton import QueryAutomaton
from .bes import bool_closure_kmajor, tropical_closure
from .engine import INF
from .fragments import Fragmentation, Placement, query_slots

#: collectives issued by :func:`_all_reduce` since the count was set to 0
collectives = 0
#: bits those collectives shipped (numel x element size x 8, per rank)
payload_bits = 0

# guards the read-modify-write of the two counts across threads
_count_lock = threading.Lock()


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """The ONE collective of a fused batch, in place on ``x``; every
    collective of the sharded backend goes through here and is counted
    (and recorded, under :func:`record_collectives`)."""
    dist.all_reduce(x, op=op, group=group)
    bits = x.numel() * x.element_size() * 8
    _count_collective(bits)
    trace = engine.TRACE
    if trace.recording:
        trace.record.entries.append(CollectiveEntry(
            kind="all-reduce", op=getattr(op, "name", str(op)).lower(),
            dtype=str(x.dtype).rsplit(".", 1)[-1], shape=tuple(x.shape),
            bits=bits, in_fixpoint=trace.depth > 0))
    return x


def _count_collective(bits: int) -> None:
    """Add one collective of ``bits`` bits to the counts, atomically."""
    global collectives, payload_bits
    with _count_lock:
        collectives += 1
        payload_bits += bits


# ---------------------------------------------------------------------------
# the collective record: what a program put on the wire
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveEntry:
    """One collective issued while a :func:`record_collectives` was open."""

    kind: str                 # "all-reduce" (the one kind the port issues)
    op: str                   # the reduction: "sum" or "min"
    dtype: str                # torch dtype name of the wire, e.g. "int32"
    shape: Tuple[int, ...]    # the wire tensor's shape, per rank
    bits: int                 # numel x element size x 8
    in_fixpoint: bool         # issued while a fixpoint loop was running


@dataclasses.dataclass
class CollectiveRecord:
    """The collectives of one program run, in order, and the fixpoint
    loops it entered (``engine.FIXPOINT``)."""

    entries: List[CollectiveEntry] = dataclasses.field(default_factory=list)
    fixpoints: int = 0

    @property
    def payload_bits(self) -> int:
        return sum(e.bits for e in self.entries)


@contextlib.contextmanager
def record_collectives():
    """Record every collective this thread issues inside the block; yields
    the :class:`CollectiveRecord`, complete once the block ends.  While it
    is open the engine's fixpoint loops mark themselves, so an entry says
    whether it ran inside one.  Records do not nest."""
    trace = engine.TRACE
    if trace.recording:
        raise RuntimeError("record_collectives() is already open on this "
                           "thread")
    rec = CollectiveRecord()
    trace.record, trace.depth, trace.loops = rec, 0, 0
    trace.recording = True
    try:
        yield rec
    finally:
        trace.recording = False
        rec.fixpoints = trace.loops
        trace.record = None


def _require_process_group() -> None:
    """Raise unless a torch.distributed process group is initialized: the
    sharded backend never creates one behind the caller's back."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "backend='shard_map' runs one collective per fused batch over a "
            "torch.distributed process group, and none is initialized; "
            "call torch.distributed.init_process_group(...) first (one rank "
            "per device: world_size=1 on one card)")


def _no_mark(phase: str) -> None:
    pass


def _split_merged(merged, side: int, N: int):
    """Undo the payload concatenation: (d0, sb, direct, tc)."""
    return (merged[:side, :side], merged[side:side + N, :side],
            merged[side:side + N, side], merged[side + N:, :side])


def _resolve_placement(fr: Fragmentation, group,
                       placement: Optional[Placement]) -> Placement:
    """The placement the sharded engines run: :meth:`Placement.balanced`
    over the group's ranks by default.  Raises ValueError when it does
    not fit the fragmentation or the group (including d > k: a fragment
    is never split across ranks)."""
    _require_process_group()
    d = dist.get_world_size(group)
    if placement is None:
        placement = Placement.balanced(fr, d)
    if placement.k != fr.k:
        raise ValueError(f"placement maps {placement.k} fragments but the "
                         f"fragmentation has {fr.k}")
    if placement.d != d:
        raise ValueError(f"the process group has {d} ranks but the "
                         f"placement expects {placement.d}")
    return placement


def _pack_rows(arr: np.ndarray, perm: np.ndarray, pad) -> np.ndarray:
    """Reorder a stacked [k, ...] per-fragment array into the rank-major
    [d*fpd, ...] packed layout; pad slots (perm == -1) are filled with the
    array's inert value."""
    out = np.full((len(perm),) + arr.shape[1:], pad, dtype=arr.dtype)
    valid = perm >= 0
    out[valid] = arr[perm[valid]]
    return out


def _srcidx_own(fr: Fragmentation):
    """Host-side inverse of ``src_row``: for each fragment, the source-row
    index of every boundary position it owns (pad row ``S-1``, the
    reserved s slot, elsewhere) plus the ownership mask.  [k, nb] each."""
    src_row = fr.arrays["src_row"]                         # [k, S]
    k, S, nb = fr.k, src_row.shape[1], fr.n_boundary
    srcidx = np.full((k, nb), S - 1, dtype=np.int32)
    own = np.zeros((k, nb), dtype=bool)
    for i in range(k):
        mine = src_row[i] < fr.B - 2
        srcidx[i, src_row[i, mine]] = np.nonzero(mine)[0]
        own[i, src_row[i, mine]] = True
    return srcidx, own


# inert pad values per fragment array: pad fragments read as "no edges, no
# sources, no ownership", so their local stages contribute only semiring
# zeros to the on-rank merge
def _array_pads(fr: Fragmentation) -> dict:
    return dict(esrc=fr.n_max, edst=fr.n_max, src_local=fr.n_max,
                src_row=fr.B, tgt_local=fr.n_max, labels=-9, gids=-1,
                n_local=0)


# live entries in a Fragmentation's device-upload memo: a small LRU, so
# that alternate placements (and, with the delta slice, versions) do not
# thrash each other's uploads while stale ones are bounded
_UPLOAD_MEMO_CAP = 4


def _device_inputs(fr: Fragmentation, placement: Placement, rank: int,
                   device) -> dict:
    """Query-independent uploads for the batched sharded engines: this
    rank's ``fpd`` rows of the fragment arrays and of the boundary-
    ownership gathers, in the placement's rank-major packed layout.
    Memoized in a small per-Fragmentation LRU keyed on
    ``(fr.arrays_version, placement.cache_key(), rank, device)``, so
    steady-state batches skip the host-to-device copy of the edge lists;
    a mutation of the host arrays (which bumps ``arrays_version``) or a
    new placement starts a fresh entry."""
    device = torch.device(device)
    memos = fr.__dict__.setdefault("_sharded_device_inputs", OrderedDict())
    key = (fr.arrays_version, placement.cache_key(), rank, str(device))
    memo = memos.get(key)
    if memo is not None:
        memos.move_to_end(key)
        return memo
    perm = placement.perm()
    rows = slice(rank * placement.fpd, (rank + 1) * placement.fpd)
    pads = _array_pads(fr)
    srcidx, own = _srcidx_own(fr)
    mine = fr.boundary_owner()[None, :] == np.arange(fr.k)[:, None]
    mine[:, fr.nb_active:] = False     # spare slots are owned by nobody

    def upload(arr, pad):
        return torch.tensor(_pack_rows(arr, perm, pad)[rows], device=device)

    memo = dict(
        perm=perm, rows=rows,
        arrs={name: upload(v, pads[name]) for name, v in fr.arrays.items()},
        srcidx=upload(srcidx, fr.s_max - 1), own=upload(own, False),
        mine=upload(mine, False),
        local_b=torch.tensor(fr.boundary_local(), device=device))
    memos[key] = memo
    while len(memos) > _UPLOAD_MEMO_CAP:
        memos.popitem(last=False)
    return memo


# ---------------------------------------------------------------------------
# the three batch programs: local stage -> ONE collective -> replicated
# closure and combine.  ``mark(phase)`` is called as each phase begins
# ("local", "collective", "closure", "combine") and once at the end
# ("end"); a caller can record CUDA events there to time the phases.
# ---------------------------------------------------------------------------

def _batch_reach(esrc, edst, src_local, tgt_local, s_slot, t_slot, srcidx,
                 own, *, nb: int, n_max: int, group,
                 mark: Callable[[str], None] = _no_mark):
    mark("local")
    d0, sb, direct, tc = _cache.local_stage_reach_packed(
        esrc, edst, src_local, s_slot, t_slot, srcidx, own,
        tgt_local[:, :nb], n_max=n_max)
    N = sb.shape[0]
    payload = torch.zeros((nb + 2 * N, nb + 1), dtype=torch.bool,
                          device=d0.device)
    payload[:nb, :nb] = d0
    payload[nb:nb + N, :nb] = sb
    payload[nb:nb + N, nb] = direct
    payload[nb + N:, :nb] = tc
    del d0, sb, direct, tc
    mark("collective")
    merged = unpack_payload(
        _all_reduce(pack_payload(payload), dist.ReduceOp.SUM, group), nb + 1)
    d0_m, sb_m, direct_m, tc_m = _split_merged(merged, nb, N)
    mark("closure")
    _, Ct = bool_closure_kmajor(d0_m)
    mark("combine")
    ans = _cache.combine_bool(direct_m, sb_m, tc_m, Ct)
    mark("end")
    return ans


def _batch_dist(esrc, edst, src_local, tgt_local, s_slot, t_slot, srcidx,
                own, *, nb: int, n_max: int, group,
                mark: Callable[[str], None] = _no_mark):
    mark("local")
    w0, sb, direct, tc = _cache.local_stage_dist_packed(
        esrc, edst, src_local, s_slot, t_slot, srcidx, own,
        tgt_local[:, :nb], n_max=n_max)
    N = sb.shape[0]
    payload = torch.full((nb + 2 * N, nb + 1), INF, dtype=torch.int32,
                         device=w0.device)
    payload[:nb, :nb] = w0
    payload[nb:nb + N, :nb] = sb
    payload[nb:nb + N, nb] = direct
    payload[nb + N:, :nb] = tc
    del w0, sb, direct, tc
    mark("collective")
    # int32 rows do not bitpack: the wire carries the rows each rank
    # contributes, never the B^2 matrix
    merged = _all_reduce(payload, dist.ReduceOp.MIN, group)
    w0_m, sb_m, direct_m, tc_m = _split_merged(merged, nb, N)
    mark("closure")
    Cd = tropical_closure(w0_m)
    mark("combine")
    ans = _cache.combine_dist(direct_m, sb_m, tc_m, Cd)
    mark("end")
    return ans


def _batch_rpq(esrc, edst, src_local, src_row, tgt_local, labels, gids,
               s_slot, t_slot, mine, q_labels, q_trans, s_gids, t_gids,
               local_b, *, n_max: int, B: int, q_start: int, group,
               mark: Callable[[str], None] = _no_mark):
    mark("local")
    d0, sb, direct, tc = _cache.local_stage_rpq_packed(
        esrc, edst, src_local, src_row, tgt_local, labels, gids, q_labels,
        q_trans, q_start, s_slot, t_slot, s_gids, t_gids, local_b, mine,
        n_max=n_max, B=B)
    side, N = d0.shape[0], sb.shape[0]
    payload = torch.zeros((side + 2 * N, side + 1), dtype=torch.bool,
                          device=d0.device)
    payload[:side, :side] = d0
    payload[side:side + N, :side] = sb
    payload[side:side + N, side] = direct
    payload[side + N:, :side] = tc
    del d0, sb, direct, tc
    mark("collective")
    merged = unpack_payload(
        _all_reduce(pack_payload(payload), dist.ReduceOp.SUM, group),
        side + 1)
    d0_m, sb_m, direct_m, tc_m = _split_merged(merged, side, N)
    mark("closure")
    _, Ct = bool_closure_kmajor(d0_m)
    mark("combine")
    ans = _cache.combine_bool(direct_m, sb_m, tc_m, Ct)
    mark("end")
    return ans


def _batch_sharded_program(fr: Fragmentation, pairs: np.ndarray, kind: str,
                           qa: Optional[QueryAutomaton] = None, group=None,
                           placement: Optional[Placement] = None,
                           device=None, chaos=None):
    """``(program, args)`` for one fused N-pair sharded batch of ``kind``
    on this rank; ``program(*args)`` returns the [N] answers on
    ``device`` (``None``: the current CUDA device, raising
    :class:`~repro_torch.errors.NoCudaDevice` without one).  ``chaos`` is
    consulted at the ``"upload"`` site before the fragment arrays go to
    the device."""
    from .session import _resolve_device          # session imports us
    device = _resolve_device(device)
    placement = _resolve_placement(fr, group, placement)
    if chaos is not None:
        chaos.maybe_fail("upload")     # guards the _device_inputs transfer
    k, n_max, N = fr.k, fr.n_max, len(pairs)
    ss, tt = pairs[:, 0], pairs[:, 1]
    # per-fragment query inputs: [k, N] local slots of s and t (n_max
    # absent), cut below to this rank's rows of the packed layout
    s_slots = np.full((k, N), n_max, dtype=np.int32)
    s_slots[fr.part[ss], np.arange(N)] = fr.owner_local[ss]
    t_slots = fr.slot_index()[tt, :].T.copy()              # [k, N]
    inp = _device_inputs(fr, placement, dist.get_rank(group), device)
    perm, rows, arrs = inp["perm"], inp["rows"], inp["arrs"]
    s_slot = torch.tensor(_pack_rows(s_slots, perm, n_max)[rows],
                          device=device)
    t_slot = torch.tensor(_pack_rows(t_slots, perm, n_max)[rows],
                          device=device)
    if kind == "rpq":
        args = (arrs["esrc"], arrs["edst"], arrs["src_local"],
                arrs["src_row"], arrs["tgt_local"], arrs["labels"],
                arrs["gids"], s_slot, t_slot, inp["mine"],
                torch.tensor(qa.state_labels, device=device),
                torch.tensor(qa.trans, device=device),
                torch.tensor(ss.astype(np.int32), device=device),
                torch.tensor(tt.astype(np.int32), device=device),
                inp["local_b"])
        return functools.partial(_batch_rpq, n_max=n_max, B=fr.B,
                                 q_start=int(qa.start), group=group), args
    program = {"reach": _batch_reach, "dist": _batch_dist}[kind]
    args = (arrs["esrc"], arrs["edst"], arrs["src_local"], arrs["tgt_local"],
            s_slot, t_slot, inp["srcidx"], inp["own"])
    return functools.partial(program, nb=fr.n_boundary, n_max=n_max,
                             group=group), args


def _as_batch_pairs(pairs) -> np.ndarray:
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def dis_reach_batch_sharded(fr: Fragmentation, pairs, group=None,
                            placement: Optional[Placement] = None,
                            device=None, chaos=None) -> np.ndarray:
    """Answer N (s, t) pairs over the process group with a single
    collective.

    Each rank contributes, for its owned fragments: their rows of the
    boundary dependency matrix D0, the s-row and direct bit of every pair
    whose source they hold, and the t-column entries of their own
    in-nodes, merged on the rank first, so the wire is the same as with
    one fragment per rank.  All three ride ONE bitpacked SUM (== OR); the
    closure and the per-pair combine run replicated.  Returns [N] bool on
    every rank.

    ``chaos`` (any object with ``maybe_fail(site, pairs=None)``) is
    consulted at the ``"upload"`` site and then, with the batch's pairs,
    at the ``"engine.shard_map"`` site before the program runs."""
    pairs = _as_batch_pairs(pairs)
    if len(pairs) == 0:
        return np.zeros(0, dtype=bool)
    run, args = _batch_sharded_program(fr, pairs, "reach", group=group,
                                       placement=placement, device=device,
                                       chaos=chaos)
    if chaos is not None:
        chaos.maybe_fail("engine.shard_map", pairs=pairs)
    ans = run(*args).cpu().numpy().copy()
    ans[pairs[:, 0] == pairs[:, 1]] = True
    return ans


def dis_dist_batch_sharded(fr: Fragmentation, pairs, group=None,
                           placement: Optional[Placement] = None,
                           device=None, chaos=None) -> np.ndarray:
    """Tropical twin of :func:`dis_reach_batch_sharded`: N shortest
    distances with ONE int32 MIN collective.  Returns [N] int64 with -1
    for unreachable, like ``cache.dis_dist_batch``; ``chaos`` as there."""
    pairs = _as_batch_pairs(pairs)
    if len(pairs) == 0:
        return np.zeros(0, dtype=np.int64)
    run, args = _batch_sharded_program(fr, pairs, "dist", group=group,
                                       placement=placement, device=device,
                                       chaos=chaos)
    if chaos is not None:
        chaos.maybe_fail("engine.shard_map", pairs=pairs)
    d = run(*args).cpu().numpy().astype(np.int64)
    d[d >= INF] = -1
    return d


def dis_rpq_batch_sharded(fr: Fragmentation, pairs, qa: QueryAutomaton,
                          group=None, placement: Optional[Placement] = None,
                          device=None, chaos=None) -> np.ndarray:
    """Product-automaton twin of :func:`dis_reach_batch_sharded` for one
    automaton: each rank ships its owned fragments' product rvset rows and
    its pairs' forward / reverse product propagations in ONE bitpacked
    SUM; the (nb|Q|)^2 closure and the combine run replicated.  Returns
    [N] bool (s == t answered by nullability, like
    ``cache.dis_rpq_batch``); ``chaos`` as in the reach twin."""
    pairs = _as_batch_pairs(pairs)
    if len(pairs) == 0:
        return np.zeros(0, dtype=bool)
    run, args = _batch_sharded_program(fr, pairs, "rpq", qa=qa, group=group,
                                       placement=placement, device=device,
                                       chaos=chaos)
    if chaos is not None:
        chaos.maybe_fail("engine.shard_map", pairs=pairs)
    ans = run(*args).cpu().numpy().copy()
    ans[pairs[:, 0] == pairs[:, 1]] = bool(qa.nullable)
    return ans


# ---------------------------------------------------------------------------
# single-query one-shot algorithms: local stage -> ONE collective ->
# replicated evalDG
# ---------------------------------------------------------------------------

def _one_shot_inputs(fr: Fragmentation, s: int, t: int, group,
                     placement: Optional[Placement], device):
    """This rank's packed fragment arrays and its [fpd] slots of s and t."""
    from .session import _resolve_device          # session imports us
    device = _resolve_device(device)
    placement = _resolve_placement(fr, group, placement)
    inp = _device_inputs(fr, placement, dist.get_rank(group), device)
    perm, rows = inp["perm"], inp["rows"]
    qs = query_slots(fr, s, t)
    s_local, t_local = (
        torch.tensor(_pack_rows(qs[name], perm, fr.n_max)[rows],
                     device=device) for name in ("s_local", "t_local"))
    return inp["arrs"], s_local, t_local, device


def _merge_boolean(D: torch.Tensor, group) -> torch.Tensor:
    """The ONE collective: every rank's row-disjoint Boolean matrix,
    bitpacked and merged with SUM (== OR, see the module docstring).  The
    merged matrix comes back in zero-padded storage, rows 16 bytes apart,
    as evalDG's fixpoint reads it."""
    words = pack_payload(D)
    merged = _all_reduce(words, dist.ReduceOp.SUM, group)
    return unpack_payload(merged, D.shape[1],
                          out=padded_zeros(*D.shape, D.device))


def dis_reach_sharded(fr: Fragmentation, s: int, t: int, group=None,
                      placement: Optional[Placement] = None, device=None):
    """disReach over the process group (paper Fig. 3); returns ``(answer,
    D)`` with D the assembled [B, B] dependency matrix as a numpy array,
    the same on every rank (``None`` for s == t: nothing is evaluated).

    Each rank runs localEval on its owned fragments (all at once) and
    writes their row blocks into one [B, B] buffer; ONE bitpacked SUM
    merges the ranks' buffers, ``traffic_bits("reach")`` bits; evalDG runs
    replicated through the or-and kernel."""
    if s == t:
        return True, None
    arrs, s_local, t_local, dev = _one_shot_inputs(fr, s, t, group,
                                                   placement, device)
    rows, block = engine.local_eval_reach(
        arrs["esrc"], arrs["edst"], arrs["src_local"], arrs["src_row"],
        arrs["tgt_local"], s_local, t_local, n_max=fr.n_max, B=fr.B)
    D = padded_zeros(fr.B, fr.B, dev)
    D[rows] = block
    del block
    D = _merge_boolean(D, group)
    from .session import _src_rows, _tgt_cols     # session imports us
    ans = engine.evaldg_reach(D, _src_rows(fr, dev), _tgt_cols(fr, t, dev))
    return ans, D.cpu().numpy()


def dis_rpq_sharded(fr: Fragmentation, s: int, t: int, qa: QueryAutomaton,
                    group=None, placement: Optional[Placement] = None,
                    device=None) -> bool:
    """disRPQ over the process group (paper Sec. 5); returns the answer
    (the nullability of the automaton for s == t).  Each rank assembles
    its owned fragments' product rvset rows into one [(B*Q), (B*Q)]
    buffer, one fragment at a time; ONE bitpacked SUM merges them,
    ``traffic_bits("rpq", states=Q)`` bits; evalDG_r runs replicated."""
    if s == t:
        return bool(qa.nullable)
    Q = qa.n_states
    arrs, s_local, t_local, dev = _one_shot_inputs(fr, s, t, group,
                                                   placement, device)
    D = engine.regular_rvset(
        arrs["esrc"], arrs["edst"], arrs["src_local"], arrs["src_row"],
        arrs["tgt_local"], arrs["labels"], arrs["gids"],
        torch.tensor(qa.state_labels, device=dev),
        torch.tensor(qa.trans, device=dev), s_local, t_local, s, t,
        n_max=fr.n_max, B=fr.B, side=fr.B * Q)
    D = _merge_boolean(D, group)
    from .session import _src_rows, _tgt_cols     # session imports us
    return engine.evaldg_reach(D, _src_rows(fr, dev, Q, qa.start),
                               _tgt_cols(fr, t, dev, Q, qa.final))


# ---------------------------------------------------------------------------
# one program run under a record (the reference lowers the same programs)
# ---------------------------------------------------------------------------

def trace_reach_collectives(fr: Fragmentation, s: int, t: int, group=None,
                            placement: Optional[Placement] = None,
                            device=None) -> CollectiveRecord:
    """Run the sharded one-shot disReach (:func:`dis_reach_sharded`) once
    and return its :class:`CollectiveRecord`: the counterpart of the
    reference's ``lower_reach_hlo``.  Every rank of the group calls it."""
    with record_collectives() as rec:
        dis_reach_sharded(fr, s, t, group=group, placement=placement,
                          device=device)
    return rec


def trace_batch_collectives(fr: Fragmentation, pairs, kind: str,
                            qa: Optional[QueryAutomaton] = None, group=None,
                            placement: Optional[Placement] = None,
                            device=None) -> CollectiveRecord:
    """Run one fused sharded batch of ``kind`` ("reach", "dist" or "rpq")
    over ``pairs`` and return its record: the counterpart of the
    reference's ``lower_batch_hlo``."""
    run, args = _batch_sharded_program(fr, _as_batch_pairs(pairs), kind,
                                       qa=qa, group=group,
                                       placement=placement, device=device)
    with record_collectives() as rec:
        run(*args)
    return rec


def trace_update_collectives(fr: Fragmentation, row_ids: np.ndarray,
                             group=None,
                             placement: Optional[Placement] = None
                             ) -> CollectiveRecord:
    """Run the sharded cache-update program (:func:`update_rows_sharded`)
    for the boundary rows ``row_ids`` against ``fr``'s current reach cache
    and return its record: the counterpart of the reference's
    ``lower_update_hlo``.  Nothing is bound: the cache is left as it
    was."""
    with record_collectives() as rec:
        update_rows_sharded(fr, row_ids, group=group, placement=placement)
    return rec


# ---------------------------------------------------------------------------
# sharded incremental cache maintenance
# ---------------------------------------------------------------------------

def _changed_row_inputs(fr: Fragmentation, row_ids: np.ndarray):
    """Per-fragment gather indices for the changed boundary rows: for each
    fragment, the source-row index of every changed position it owns (pad
    ``s_max-1``, the reserved s slot, never a real in-node row, elsewhere)
    plus the ownership mask.  [k, r] each."""
    k, S, r = fr.k, fr.s_max, len(row_ids)
    src_row = fr.arrays["src_row"]                         # [k, S]
    f_of, j_of = np.nonzero(src_row < fr.B - 2)
    frag = np.full(fr.B, -1, dtype=np.int64)               # row -> owner
    slot = np.zeros(fr.B, dtype=np.int32)                  # row -> source
    frag[src_row[f_of, j_of]] = f_of
    slot[src_row[f_of, j_of]] = j_of
    f = frag[row_ids]
    if (f < 0).any():
        raise KeyError(f"boundary rows {row_ids[f < 0]} have no owner")
    srcidx = np.full((k, r), S - 1, dtype=np.int32)
    own = np.zeros((k, r), dtype=bool)
    srcidx[f, np.arange(r)] = slot[row_ids]
    own[f, np.arange(r)] = True
    return srcidx, own


def _update_rows_program(fr: Fragmentation, cache, row_ids: np.ndarray,
                         placement: Placement, rank: int, group):
    """This rank's part of the sharded update, and the ONE collective.

    The rank resumes, from the cached frontier rows (``cache.bl_frontier``,
    a valid start after insertions), the all-sources fixpoints of the
    fragments that own a changed row and that it owns itself, then
    writes, for each changed position it owns, the row's D0 entries and
    its resumed frontier row into one payload, both bitpacked:
    ``[r, ceil(nb/32) + ceil((n_max+1)/32)]`` int32 words, zero elsewhere.
    A SUM merges the ranks' payloads exactly (every row is owned by one
    rank).  Returns the merged ``(rows [r, nb], fronts [r, n_max+1])``
    bool, the same on every rank."""
    from . import incremental                      # incremental imports cache
    dev, nb, n_max = cache.device, fr.n_boundary, fr.n_max
    r = len(row_ids)
    srcidx, own = _changed_row_inputs(fr, row_ids)
    mine = np.asarray(placement.device_of) == rank            # [k]
    own &= mine[:, None]
    frags = np.nonzero(own.any(1))[0]
    rows = torch.zeros((r, nb), dtype=torch.bool, device=dev)
    fronts = torch.zeros((r, n_max + 1), dtype=torch.bool, device=dev)
    if frags.size:
        esrc = _cache._upload(fr.arrays["esrc"][frags], dev)
        edst = _cache._upload(fr.arrays["edst"][frags], dev)
        init, _, _ = incremental._frontier_init(fr, frags, cache.bl_frontier,
                                                False, dev)
        front = engine.resume_frontier_reach(esrc, edst, init, n_max=n_max)
        t = lambda x: torch.tensor(x, dtype=torch.long, device=dev)
        # row reads go by fragment, each through that fragment's [nb] stub
        # columns, so no [r, nb] index is built
        for i, f in enumerate(frags):
            pos = np.nonzero(own[f])[0]
            picked = front[i, t(srcidx[f, pos])]               # [m, n+1]
            rows[t(pos)] = picked[:, t(fr.arrays["tgt_local"][f, :nb])]
            fronts[t(pos)] = picked
    w_rows = (nb + 31) // 32
    words = torch.cat([pack_payload(rows), pack_payload(fronts)], dim=1)
    del rows, fronts
    merged = _all_reduce(words, dist.ReduceOp.SUM, group)
    return (unpack_payload(merged[:, :w_rows], nb),
            unpack_payload(merged[:, w_rows:], n_max + 1))


def update_rows_sharded(fr: Fragmentation, row_ids: np.ndarray, group=None,
                        placement: Optional[Placement] = None):
    """Recompute the changed D0 rows ``row_ids`` over the process group,
    against ``fr``'s attached reach cache (which it does not change).

    Each rank resumes the fixpoints of the fragments it owns that own a
    changed row; the ONE collective ships the changed rows only, each its
    D0 row and its resumed frontier row bitpacked:
    ``fr.traffic_bits_update(len(row_ids))`` bits.  The frontier rows are
    what the reference gathers from the devices to the host uncounted; on
    the ranks they ride the same collective, so every rank's
    ``bl_frontier`` stays exact.

    Returns ``(rows, fronts)``: the merged [r, nb] D0 rows and [r,
    n_max+1] frontier rows, the same on every rank."""
    placement = _resolve_placement(fr, group, placement)
    return _update_rows_program(fr, fr.rvset_cache, row_ids, placement,
                                dist.get_rank(group), group)


def apply_delta_sharded(fr: Fragmentation, delta, group=None,
                        placement: Optional[Placement] = None, device=None,
                        chaos=None):
    """Sharded twin of :func:`repro_torch.core.incremental.apply_delta`
    for insert-only deltas against a reach cache: the dirty fragments'
    frontier resumes run on the ranks that own them, the update collective
    ships only the changed rows (:func:`update_rows_sharded`), and the
    rank-style closure update runs replicated (B1: ``T``, the r x r
    closure, ``left`` and ``P`` with ``P^T``).  Every rank of the group
    calls it with the same delta and ends with the same cache.

    The host path (``incremental.apply_delta``) takes, as in the reference
    package: the empty delta, deletions and a cache that holds distances;
    a delta that needs a rebuild rebuilds; a delta whose dirty fragments
    own no boundary row refreshes their frontiers on every rank, with no
    collective.  With no cache attached, one is built on ``device``
    (``None``: the CUDA device) first, as the reference does.  The
    ``delta.repair`` fault site fires after the host arrays mutate;
    rollback is the caller's job (``QuerySession.apply``)."""
    from . import incremental
    from .session import _resolve_device          # session imports us
    cache = fr.rvset_cache
    if cache is None:
        cache = _cache.prepare_rvset_cache(fr, _resolve_device(device))
    if delta.is_empty() or delta.n_del or cache.bl_dist is not None:
        return incremental.apply_delta(fr, delta, chaos=chaos)
    placement = _resolve_placement(fr, group, placement)
    report = fr.apply_delta(delta)
    if chaos is not None:
        chaos.maybe_fail("delta.repair")
    if report.rebuilt:
        return incremental.rebuild_cache(fr, cache.version, report,
                                         with_dist=False, device=cache.device,
                                         reason=report.reason)
    base = incremental._stats_base(report)
    row_ids = incremental.changed_row_ids(fr, report.dirty)
    if row_ids.size == 0:      # the dirty fragments own no boundary rows
        incremental._update_frontiers(cache, report.dirty, warm=True)
        cache.refresh_device_arrays(incremental.touched_arrays(report))
        return incremental.UpdateStats(mode="repair_sharded", **base)
    padded = incremental.pad_row_ids(row_ids, cap=fr.n_boundary)
    rows_new, fronts = _update_rows_program(fr, cache, padded, placement,
                                            dist.get_rank(group), group)
    idx = torch.tensor(row_ids, dtype=torch.long, device=cache.device)
    cache.bl_frontier = cache.bl_frontier.index_put(
        (idx,), fronts[:row_ids.size])
    cache.closure, cache.closure_t = incremental._rank_update_bool(
        cache.closure, cache.closure_t, rows_new, padded)
    cache.refresh_device_arrays(incremental.touched_arrays(report))
    return incremental.UpdateStats(mode="repair_sharded",
                                   changed_rows=int(row_ids.size), **base)
