"""QuerySession: one handle over a fragmentation for all three query
classes.

``repro_torch.connect(fr)`` opens a session that owns the amortized caches
(rvset / tropical / per-automaton product closures, attached to the
Fragmentation so every session on it shares one copy) on one device.
``session.run([...])`` takes a heterogeneous batch of
:mod:`repro_torch.core.plan` IR values, groups it by (kind, automaton)
through the planner, and serves every group with ONE batched execution —
reach and dist through the or-and and min-plus kernels, RPQs through the
product closure — returning :class:`~repro_torch.core.plan.QueryResult`\\ s
in submission order.

The session runs on the CUDA device unless the caller passes
``device="cpu"``; it never falls back to the CPU on its own.

``backend="shard_map"`` runs every group through the sharded engines of
:mod:`repro_torch.core.distributed` instead: the fragments are packed onto
the ranks of an initialized torch.distributed process group (one rank per
device; ``d = 1`` with every fragment on one card), with ONE collective per
fused group.

``cache="none"`` runs the paper's one-shot algorithms instead, one query
at a time (:func:`exec_reach`, :func:`exec_dist`, :func:`exec_rpq`:
localEval on every fragment, one assembly of the dependency matrix, then
evalDG), and leaves no state behind.  ``session.apply(delta)`` changes the
graph and repairs the caches (:mod:`repro_torch.core.incremental`), or
rolls both back when it fails; :meth:`QuerySession.repair_on` and
``run(version=)`` are the same two steps on a copy-on-write MVCC version
(:mod:`repro_torch.core.versions`).  The ``core.api`` shims run on per-
fragmentation default sessions (:func:`default_session`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from . import cache as _cache
from . import distributed, engine, incremental
from ..errors import DeltaApplyFailed, NoCudaDevice, Status, is_device_fault
from ..kernels.bool_matmul.ops import padded_zeros
from ..kernels.tropical_matmul.ops import padded_i32
from .automaton import QueryAutomaton, build_query_automaton
from .engine import INF, QueryStats
from .fragments import Fragmentation, GraphDelta, Placement, query_slots
from .plan import (Dist, ExecutionGroup, Query, QueryPlan, QueryResult,
                   Reach, Rpq, plan_queries)

BACKENDS = ("auto", "vmap", "shard_map")
CACHE_MODES = ("amortized", "none")


@dataclasses.dataclass
class SessionStats:
    """Work accounting across the session's lifetime."""

    queries: int = 0         # queries answered
    batches: int = 0         # run() calls
    executions: int = 0      # executions issued (one per group, or one
                             # per query with cache="none")
    updates: int = 0         # deltas applied (or attempted)
    degraded_groups: int = 0  # sharded groups served by the cached path
    rollbacks: int = 0       # failed deltas rolled back to their snapshot


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDevice()
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice()
    return device


def connect(fr: Fragmentation, backend: str = "auto",
            cache: str = "amortized", group=None,
            placement: Optional[Placement] = None,
            device=None, chaos=None) -> "QuerySession":
    """Open a :class:`QuerySession` over ``fr`` — the front door of the
    package (also exported as ``repro_torch.connect``).

    ``backend``:

    * ``"vmap"`` runs every fragment's local stage as one batched program
      on one device, against the amortized caches;
    * ``"shard_map"`` packs the fragments onto the ranks of the
      torch.distributed process group ``group`` (``None``: the default
      group, which the caller must have initialized) according to
      ``placement`` and ships ONE collective per fused group, for all
      three query classes.  Groups of at most ``fr.k`` ranks are valid;
      every rank runs the same batches and gets the same answers;
    * ``"auto"`` picks shard_map when ``fr.k > 1`` and the group (or the
      placement) has ``1 < d <= fr.k`` ranks, and vmap otherwise.

    ``placement`` maps fragment -> rank (see
    :class:`~repro_torch.core.fragments.Placement`); by default
    ``Placement.balanced`` over the group's ranks.  ``cache``:
    ``"amortized"`` serves vmap batches from the rvset/product caches
    (built lazily, shared with every other session on the same
    fragmentation); ``"none"`` answers each query with the paper's
    one-shot algorithm on ``device`` and builds no cache, whatever the
    backend.  ``device``: where the caches live and the kernels run;
    ``None`` means the current CUDA device, and raises
    :class:`~repro_torch.errors.NoCudaDevice` when there is none.

    ``chaos``: an optional fault injector
    (:class:`repro_torch.serve.faults.FaultInjector`, or any object with a
    ``maybe_fail(site, pairs=None)`` method), consulted at the four sites of
    the reference package: ``"delta.repair"`` after a delta has mutated the
    host arrays, ``"engine.vmap"`` before every one-device group,
    ``"upload"`` and ``"engine.shard_map"`` before every sharded group.
    Tests and chip runs drive the rollback, retry and degrade paths with
    it.  ``None`` costs nothing.
    """
    return QuerySession(fr, backend=backend, cache=cache, group=group,
                        placement=placement, device=device, chaos=chaos)


class QuerySession:
    """Unified query interface over one fragmentation (see :func:`connect`)."""

    def __init__(self, fr: Fragmentation, backend: str = "auto",
                 cache: str = "amortized", group=None,
                 placement: Optional[Placement] = None, device=None,
                 chaos=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        if cache not in CACHE_MODES:
            raise ValueError(f"unknown cache mode {cache!r}; expected one "
                             f"of {CACHE_MODES}")
        if placement is not None and placement.k != fr.k:
            raise ValueError(f"placement maps {placement.k} fragments but "
                             f"the fragmentation has {fr.k}")
        # d: the ranks the sharded backend would run on.  An explicit
        # placement pins it; otherwise the process group's size, and 1
        # when there is no group.  shard_map fits iff d <= fr.k: a
        # fragment is never split across ranks.
        if placement is not None:
            d, have = placement.d, f"a {placement.d}-rank placement"
        elif dist.is_available() and dist.is_initialized():
            d = dist.get_world_size(group)
            have = f"a {d}-rank process group"
        else:
            d, have = 1, "no process group"
        fits = 1 <= d <= fr.k
        if backend == "auto":
            backend = "shard_map" if fr.k > 1 and d > 1 and fits else "vmap"
        elif backend == "shard_map" and not fits:
            raise ValueError(
                f"backend='shard_map' packs fragments onto at most one rank "
                f"each ({fr.k} fragments), cannot use {have}; use a process "
                f"group with <= {fr.k} ranks, or backend='auto' to run vmap")
        if backend == "shard_map":
            placement = distributed._resolve_placement(fr, group, placement)
        self.fr = fr
        self.cache_mode = cache
        self.backend = backend
        self.group = group
        self.placement = placement
        self.device = _resolve_device(device)
        self.chaos = chaos
        self.stats = SessionStats()
        self.last_plan: Optional[QueryPlan] = None
        self._regex_cache: Dict[str, QueryAutomaton] = {}
        # serializes group execution and delta application so several
        # threads can share one session over the same caches; an RLock
        # because run() resolves automatons (also locked) inline
        self._lock = threading.RLock()

    # -- cache lifecycle ---------------------------------------------------

    def warm(self, with_dist: bool = False) -> "QuerySession":
        """Eagerly build the amortized caches (no-op for cache='none')."""
        with self._lock:
            if self.cache_mode == "amortized":
                _cache.prepare_rvset_cache(self.fr, self.device,
                                           with_dist=with_dist)
        return self

    @property
    def cache_version(self) -> Optional[int]:
        """Snapshot id of the attached rvset cache (None before the first
        build); bumped by every delta repair."""
        c = self.fr.rvset_cache
        return None if c is None else c.version

    # -- dynamic graphs ----------------------------------------------------

    def apply(self, delta: GraphDelta) -> incremental.UpdateStats:
        """Apply a :class:`GraphDelta` and repair the fragmentation's caches
        in place (:func:`repro_torch.core.incremental.apply_delta`, on the
        cache's device).  Queries run after this see the new graph, and
        ``cache_version`` is bumped.

        On ``backend="shard_map"`` with a cache attached, every rank of
        the group calls this with the same delta, and the repair runs
        sharded (:func:`repro_torch.core.distributed.apply_delta_sharded`):
        each rank resumes the dirty fragments it owns, and ONE collective
        ships only the changed rows.  Deletions, a distance cache and the
        other cases the reference keeps on the host take the host repair
        on every rank.

        A delta that fails mid-apply (bad input, a kernel failure, an
        injected fault) is rolled back: the fragmentation and its caches
        return to the pre-delta snapshot (``arrays_version`` and
        ``cache_version`` unchanged, later queries answer on the pre-delta
        graph), ``stats.rollbacks`` counts it, and a typed
        :class:`~repro_torch.errors.DeltaApplyFailed` wrapping the cause
        is raised."""
        with self._lock:
            self.stats.updates += 1
            snap = self.fr.snapshot()
            try:
                return self._apply_delta(self.fr, delta)
            except Exception as exc:
                self.fr.restore(snap)
                self.stats.rollbacks += 1
                raise DeltaApplyFailed(exc) from exc

    def repair_on(self, fr: Fragmentation,
                  delta: GraphDelta) -> incremental.UpdateStats:
        """Repair ``fr``'s caches for ``delta``: the MVCC building block
        (:mod:`repro_torch.core.versions`).  Unlike :meth:`apply` this
        neither takes the session lock nor snapshots: ``fr`` is a private
        copy-on-write clone that no reader sees, so the repair runs while
        queries run against the head version, and a failed repair is
        handled by dropping the clone.  On ``backend="shard_map"`` it
        routes as :meth:`apply` does."""
        self.stats.updates += 1
        return self._apply_delta(fr, delta)

    def _apply_delta(self, fr: Fragmentation,
                     delta: GraphDelta) -> incremental.UpdateStats:
        if self.backend == "shard_map" and fr.rvset_cache is not None:
            return distributed.apply_delta_sharded(
                fr, delta, group=self.group, placement=self.placement,
                chaos=self.chaos)
        return incremental.apply_delta(fr, delta, chaos=self.chaos)

    # -- query execution ---------------------------------------------------

    def run(self, queries: Union[Query, Sequence[Query]],
            version=None) -> List[QueryResult]:
        """Answer a heterogeneous batch; results in submission order.

        The batch is grouped by (kind, automaton) and each group is served
        by one batched execution (``cache='amortized'``) or by one one-shot
        evaluation per query (``cache='none'``).  Every result is stamped
        with the cache snapshot it was computed against (``None`` for
        uncached execution).

        ``version``: an optional pinned MVCC
        :class:`~repro_torch.core.versions.Version`; the batch then runs
        against that snapshot's fragmentation and cache instead of
        ``self.fr``, and its results carry *its* ``cache_version``.  This
        is how the serving engine answers while the next version repairs.

        Thread-safe: the whole batch runs under the session lock, so a
        concurrent :meth:`apply` never moves the snapshot between a group
        and its stamp.  An MVCC repair holds the lock only while it clones
        the head (:meth:`repair_on` runs without it).
        """
        if isinstance(queries, (Reach, Dist, Rpq)):
            queries = [queries]
        queries = list(queries)
        fr = self.fr if version is None else version.fr
        with self._lock:
            plan = plan_queries(queries, self._resolve_automaton)
            self.last_plan = plan
            results: List[Optional[QueryResult]] = [None] * len(queries)
            for group in plan.groups:
                if self.cache_mode == "amortized":
                    self._run_group_cached(fr, group, results)
                else:
                    self._run_group_uncached(fr, group, results)
            # uncached execution never consults the cache: stamp None even
            # if a cache happens to exist on the shared fragmentation
            c = fr.rvset_cache
            stamp = (None if c is None or self.cache_mode != "amortized"
                     else c.version)
        for r in results:
            r.cache_version = stamp
            r.status = Status.DONE
        self.stats.queries += len(queries)
        self.stats.batches += 1
        return results  # type: ignore[return-value]

    # convenience single-query sugar (examples / interactive use)
    def reach(self, s: int, t: int) -> bool:
        return self.run(Reach(int(s), int(t)))[0].answer

    def dist(self, s: int, t: int,
             bound: Optional[int] = None) -> QueryResult:
        return self.run(Dist(int(s), int(t), bound=bound))[0]

    def rpq(self, s: int, t: int, regex: Optional[str] = None,
            automaton: Optional[QueryAutomaton] = None) -> bool:
        return self.run(Rpq(int(s), int(t), regex=regex,
                            automaton=automaton))[0].answer

    # -- internals ---------------------------------------------------------

    def _resolve_automaton(self, q: Rpq) -> QueryAutomaton:
        if q.automaton is not None:
            return q.automaton
        with self._lock:
            qa = self._regex_cache.get(q.regex)
            if qa is None:
                g = self.fr.g
                label_of = (g.label_of if g.label_names is not None
                            else (lambda name: int(name)))
                qa = build_query_automaton(q.regex, label_of)
                self._regex_cache[q.regex] = qa
            return qa

    def _run_group_cached(self, fr: Fragmentation, group: ExecutionGroup,
                          results) -> None:
        """One batched execution for the whole group (padded to the
        group's bucket size; pad answers are discarded)."""
        stats = self._group_stats(fr, group)
        ans, degraded = self._execute_group(fr, group.kind, group.pairs(),
                                            group.automaton)
        if group.kind == "reach":
            for i, q, a, st in zip(group.indices, group.queries, ans, stats):
                results[i] = self._reach_result(q, a, st)
        elif group.kind == "dist":
            # exact distances once; each query's bound applies at answer
            # extraction (this is what lets bounded + exact queries fuse)
            for i, q, di, st in zip(group.indices, group.queries, ans, stats):
                results[i] = self._dist_result(q, int(di), st)
        else:                                   # rpq
            for i, q, a, st in zip(group.indices, group.queries, ans, stats):
                results[i] = self._rpq_result(q, group.automaton, a, st)
        if degraded:
            for i in group.indices:
                results[i].degraded = True
        self.stats.executions += 1

    def _execute_group(self, fr: Fragmentation, kind: str, pairs, qa):
        """One batched engine execution; returns ``(answers, degraded)``.

        On the shard_map backend every kind routes through its
        one-collective sharded batch engine, so the paper's guarantees
        survive fusion for all three query classes.  A failure there
        degrades instead of failing the group: the same batch runs again
        on the cached one-device path, on this session's device and
        through the same kernels, from the fragmentation's rvset cache
        (built on first use, kept repaired by every delta).  The answers
        stay exact and are flagged ``degraded``.  A fault of the device or
        a kernel (:func:`~repro_torch.errors.is_device_fault`) does not
        degrade: it raises."""
        if self.backend == "shard_map":
            where = dict(group=self.group, placement=self.placement,
                         device=self.device, chaos=self.chaos)
            try:
                if kind == "reach":
                    return distributed.dis_reach_batch_sharded(
                        fr, pairs, **where), False
                if kind == "dist":
                    return distributed.dis_dist_batch_sharded(
                        fr, pairs, **where), False
                return distributed.dis_rpq_batch_sharded(
                    fr, pairs, qa, **where), False
            except Exception as exc:
                if is_device_fault(exc):
                    raise
                self.stats.degraded_groups += 1
                return self._execute_group_vmap(fr, kind, pairs, qa), True
        return self._execute_group_vmap(fr, kind, pairs, qa), False

    def _execute_group_vmap(self, fr: Fragmentation, kind: str, pairs, qa):
        if self.chaos is not None:
            self.chaos.maybe_fail("engine.vmap", pairs=pairs)
        if kind == "reach":
            return _cache.dis_reach_batch(fr, pairs, self.device)
        if kind == "dist":
            return _cache.dis_dist_batch(fr, pairs, self.device)
        return _cache.dis_rpq_batch(fr, pairs, qa, self.device)

    def _run_group_uncached(self, fr: Fragmentation, group: ExecutionGroup,
                            results) -> None:
        """The one-shot engine, one evaluation per query (cache='none')."""
        dev = self.device
        for i, q in zip(group.indices, group.queries):
            if group.kind == "reach":
                results[i] = exec_reach(fr, q.s, q.t,
                                        return_matrix=q.return_matrix,
                                        device=dev)
            elif group.kind == "dist":
                results[i] = exec_dist(fr, q.s, q.t, bound=q.bound,
                                       device=dev)
            else:
                results[i] = exec_rpq(fr, q.s, q.t, group.automaton,
                                      return_matrix=q.return_matrix,
                                      device=dev)
            self.stats.executions += 1

    def _group_stats(self, fr: Fragmentation,
                     group: ExecutionGroup) -> List[QueryStats]:
        """Per-query stats whose SUM over the group is exact: a fused group
        ships ONE collective of ``traffic_bits(kind, states, batch=padded)``
        bits total, amortized across the group's queries with an integer
        fair split; the single collective round is stamped on the first
        query."""
        states = 1 if group.automaton is None else group.automaton.n_states
        total = fr.traffic_bits(group.kind, states=states,
                                batch=group.padded_size)
        n = group.n
        return [QueryStats(total * (i + 1) // n - total * i // n,
                           1 if i == 0 else 0, fr.B, states)
                for i in range(n)]

    def _reach_result(self, q: Reach, ans, stats: QueryStats) -> QueryResult:
        if q.s == q.t:
            return QueryResult(True, 0, stats)
        return QueryResult(bool(ans), None, stats)

    def _dist_result(self, q: Dist, d: int, stats: QueryStats) -> QueryResult:
        if q.s == q.t:
            ok = q.bound is None or 0 <= q.bound
            return QueryResult(ok, 0, stats)
        dist: Optional[int] = None if d < 0 else d
        reachable = dist is not None
        answer = (reachable if q.bound is None
                  else (reachable and dist <= q.bound))
        # a failed bounded query reports no distance
        if q.bound is not None and not answer:
            dist = None
        return QueryResult(answer, dist, stats)

    def _rpq_result(self, q: Rpq, qa: QueryAutomaton, ans,
                    stats: QueryStats) -> QueryResult:
        if q.s == q.t:
            return QueryResult(bool(qa.nullable), 0, stats)
        return QueryResult(bool(ans), None, stats)


# ---------------------------------------------------------------------------
# per-fragmentation default sessions (what the core.api shims delegate to)
# ---------------------------------------------------------------------------

def default_session(fr: Fragmentation, cache: str = "amortized",
                    device=None) -> QuerySession:
    """Memoized vmap-backend session attached to ``fr``, one per cache mode
    and device (``None``: the current CUDA device, raising
    :class:`~repro_torch.errors.NoCudaDevice` without one).  Cache state
    lives on the fragmentation itself, so default sessions and explicitly
    connected ones share it."""
    dev = _resolve_device(device)
    key = f"_default_session_{cache}_{dev}"
    sess = fr.__dict__.get(key)
    if sess is None:
        sess = QuerySession(fr, backend="vmap", cache=cache, device=dev)
        fr.__dict__[key] = sess
    return sess


# ---------------------------------------------------------------------------
# the one-shot engine (paper Figs. 3-7): full localEval + evalDG per query
# ---------------------------------------------------------------------------
#
# Answer extraction (coordinator side):
#   * source row  = reserved row B-2 (s), in automaton state u_s for RPQs;
#   * target cols = reserved col B-1 (t reached inside t's fragment) plus
#     the column b_index[t] when t is itself a boundary in-node (t reached
#     through a cross edge that lands on it).

def _tgt_cols(fr: Fragmentation, t: int, device, states: int = 1,
              final: int = 0) -> torch.Tensor:
    cols = np.zeros(fr.B * states, dtype=bool)
    cols[fr.T_COL * states + final] = True
    bt = int(fr.b_index[t])
    if bt >= 0:
        cols[bt * states + final] = True
    return torch.tensor(cols, device=device)


def _src_rows(fr: Fragmentation, device, states: int = 1,
              start: int = 0) -> torch.Tensor:
    rows = np.zeros(fr.B * states, dtype=bool)
    rows[fr.S_ROW * states + start] = True
    return torch.tensor(rows, device=device)


def _query_inputs(fr: Fragmentation, s: int, t: int, device):
    """The fragment arrays (copied onto ``device``, never aliasing the host
    buffers that ``apply_delta`` mutates) and the [k] slots of s and t."""
    arrs = _cache._upload_arrays(fr, device)
    qs = query_slots(fr, s, t)
    return (arrs, _cache._upload(qs["s_local"], device),
            _cache._upload(qs["t_local"], device))


def exec_reach(fr: Fragmentation, s: int, t: int,
               return_matrix: bool = False, device=None) -> QueryResult:
    """disReach (paper Fig. 3): localEval on every fragment, one assembly
    of the dependency matrix D [B, B] (each fragment's row block written
    into one buffer), then evalDG through the or-and kernel."""
    if s == t:
        return QueryResult(True, 0, QueryStats(0, 0, fr.B, 1))
    dev = _resolve_device(device)
    arrs, s_local, t_local = _query_inputs(fr, s, t, dev)
    rows, block = engine.local_eval_reach(
        arrs["esrc"], arrs["edst"], arrs["src_local"], arrs["src_row"],
        arrs["tgt_local"], s_local, t_local, n_max=fr.n_max, B=fr.B)
    D = padded_zeros(fr.B, fr.B, dev)       # as evalDG's fixpoint reads
    D[rows] = block
    del block
    ans = engine.evaldg_reach(D, _src_rows(fr, dev), _tgt_cols(fr, t, dev))
    stats = QueryStats(payload_bits=fr.traffic_bits("reach"),
                       collective_rounds=1, boundary=fr.B, states=1)
    return QueryResult(ans, None, stats,
                       D.cpu().numpy() if return_matrix else None)


def exec_dist(fr: Fragmentation, s: int, t: int,
              bound: Optional[int] = None, device=None) -> QueryResult:
    """disDist (paper Sec. 4): bounded reachability q_br(s, t, l), with the
    local propagations capped at the bound; with ``bound=None`` the exact
    dist(s, t) (unreachable: distance None).  evalDG runs through the
    min-plus kernel."""
    if s == t:
        ok = bound is None or 0 <= bound
        return QueryResult(ok, 0, QueryStats(0, 0, fr.B, 1))
    cap = INF if bound is None else int(bound)
    dev = _resolve_device(device)
    arrs, s_local, t_local = _query_inputs(fr, s, t, dev)
    rows, block = engine.local_eval_dist(
        arrs["esrc"], arrs["edst"], arrs["src_local"], arrs["src_row"],
        arrs["tgt_local"], s_local, t_local, cap, n_max=fr.n_max, B=fr.B)
    # padded storage (rows 16 bytes apart): evalDG's fixpoint reads W as
    # it is, without a copy
    W = padded_i32(fr.B, fr.B, dev).fill_(INF)
    W[rows] = block
    del block
    d = engine.evaldg_dist(W, _src_rows(fr, dev), _tgt_cols(fr, t, dev))
    reachable = d < INF
    answer = reachable if bound is None else (reachable and d <= bound)
    stats = QueryStats(payload_bits=fr.traffic_bits("dist"),
                       collective_rounds=1, boundary=fr.B, states=1)
    # a failed bounded query reports no distance: with the propagation
    # capped at the bound, d is not the true distance past it
    return QueryResult(answer, d if (reachable and answer) else None, stats)


def exec_rpq(fr: Fragmentation, s: int, t: int, qa: QueryAutomaton,
             return_matrix: bool = False, device=None) -> QueryResult:
    """disRPQ (paper Sec. 5): product-automaton localEval_r, assembled one
    fragment at a time into D [(B*Q), (B*Q)], then evalDG_r through the
    or-and kernel."""
    Q = qa.n_states
    if s == t:
        return QueryResult(bool(qa.nullable), 0,
                           QueryStats(0, 0, fr.B, Q))
    dev = _resolve_device(device)
    arrs, s_local, t_local = _query_inputs(fr, s, t, dev)
    D = engine.regular_rvset(
        arrs["esrc"], arrs["edst"], arrs["src_local"], arrs["src_row"],
        arrs["tgt_local"], arrs["labels"], arrs["gids"],
        _cache._upload(qa.state_labels, dev), _cache._upload(qa.trans, dev),
        s_local, t_local, s, t, n_max=fr.n_max, B=fr.B, side=fr.B * Q)
    ans = engine.evaldg_reach(D, _src_rows(fr, dev, Q, qa.start),
                              _tgt_cols(fr, t, dev, Q, qa.final))
    stats = QueryStats(payload_bits=fr.traffic_bits("rpq", states=Q),
                       collective_rounds=1, boundary=fr.B, states=Q)
    return QueryResult(ans, None, stats,
                       D.cpu().numpy() if return_matrix else None)
