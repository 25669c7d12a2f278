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
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Union

import torch

from . import cache as _cache
from ..errors import NoCudaDevice, Status
from .automaton import QueryAutomaton, build_query_automaton
from .engine import QueryStats
from .fragments import Fragmentation
from .plan import (Dist, ExecutionGroup, Query, QueryPlan, QueryResult,
                   Reach, Rpq, plan_queries)

BACKENDS = ("auto", "vmap", "shard_map")
CACHE_MODES = ("amortized", "none")


@dataclasses.dataclass
class SessionStats:
    """Work accounting across the session's lifetime."""

    queries: int = 0         # queries answered
    batches: int = 0         # run() calls
    executions: int = 0      # batched executions issued (one per group)


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
            cache: str = "amortized", device=None) -> "QuerySession":
    """Open a :class:`QuerySession` over ``fr`` — the front door of the
    package (also exported as ``repro_torch.connect``).

    ``backend``: ``"auto"`` and ``"vmap"`` run every fragment's local
    stage as one batched program on one device.  ``cache``:
    ``"amortized"`` serves batches from the rvset/product caches (built
    lazily, shared with every other session on the same fragmentation).
    ``device``: where the caches live and the kernels run; ``None`` means
    the CUDA device, and raises :class:`~repro_torch.errors.NoCudaDevice`
    when there is none.
    """
    return QuerySession(fr, backend=backend, cache=cache, device=device)


class QuerySession:
    """Unified query interface over one fragmentation (see :func:`connect`)."""

    def __init__(self, fr: Fragmentation, backend: str = "auto",
                 cache: str = "amortized", device=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        if cache not in CACHE_MODES:
            raise ValueError(f"unknown cache mode {cache!r}; expected one "
                             f"of {CACHE_MODES}")
        if backend == "shard_map":
            raise NotImplementedError(
                "backend='shard_map' is not ported yet (ROADMAP queue A, "
                "item 7: sharded backend)")
        if cache == "none":
            raise NotImplementedError(
                "cache='none' is not ported yet (ROADMAP queue A, item 5b: "
                "uncached one-shot engine)")
        self.fr = fr
        self.cache_mode = cache
        self.backend = "vmap"
        self.device = _resolve_device(device)
        self.stats = SessionStats()
        self.last_plan: Optional[QueryPlan] = None
        self._regex_cache: Dict[str, QueryAutomaton] = {}
        # serializes group execution so several threads can share one
        # session over the same caches; an RLock because run() resolves
        # automatons (also locked) inline
        self._lock = threading.RLock()

    # -- cache lifecycle ---------------------------------------------------

    def warm(self, with_dist: bool = False) -> "QuerySession":
        """Eagerly build the amortized caches."""
        with self._lock:
            _cache.prepare_rvset_cache(self.fr, self.device,
                                       with_dist=with_dist)
        return self

    @property
    def cache_version(self) -> Optional[int]:
        """Snapshot id of the attached rvset cache (None before the first
        build)."""
        c = self.fr.rvset_cache
        return None if c is None else c.version

    # -- dynamic graphs (later slices) -------------------------------------

    def apply(self, delta):
        raise NotImplementedError(
            "graph deltas are not ported yet (ROADMAP queue A, item 6: "
            "incremental repair)")

    def repair_on(self, fr, delta):
        raise NotImplementedError(
            "repair_on is not ported yet (ROADMAP queue A, item 8: MVCC "
            "store)")

    # -- query execution ---------------------------------------------------

    def run(self, queries: Union[Query, Sequence[Query]],
            version=None) -> List[QueryResult]:
        """Answer a heterogeneous batch; results in submission order.

        The batch is grouped by (kind, automaton) and each group is served
        by one batched execution.  Every result is stamped with the cache
        snapshot it was computed against.  Thread-safe: the whole batch
        runs under the session lock.
        """
        if version is not None:
            raise NotImplementedError(
                "run(version=) is not ported yet (ROADMAP queue A, item 8: "
                "MVCC store)")
        if isinstance(queries, (Reach, Dist, Rpq)):
            queries = [queries]
        queries = list(queries)
        fr = self.fr
        with self._lock:
            plan = plan_queries(queries, self._resolve_automaton)
            self.last_plan = plan
            results: List[Optional[QueryResult]] = [None] * len(queries)
            for group in plan.groups:
                self._run_group_cached(fr, group, results)
            c = fr.rvset_cache
            stamp = None if c is None else c.version
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
        pairs = group.pairs()
        stats = self._group_stats(fr, group)
        if group.kind == "reach":
            ans = _cache.dis_reach_batch(fr, pairs, self.device)
            for i, q, a, st in zip(group.indices, group.queries, ans, stats):
                results[i] = self._reach_result(q, a, st)
        elif group.kind == "dist":
            # exact distances once; each query's bound applies at answer
            # extraction (this is what lets bounded + exact queries fuse)
            ans = _cache.dis_dist_batch(fr, pairs, self.device)
            for i, q, di, st in zip(group.indices, group.queries, ans, stats):
                results[i] = self._dist_result(q, int(di), st)
        else:                                   # rpq
            ans = _cache.dis_rpq_batch(fr, pairs, group.automaton,
                                       self.device)
            for i, q, a, st in zip(group.indices, group.queries, ans, stats):
                results[i] = self._rpq_result(q, group.automaton, a, st)
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
