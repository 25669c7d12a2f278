"""Typed query IR + planner for mixed-kind fused batches (DESIGN.md Sec. 5).

The paper's three query classes (reachability, bounded reachability /
distance, regular path) share one evaluation skeleton — localEval partials
combined through the boundary dependency structure — and therefore one
serving engine.  This module is the *language* half of that engine:

* **IR**: :class:`Reach`, :class:`Dist`, :class:`Rpq` — small frozen
  dataclasses describing one query each.  They carry no fragmentation or
  backend state, so a workload is just a list of values that can be built,
  inspected, logged, or replayed independently of execution.
* **Planner**: :func:`plan_queries` groups a heterogeneous batch by
  *execution signature* — ``(kind,)`` for reach/dist, ``(kind,
  automaton-key)`` for RPQs — into :class:`ExecutionGroup`\\ s.  Every group
  is served by ONE batched execution (`core.cache` batched kernels), and
  group sizes are padded up to power-of-two buckets (:func:`bucket_size`)
  so bursty, ragged batches reuse a small set of shapes — the same
  padding as the reference package, so the reported traffic agrees.

Distances with and without a bound share a group: the cached tropical
kernel computes exact distances and the bound is applied per-query at
answer extraction, so ``Dist(s, t)`` and ``Dist(s, t, bound=l)`` fuse.

Execution lives in :mod:`repro_torch.core.session`; this module stays
importable without touching a device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..errors import Status
from .automaton import QueryAutomaton
from .engine import QueryStats


# ---------------------------------------------------------------------------
# query IR
# ---------------------------------------------------------------------------

def _check_endpoints(s, t):
    if not (isinstance(s, (int, np.integer)) and isinstance(t, (int, np.integer))):
        raise TypeError(f"query endpoints must be ints, got ({s!r}, {t!r})")
    if s < 0 or t < 0:
        raise ValueError(f"query endpoints must be >= 0, got ({s}, {t})")


@dataclasses.dataclass(frozen=True)
class Reach:
    """q_r(s, t): is there any path from s to t?  (paper Fig. 3)

    Run via ``session.run([Reach(s, t), ...])``; the result's ``answer``
    is a bool.  Frozen and hashable so batches dedup with ``set()``.
    """

    s: int
    t: int
    # uncached (seed-engine) execution only: also return the assembled
    # dependency matrix, like the legacy ``dis_reach(..., return_matrix=True)``
    return_matrix: bool = False
    kind = "reach"

    def __post_init__(self):
        _check_endpoints(self.s, self.t)


@dataclasses.dataclass(frozen=True)
class Dist:
    """q_br(s, t, l) / dist(s, t): bounded reachability when ``bound`` is
    given, exact shortest distance otherwise.  (paper Sec. 4)

    With ``bound=l`` the result's ``answer`` is ``dist(s, t) <= l``; with
    ``bound=None`` the result's ``distance`` is the exact hop count
    (``-1`` if unreachable).  Both forms share one fused tropical
    execution per batch group.
    """

    s: int
    t: int
    bound: Optional[int] = None
    kind = "dist"

    def __post_init__(self):
        _check_endpoints(self.s, self.t)


@dataclasses.dataclass(frozen=True, eq=False)
class Rpq:
    """q_rr(s, t, R): regular path query — exactly one of ``regex`` (label
    names resolved against the session's graph) or ``automaton`` (a
    prebuilt :class:`QueryAutomaton`) must be given.  (paper Sec. 5)

    The result's ``answer`` is True iff some s→t path spells a word the
    automaton accepts.  Queries sharing an automaton (or an equal regex)
    fuse into one product-graph execution per batch group.
    """

    s: int
    t: int
    regex: Optional[str] = None
    automaton: Optional[QueryAutomaton] = None
    return_matrix: bool = False
    kind = "rpq"

    def __post_init__(self):
        _check_endpoints(self.s, self.t)
        if (self.regex is None) == (self.automaton is None):
            raise ValueError(
                "Rpq needs exactly one of regex= or automaton=, got "
                f"regex={self.regex!r}, automaton={self.automaton!r}")

    # hand-rolled value semantics: the generated ones would compare the
    # automaton's numpy arrays elementwise (ambiguous truth value) and
    # inherit its unhashability — dedup via set(queries) must work
    def _key(self) -> tuple:
        return (self.s, self.t, self.regex,
                None if self.automaton is None else self.automaton.cache_key(),
                self.return_matrix)

    def __eq__(self, other):
        return isinstance(other, Rpq) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


Query = Union[Reach, Dist, Rpq]


@dataclasses.dataclass
class QueryResult:
    """One answered query (field layout matches the legacy core.api one,
    plus the rvset-cache snapshot id the answer was computed against)."""

    answer: bool
    distance: Optional[int]
    stats: QueryStats
    dependency_matrix: Optional[np.ndarray] = None
    # version of the rvset cache consulted (None: uncached execution)
    cache_version: Optional[int] = None
    # True when the sharded engine failed for this query's group and the
    # answer was served by the vmap fallback instead (still exact; see
    # DESIGN.md Sec. 7)
    degraded: bool = False
    # lifecycle state; the session only ever returns answered results, so
    # this is DONE everywhere a result exists — serving futures reuse the
    # same enum for their richer terminal states (DESIGN.md Sec. 8)
    status: Status = Status.DONE


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

BUCKET_MIN = 8      # smallest fused-batch shape (tiny groups pad up to this)


def bucket_size(n: int) -> int:
    """Pad a group of ``n`` queries to the next power-of-two bucket
    (>= BUCKET_MIN), so ragged batch sizes map onto a logarithmic number of
    compiled programs instead of one per size."""
    if n <= BUCKET_MIN:
        return BUCKET_MIN
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class ExecutionGroup:
    """All queries of one batch sharing an execution signature: they are
    answered by ONE invocation of the group's compiled program."""

    kind: str                                  # "reach" | "dist" | "rpq"
    key: Tuple                                 # full signature (hashable)
    indices: List[int] = dataclasses.field(default_factory=list)
    queries: List[Query] = dataclasses.field(default_factory=list)
    automaton: Optional[QueryAutomaton] = None  # resolved, rpq groups only

    @property
    def n(self) -> int:
        return len(self.queries)

    @property
    def padded_size(self) -> int:
        return bucket_size(self.n)

    def pairs(self) -> np.ndarray:
        """[padded_size, 2] int64 (s, t) rows; padding repeats row 0, whose
        answer is computed once more and discarded (semiring no-op)."""
        p = np.array([(q.s, q.t) for q in self.queries], dtype=np.int64)
        pad = self.padded_size - len(p)
        if pad:
            p = np.concatenate([p, np.repeat(p[:1], pad, axis=0)])
        return p


@dataclasses.dataclass
class QueryPlan:
    """Grouping of one submitted batch; ``groups`` preserve first-seen
    order, ``indices`` inside each group preserve submission order."""

    groups: List[ExecutionGroup]
    n_queries: int

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def explain(self) -> str:
        lines = [f"plan: {self.n_queries} queries -> {self.n_groups} fused "
                 "executions"]
        for g in self.groups:
            sig = g.kind if g.automaton is None else \
                f"{g.kind}[|Q|={g.automaton.n_states}]"
            lines.append(f"  {sig}: {g.n} queries (padded to "
                         f"{g.padded_size})")
        return "\n".join(lines)


def plan_queries(queries: Sequence[Query],
                 resolve_automaton: Callable[[Rpq], QueryAutomaton],
                 ) -> QueryPlan:
    """Group a heterogeneous batch by (kind, automaton) execution signature.

    ``resolve_automaton`` turns an :class:`Rpq` into its
    :class:`QueryAutomaton` (compiling the regex against the session's
    graph labels); two RPQs land in the same group iff their automata have
    equal :meth:`QueryAutomaton.cache_key`, which is also the key the
    product-closure cache uses — one group == one closure == one program.
    """
    groups: dict = {}
    for i, q in enumerate(queries):
        if isinstance(q, Reach):
            key: Tuple = ("reach",)
            qa = None
        elif isinstance(q, Dist):
            key = ("dist",)
            qa = None
        elif isinstance(q, Rpq):
            qa = resolve_automaton(q)
            key = ("rpq", qa.cache_key())
        else:
            raise TypeError(
                f"queries[{i}] is {type(q).__name__}; expected Reach, Dist "
                "or Rpq (see repro_torch.core.plan)")
        group = groups.get(key)
        if group is None:
            group = groups[key] = ExecutionGroup(kind=key[0], key=key,
                                                 automaton=qa)
        group.indices.append(i)
        group.queries.append(q)
    return QueryPlan(groups=list(groups.values()), n_queries=len(queries))
