"""Futures-based query server over a :class:`QuerySession`.

:class:`QueryServer` is the intake layer of the continuous-batching stack:
it validates and admits requests (admission lanes, RED rejection) and
hands them to the :class:`~repro_torch.serve.engine.AsyncQueryEngine`,
which forms fused (kind, automaton) batches from whatever is pending and
runs each as ONE ``session.run`` on the shared session: on the CUDA device
through the or-and and min-plus kernels, or on the CPU when the caller
asks for it (``device="cpu"``).  ``submit`` returns a
:class:`~repro_torch.serve.engine.QueryFuture` at once; ``submit_delta`` an
:class:`~repro_torch.serve.engine.UpdateFuture` that fences the queue as a
snapshot barrier (or, with ``mvcc=True``, commits a new version beside the
reads).

Two serving modes:

* **continuous** (``start=True``, the default): a scheduler thread serves
  as load arrives; callers block on ``future.result(timeout=)`` only for
  their own answers;
* **deferred** (``start=False``): nothing runs until :meth:`flush`, which
  runs the same scheduling loop inline: deterministic, and for the same
  requests and fault seed the same statuses, attempts, cache versions and
  dead letters as the reference package's server.

See :mod:`repro_torch.serve.engine` for the scheduling model and
:mod:`repro_torch.serve.telemetry` for the p50/p95/p99 / qps / occupancy
feed behind :meth:`QueryServer.telemetry`.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..core.automaton import QueryAutomaton
from ..core.fragments import Fragmentation, GraphDelta
from ..core.plan import Rpq
from ..core.session import QuerySession, connect
from ..core.versions import VersionedCacheStore
from ..errors import QueryTooExpensive, Status
from .admission import AdmissionPolicy, estimate_cost
from .engine import (AsyncQueryEngine, QueryFuture, RetryPolicy,
                     UpdateFuture)
from .faults import FaultInjector
from .telemetry import Telemetry

VALID_KINDS = ("reach", "dist", "bounded", "rpq")

# the string statuses, as values of the one Status enum (a str subclass,
# so DONE == Status.DONE == "done")
PENDING = Status.PENDING
DONE = Status.DONE
DEAD_LETTER = Status.DEAD_LETTER
DEADLINE = Status.DEADLINE
APPLIED = Status.APPLIED
FAILED = Status.FAILED

# the older names of the request records: submissions return futures with
# the same attributes (s/t/kind/lane/status/error/attempts/cache_version,
# and ``value`` for the result)
QueryRequest = QueryFuture
UpdateRequest = UpdateFuture


class QueryServer:
    """Continuous-batching fault-tolerant server over one (dynamic)
    Fragmentation."""

    def __init__(self, fr: Fragmentation, batch_size: int = 64,
                 warm: bool = True, with_dist: bool = False,
                 backend: str = "auto",
                 session: Optional[QuerySession] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 retry: Optional[RetryPolicy] = None,
                 chaos: Optional[FaultInjector] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 ship_margin_ms: float = 25.0,
                 batch_wait_ms: float = 2.0,
                 start: bool = True,
                 telemetry_window: int = 2048,
                 mvcc: bool = False,
                 versions: int = 4,
                 dead_letter_cap: Optional[int] = 256,
                 device=None):
        """``device``: where a fresh session's caches live and its kernels
        run, passed to :func:`repro_torch.connect`: ``None`` means the CUDA
        device, and raises :class:`~repro_torch.errors.NoCudaDevice` when
        there is none; ``"cpu"`` runs the kernels' plain versions.  An
        explicit ``session`` brings its own device (a ``device`` that
        differs from it is refused).

        ``with_dist=True`` builds the distance cache eagerly too; by
        default it builds on the first dist/bounded query, so reach-only
        servers never pay for it.  Pass an existing ``session`` to share its
        caches and backend with other servers (the session serializes group
        execution), or a ``backend`` name to open a fresh one.

        ``admission`` defaults to :meth:`AdmissionPolicy.for_fragmentation`
        (meaningful lanes, no rejection); ``retry`` to a 3-attempt capped
        backoff.  ``chaos`` threads a
        :class:`~repro_torch.serve.faults.FaultInjector` through the
        session.  ``clock``/``sleep`` are injectable for deterministic
        deadline and backoff tests; ``ship_margin_ms`` is how close to the
        oldest deadline the scheduler ships a partial bucket, and
        ``batch_wait_ms`` how long it lets a partial bucket wait for
        batchmates (the latency/occupancy knob).

        ``start=False`` skips the scheduler thread: requests wait for
        :meth:`flush` (deterministic mode).

        ``mvcc=True`` serves reads from an MVCC snapshot store
        (:class:`~repro_torch.core.versions.VersionedCacheStore`, up to
        ``versions`` snapshots live): deltas commit as copy-on-write
        versions on a repair worker while query chunks keep running against
        the pinned head.  The default (``False``) keeps the barrier
        semantics, where a delta fences the queue.  ``dead_letter_cap``
        bounds the retained dead letters (oldest evicted and counted;
        ``None``: unbounded)."""
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if session is None:
            session = connect(fr, backend=backend, chaos=chaos, device=device)
        else:
            if device is not None and torch.device(device) != session.device:
                raise ValueError(f"the session runs on {session.device}, "
                                 f"not on the device {device!r} asked for")
            if chaos is not None:
                session.chaos = chaos
        self.fr = fr
        self.with_dist = with_dist
        self.session = session
        self.admission = admission or AdmissionPolicy.for_fragmentation(fr)
        self._clock = clock
        self.rejected = 0         # RED-lane submissions refused
        if warm:
            self.session.warm(with_dist=with_dist)
        self.store = (VersionedCacheStore(self.session, capacity=versions)
                      if mvcc else None)
        self.engine = AsyncQueryEngine(
            self.session, batch_size=batch_size,
            retry=retry or RetryPolicy(), clock=clock, sleep=sleep,
            ship_margin_s=ship_margin_ms / 1e3,
            batch_wait_s=batch_wait_ms / 1e3,
            telemetry=Telemetry(window=telemetry_window),
            store=self.store, dead_letter_cap=dead_letter_cap)
        if start:
            self.engine.start()

    # -- request intake ----------------------------------------------------

    def submit(self, s: int, t: int, kind: str = "reach",
               bound: Optional[int] = None, regex: Optional[str] = None,
               automaton: Optional[QueryAutomaton] = None,
               deadline_ms: Optional[float] = None) -> QueryFuture:
        """Validate, admit and enqueue one query; returns its
        :class:`~repro_torch.serve.engine.QueryFuture` at once.

        Raises ``ValueError`` on malformed arguments (unknown kind, bad
        kind/argument combination, endpoint outside ``[0, n)``) and
        :class:`~repro_torch.errors.QueryTooExpensive` when admission
        rejects the query; neither leaves anything queued.
        ``deadline_ms`` gives the request a latency budget from now; an
        expired request resolves ``DEADLINE`` instead of being served
        late."""
        if kind not in VALID_KINDS:
            raise ValueError(f"unknown query kind {kind!r}; expected one "
                             f"of {VALID_KINDS}")
        if kind == "bounded" and bound is None:
            raise ValueError("bounded queries require a bound")
        if kind != "bounded" and bound is not None:
            raise ValueError(f"bound= is only valid for kind='bounded', "
                             f"not {kind!r}")
        if kind == "rpq" and (regex is None) == (automaton is None):
            raise ValueError("rpq queries require exactly one of regex= "
                             "or automaton=")
        if kind != "rpq" and (regex is not None or automaton is not None):
            raise ValueError(f"regex/automaton are only valid for "
                             f"kind='rpq', not {kind!r}")
        s, t = int(s), int(t)
        n = self.fr.g.n
        for name, v in (("s", s), ("t", t)):
            if not 0 <= v < n:
                raise ValueError(
                    f"query endpoint {name}={v} is out of range for a "
                    f"graph with {n} nodes (valid ids: 0..{n - 1})")
        lane, cost = self._admit(kind, s, t, regex, automaton)
        deadline = (None if deadline_ms is None
                    else self._clock() + deadline_ms / 1e3)
        fut = QueryFuture(s, t, kind, bound, regex, automaton,
                          lane=lane, cost=cost, deadline=deadline)
        return self.engine.submit(fut)

    def _admit(self, kind: str, s: int, t: int, regex, automaton):
        """Admission decision: (lane, cost estimate).  Raises
        :class:`~repro_torch.errors.QueryTooExpensive` for the RED lane."""
        states, cached = 1, True
        if kind == "rpq":
            qa = automaton
            if qa is None:
                qa = self.session._resolve_automaton(Rpq(s, t, regex=regex))
            states = qa.n_states
            # price against the cache the query will run on: the head
            # version's in MVCC mode, the shared one otherwise
            fr = self.store.head().fr if self.store is not None else self.fr
            c = fr.rvset_cache
            cached = c is not None and qa.cache_key() in c.rpq_closures
        cost = estimate_cost(self.fr, kind, states=states,
                             closure_cached=cached)
        try:
            lane = self.admission.admit(kind, cost)
        except QueryTooExpensive:
            self.rejected += 1
            raise
        return lane, cost

    def submit_delta(self, delta: GraphDelta) -> UpdateFuture:
        """Enqueue a graph update; returns its
        :class:`~repro_torch.serve.engine.UpdateFuture` at once.

        Default mode: the delta is a snapshot barrier; queries submitted
        before it are served against the pre-delta cache, queries after it
        wait for the repaired cache (or, if the delta fails and rolls back,
        resume against the unchanged one).

        MVCC mode (``mvcc=True``): the delta repairs on the repair worker
        and never fences the queue; it becomes visible to new batches when
        its version publishes (the commit point is ``future.result()``),
        and a failed delta is dropped while the head keeps serving."""
        return self.engine.submit_update(UpdateFuture(delta))

    def pending(self) -> int:
        """Submitted-but-unresolved request count."""
        return self.engine.backlog()

    # -- serving -----------------------------------------------------------

    def flush(self) -> List[object]:
        """Synchronous barrier: serve everything submitted before this call;
        returns those futures in resolution order, each with a terminal
        ``status`` and a ``value``/``error``."""
        return self.engine.flush()

    def drain(self) -> List[object]:
        """Deprecated alias of :meth:`flush`: submissions return futures,
        so block on ``future.result(timeout=)`` for single answers, or call
        :meth:`flush` where a full barrier is meant."""
        warnings.warn(
            "QueryServer.drain() is deprecated: submissions return "
            "futures now; use future.result(timeout=) for per-request "
            "answers or QueryServer.flush() for a synchronous barrier",
            DeprecationWarning, stacklevel=2)
        return self.flush()

    def close(self, drain: bool = True) -> None:
        """Stop the scheduler thread (serving the backlog first unless
        ``drain=False``).  Idempotent; deferred-mode servers just flush."""
        self.engine.stop(drain=drain)

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    # -- introspection -----------------------------------------------------

    def telemetry(self) -> dict:
        """Live serving dashboard: p50/p95/p99 latency per route
        (kind/lane), p50/p95 queue wait per query route (enqueue to the
        start of its first batch), queries/sec, batch occupancy, lane
        depths, status
        counts (:class:`~repro_torch.serve.telemetry.Telemetry`); in MVCC
        mode also an ``"mvcc"`` gauge block: live versions, pinned readers
        per version, repair-queue depth, versions committed, dropped and
        evicted."""
        return self.engine.telemetry.snapshot(
            lane_depths=self.engine.depths(),
            gauges=self.engine.mvcc_gauges())

    @property
    def batch_size(self) -> int:
        return self.engine.batch_size

    @property
    def dead_letters(self) -> List[QueryFuture]:
        """Retained dead-lettered requests, oldest first (a list copy of the
        engine's capped buffer: at most ``dead_letter_cap``)."""
        return list(self.engine.dead_letters)

    @property
    def dead_letters_evicted(self) -> int:
        """Dead-lettered requests dropped by the retention cap."""
        return self.engine.dead_letters_evicted

    @property
    def batches_run(self) -> int:
        return self.engine.batches_run

    @property
    def retries(self) -> int:
        return self.engine.retries

    @property
    def updates_applied(self) -> int:
        return self.engine.updates_applied

    @property
    def updates_failed(self) -> int:
        return self.engine.updates_failed

    # -- convenience -------------------------------------------------------

    def serve_pairs(self, pairs: Sequence[Tuple[int, int]],
                    kind: str = "reach", **kw) -> List[object]:
        """Submit a batch of ``(s, t)`` pairs and block for their answers
        (raising the typed error if one fails terminally).  In deferred
        mode this flushes the whole queue first."""
        mine = [self.submit(s, t, kind=kind, **kw) for s, t in pairs]
        if not self.engine.running:
            self.engine.flush()
        return [f.result() for f in mine]
