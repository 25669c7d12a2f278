"""Continuous-batching engine for distributed reachability serving.

Submitters enqueue typed requests and get awaitable futures at once
(:class:`QueryFuture` / :class:`UpdateFuture`); a scheduler thread forms
bounded chunks from whatever is pending and runs each as ONE
``session.run`` mixed batch.  The session's planner fuses the chunk into
one execution per (kind, automaton) group, on the card through the or-and
and min-plus kernels, so the one-collective-per-group guarantee holds
under load.

Scheduling model:

* The intake queue is a sequence of **segments** separated by graph
  updates.  A delta is a snapshot barrier: every query submitted before it
  is served before it applies (pre-delta futures carry the pre-delta
  ``cache_version``), and queries submitted after it wait behind it.
* **MVCC mode** (built with a
  :class:`~repro_torch.core.versions.VersionedCacheStore`) removes the
  barrier: deltas go to a repair worker thread that commits each as a new
  copy-on-write version while query chunks keep running against the
  pinned head.  The queue stays one segment, reads never wait for a
  repair, and a delta becomes visible exactly when its version publishes.
  Both threads launch kernels on the device's default stream, so a read
  may still queue behind a repair's kernels on the card, though never on
  a lock.
* Within a segment, requests sit in their admission lane (GREEN first,
  then YELLOW).  A chunk ships when the lane holds a full batch, a barrier
  or a flush waits behind it, the oldest deadline in the lane is within
  ``ship_margin`` of expiring, or the oldest request has waited
  ``batch_wait``: the knob that trades latency for batch occupancy.
* Execution: expired requests fail fast with
  :class:`~repro_torch.errors.DeadlineExceeded`, failed chunks retry with
  capped exponential backoff, chunks that keep failing are bisected until
  the poison request is quarantined alone
  (:class:`~repro_torch.errors.DeadLetterError`), and a failing delta rolls
  back (or, under MVCC, is dropped) and resolves its future ``FAILED``
  without blocking the queue.
* A fault of the card or of a kernel
  (:func:`~repro_torch.errors.is_device_fault`) is no request's fault: it
  is never retried nor dead-lettered.  It halts the engine: every
  unresolved future resolves ``FAILED`` with it, and :meth:`flush` and
  :meth:`stop` raise it.

Every future reaches **exactly one** terminal
:class:`~repro_torch.errors.Status`, and every resolution feeds the
:class:`~repro_torch.serve.telemetry.Telemetry` layer.

Without a scheduler thread (``start()`` never called), requests wait for
:meth:`flush`, which runs the same scheduling loop inline: the
deterministic mode, which replays the reference package's statuses,
attempts, versions and dead letters for the same stream and fault seed.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import tracing
from ..core.automaton import QueryAutomaton
from ..core.fragments import GraphDelta
from ..core.plan import Dist, Query, Reach, Rpq
from ..core.session import QuerySession
from ..errors import (DeadLetterError, DeadlineExceeded, DeltaApplyFailed,
                      Status, is_device_fault)
from .admission import GREEN, YELLOW
from .telemetry import Telemetry


@dataclasses.dataclass
class RetryPolicy:
    """Capped exponential backoff for transient serving failures: attempt
    ``i`` (2nd, 3rd, ...) sleeps ``min(base * 2^(i-2), max)`` ms first.
    Permanent faults (``exc.permanent``) skip retries entirely."""

    max_attempts: int = 3
    base_delay_ms: float = 5.0
    max_delay_ms: float = 200.0

    def delay_s(self, retry_index: int) -> float:
        """Sleep before the ``retry_index``-th retry (1-based), seconds."""
        ms = min(self.base_delay_ms * (2.0 ** (retry_index - 1)),
                 self.max_delay_ms)
        return ms / 1e3


class _Future:
    """Common awaitable machinery of query and update futures."""

    def __init__(self):
        self._event = threading.Event()
        self._seq: Optional[int] = None     # global resolution order
        self.status: Status = Status.PENDING
        self.value: object = None           # raw result once resolved
        self.error: Optional[BaseException] = None
        self.submitted_at: Optional[float] = None   # engine clock
        self.resolved_at: Optional[float] = None

    def done(self) -> bool:
        """True once the future holds a terminal status."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until resolved and return the value, or raise the typed
        terminal error (``DeadlineExceeded`` / ``DeadLetterError`` /
        ``DeltaApplyFailed``, or the device fault that halted the engine).
        Raises :class:`TimeoutError` if the future is still unresolved
        after ``timeout`` seconds, as on a server built with
        ``start=False`` and not flushed."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"{type(self).__name__} unresolved after "
                f"{timeout!r}s (status {self.status}); deferred servers "
                "(start=False) need flush() before result() returns")
        if self.error is not None:
            raise self.error
        return self.value

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-resolve latency on the engine clock (None while
        pending)."""
        if self.resolved_at is None or self.submitted_at is None:
            return None
        return self.resolved_at - self.submitted_at


_request_ids = itertools.count(1)


class QueryFuture(_Future):
    """Awaitable handle for one submitted query.

    Returned by :meth:`repro_torch.serve.QueryServer.submit`.  ``result()``
    blocks for the answer (bool for reach/bounded/rpq, hop count or None
    for dist); ``value`` is the non-blocking raw view (None until
    resolved), ``status`` the live :class:`~repro_torch.errors.Status`.
    ``cache_version`` is the cache snapshot the answer was computed
    against: the fencing witness.  ``id`` numbers the requests of the
    process; the ``serve.queue_wait`` record of :mod:`repro_torch.tracing`
    carries it.
    """

    def __init__(self, s: int, t: int, kind: str = "reach",
                 bound: Optional[int] = None, regex: Optional[str] = None,
                 automaton: Optional[QueryAutomaton] = None,
                 lane: str = GREEN, cost: float = 0.0,
                 deadline: Optional[float] = None):
        super().__init__()
        self.s = s
        self.t = t
        self.kind = kind
        self.bound = bound
        self.regex = regex
        self.automaton = automaton
        self.lane = lane
        self.cost = cost
        self.deadline = deadline            # absolute engine-clock seconds
        self.cache_version: Optional[int] = None
        self.attempts = 0                   # engine attempts it rode in
        self.degraded = False               # served by the cached fallback
        self.id = next(_request_ids)
        self._enqueued_wall: Optional[float] = None   # batch_wait pacing
        # enqueue to the start of its first batch, wall-clock seconds
        self._queue_wait_s: Optional[float] = None

    def to_query(self) -> Query:
        if self.kind == "reach":
            return Reach(self.s, self.t)
        if self.kind == "dist":
            return Dist(self.s, self.t)
        if self.kind == "bounded":
            return Dist(self.s, self.t, bound=self.bound)
        return Rpq(self.s, self.t, regex=self.regex,
                   automaton=self.automaton)

    def __repr__(self) -> str:
        return (f"QueryFuture({self.kind} {self.s}->{self.t}, "
                f"status={self.status}, lane={self.lane})")


class UpdateFuture(_Future):
    """Awaitable handle for one submitted graph delta.

    Returned by :meth:`repro_torch.serve.QueryServer.submit_delta`.
    ``result()`` blocks for the :class:`~repro_torch.core.incremental
    .UpdateStats` (or raises :class:`~repro_torch.errors.DeltaApplyFailed`
    if the delta rolled back); the terminal ``status`` is ``APPLIED`` or
    ``FAILED``.  ``id`` numbers it among the process's requests; the
    ``serve.delta_wait`` record of :mod:`repro_torch.tracing` carries it.
    """

    def __init__(self, delta: GraphDelta):
        super().__init__()
        self.delta = delta
        self.id = next(_request_ids)
        # submit, time.monotonic_ns(), taken only while the recorder is on
        self._enqueued_ns: Optional[int] = None

    def __repr__(self) -> str:
        return f"UpdateFuture(status={self.status})"


class _Segment:
    """Queries between two snapshot barriers, bucketed by admission
    lane."""

    __slots__ = ("lanes",)

    def __init__(self):
        self.lanes: Dict[str, collections.deque] = {
            GREEN: collections.deque(), YELLOW: collections.deque()}

    def depth(self) -> int:
        return sum(len(q) for q in self.lanes.values())


class AsyncQueryEngine:
    """Continuous-batching scheduler over one shared
    :class:`~repro_torch.core.session.QuerySession` (see the module
    docstring)."""

    #: how long the scheduler's graceful join waits before giving up
    JOIN_TIMEOUT_S = 60.0

    def __init__(self, session: QuerySession, batch_size: int = 64,
                 retry: Optional[RetryPolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 ship_margin_s: float = 0.025,
                 batch_wait_s: float = 0.002,
                 telemetry: Optional[Telemetry] = None,
                 store=None,
                 dead_letter_cap: Optional[int] = 256):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.session = session
        self.batch_size = batch_size
        self.retry = retry or RetryPolicy()
        self._clock = clock
        self._sleep = sleep
        self.ship_margin = ship_margin_s
        self.batch_wait = batch_wait_s
        self.telemetry = telemetry or Telemetry()
        # MVCC mode: a core.versions.VersionedCacheStore over this session;
        # deltas then bypass the barrier queue and commit on the repair
        # worker while chunks serve against the pinned head
        self.store = store
        # _mutex guards the queue and counters; reentrant because batch
        # formation (under the condition) resolves expired futures inline
        self._mutex = threading.RLock()
        self._work = threading.Condition(self._mutex)
        # _Segment | UpdateFuture entries, in submission order
        self._queue: collections.deque = collections.deque()
        self._in_flight: List[_Future] = []   # popped, not yet resolved
        self._flushes = 0                     # active flush() calls
        self._resolved_seq = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # MVCC repair lane: pending deltas and the worker draining them
        self._repairs: collections.deque = collections.deque()
        self._repair_cond = threading.Condition(self._mutex)
        self._repair_thread: Optional[threading.Thread] = None
        # one executor at a time: the scheduler thread or an inline flush,
        # never both (the repair worker is outside this mutex on purpose:
        # repairs overlap query serving)
        self._serve_mutex = threading.Lock()
        # dead letters keep only the newest ``dead_letter_cap`` poison
        # requests (None = unbounded); evictions are counted
        self.dead_letter_cap = dead_letter_cap
        self.dead_letters: collections.deque = collections.deque(
            maxlen=dead_letter_cap)
        self.dead_letters_evicted = 0
        self.batches_run = 0
        self.updates_applied = 0
        self.updates_failed = 0
        self.retries = 0          # extra engine attempts beyond the first
        self.fault: Optional[BaseException] = None   # what halted the engine

    # -- intake ------------------------------------------------------------

    def _check_open(self) -> None:
        if self.fault is not None:
            raise RuntimeError("engine halted by a fault; no new "
                               "submissions") from self.fault
        if self._stop:
            raise RuntimeError("engine is stopped; no new submissions")

    def submit(self, fut: QueryFuture) -> QueryFuture:
        """Enqueue an admitted query future (validation is the server's
        job)."""
        with self._work:
            self._check_open()
            if not self._queue or not isinstance(self._queue[-1], _Segment):
                self._queue.append(_Segment())
            lane = fut.lane if fut.lane in (GREEN, YELLOW) else GREEN
            fut.submitted_at = self._clock()
            # batch_wait pacing tracks real elapsed time even when
            # self._clock is a fake test clock (see _form_chunk)
            # repr: ignore[RPR003] wall-clock batch pacing is by design
            fut._enqueued_wall = time.monotonic()
            self._queue[-1].lanes[lane].append(fut)
            self._work.notify_all()
        return fut

    def submit_update(self, fut: UpdateFuture) -> UpdateFuture:
        """Enqueue a graph delta: a snapshot barrier by default, an entry
        of the repair lane in MVCC mode (the query queue stays one segment
        and never fences)."""
        with self._work:
            self._check_open()
            fut.submitted_at = self._clock()
            if self.store is not None:
                if tracing.ON:
                    fut._enqueued_ns = time.monotonic_ns()
                self._repairs.append(fut)
                self._repair_cond.notify_all()
            else:
                self._queue.append(fut)
            self._work.notify_all()
        return fut

    def backlog(self) -> int:
        """Submitted-but-unresolved count (queued + executing)."""
        with self._mutex:
            queued = sum(e.depth() if isinstance(e, _Segment) else 1
                         for e in self._queue)
            return queued + len(self._repairs) + len(self._in_flight)

    def depths(self) -> Dict[str, int]:
        """Live per-lane queue depths plus the pending update count."""
        with self._mutex:
            out = {GREEN: 0, YELLOW: 0, "updates": 0}
            for e in self._queue:
                if isinstance(e, _Segment):
                    for lane, q in e.lanes.items():
                        out[lane] += len(q)
                else:
                    out["updates"] += 1
            out["updates"] += len(self._repairs)
            return out

    def mvcc_gauges(self) -> Optional[Dict[str, object]]:
        """Live MVCC gauges (None outside MVCC mode): the store's
        version/pin/drop gauges plus the repair-lane depth."""
        if self.store is None:
            return None
        gauges = self.store.gauges()
        with self._mutex:
            gauges["repair_queue_depth"] = len(self._repairs) + sum(
                1 for f in self._in_flight if isinstance(f, UpdateFuture))
        return gauges

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "AsyncQueryEngine":
        """Spawn the scheduler thread (idempotent), plus the repair worker
        in MVCC mode."""
        with self._mutex:
            self._check_open()
            if self.running:
                return self
            self._thread = threading.Thread(
                target=self._loop, name="repro-query-scheduler", daemon=True)
            self._thread.start()
            if self.store is not None:
                self._repair_thread = threading.Thread(
                    target=self._repair_loop, name="repro-repair-worker",
                    daemon=True)
                self._repair_thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the scheduler (and the repair worker).  ``drain=True`` (the
        default) serves everything already queued first; ``drain=False``
        abandons pending futures (they stay unresolved).  Raises the fault
        that halted the engine, if one did."""
        try:
            if drain and self.fault is None:
                self.flush()
        finally:
            with self._work:
                self._stop = True
                self._work.notify_all()
                self._repair_cond.notify_all()
            for t in (self._thread, self._repair_thread):
                if t is not None and t is not threading.current_thread():
                    t.join(timeout=self.JOIN_TIMEOUT_S)
            self._thread = None
            self._repair_thread = None
        if self.fault is not None:
            raise self.fault

    # -- synchronous barrier ----------------------------------------------

    def flush(self) -> List[_Future]:
        """Serve everything submitted before this call and return those
        futures in resolution order.

        With a running scheduler this waits (the flush flag makes the
        scheduler ship partial buckets at once); without one it runs the
        same scheduling loop inline.  Raises the fault that halted the
        engine, if one did.
        """
        with self._mutex:
            targets = self._unresolved()
            self._flushes += 1
            self._work.notify_all()
        try:
            if self.running:
                for f in targets:
                    f._event.wait()
            else:
                self._run_inline(targets)
        finally:
            with self._mutex:
                self._flushes -= 1
        if self.fault is not None:
            raise self.fault
        return sorted(targets, key=lambda f: f._seq)

    def _unresolved(self) -> List[_Future]:
        """Every queued or in-flight future (caller holds the mutex)."""
        out: List[_Future] = []
        for e in self._queue:
            if isinstance(e, _Segment):
                for q in e.lanes.values():
                    out.extend(q)
            else:
                out.append(e)
        out.extend(self._repairs)
        out.extend(f for f in self._in_flight if not f.done())
        return out

    def _run_inline(self, targets: List[_Future]) -> None:
        """Flush without a scheduler thread: run the scheduling loop on the
        calling thread until every target is resolved."""
        with self._serve_mutex:
            while not all(f.done() for f in targets):
                if self.fault is not None:
                    return
                work = self._next_work_nowait()
                if work is None:
                    if all(f.done() for f in targets):
                        break
                    raise RuntimeError(
                        "flush stalled: unresolved futures but no "
                        "runnable work (lost request?)")
                try:
                    self._execute(work)
                except Exception as exc:
                    self._halt(exc)
                    raise

    # -- scheduler loop ----------------------------------------------------

    def _loop(self) -> None:
        while True:
            work = self._next_work()
            if work is None:
                return
            try:
                with self._serve_mutex:
                    self._execute(work)
            except Exception as exc:           # thread boundary: halt
                self._halt(exc)
                return

    def _execute(self, work) -> None:
        if isinstance(work, UpdateFuture):
            if self.store is not None:
                self._apply_update_mvcc(work)
            else:
                self._apply_update(work)
        else:
            self._serve_chunk(work)

    def _repair_loop(self) -> None:
        """MVCC repair worker: commit pending deltas as new versions while
        the scheduler serves queries (no _serve_mutex: that exclusion is
        what MVCC removes)."""
        while True:
            with self._repair_cond:
                while not self._repairs and not self._stop:
                    self._repair_cond.wait()
                if self._stop:
                    return    # drain=True flushed first; else abandon, as
                    #           the scheduler does with its queue
                fut = self._repairs.popleft()
                self._in_flight.append(fut)
            try:
                self._apply_update_mvcc(fut)
            except Exception as exc:           # thread boundary: halt
                self._halt(exc)
                return

    def _halt(self, exc: BaseException) -> None:
        """An error escaped the execution of a chunk or delta: a fault of
        the card or of a kernel (which no retry mends and no request is to
        blame for), or a defect.  Record it, stop taking work, and resolve
        every unresolved future ``FAILED`` with it, so that no waiter
        hangs; :meth:`flush` and :meth:`stop` raise it."""
        with self._work:
            if self.fault is None:
                self.fault = exc
            self._stop = True
            victims = self._unresolved()
            self._queue.clear()
            self._repairs.clear()
            self._work.notify_all()
            self._repair_cond.notify_all()
        for f in victims:
            if not f.done():
                f.error = exc
                self._resolve(f, Status.FAILED)

    def _next_work(self):
        """Block until a chunk or barrier is ready; None on stop."""
        with self._work:
            while True:
                if self._stop:
                    return None
                work = self._pop_ready()
                if work is not None:
                    return work
                head = self._head_segment()
                if head is None or head.depth() == 0:
                    self._work.wait()          # notified on submit/stop
                else:
                    self._work.wait(self._poll_s(head))

    def _next_work_nowait(self):
        """Non-blocking variant for the inline flush (the flush flag is
        set, so any non-empty lane forms a chunk).  Pending MVCC repairs
        drain *after* the queued chunks: the deterministic analogue of the
        live order, where chunks already formed answer the pre-delta
        head."""
        with self._mutex:
            work = self._pop_ready()
            if work is not None:
                return work
            if self._repairs:
                fut = self._repairs.popleft()
                self._in_flight.append(fut)
                return fut
            return None

    def _head_segment(self) -> Optional[_Segment]:
        """Drop exhausted leading segments; return the head segment (None
        when the queue is empty or headed by an update).  Caller holds the
        mutex."""
        while (len(self._queue) > 1
               and isinstance(self._queue[0], _Segment)
               and self._queue[0].depth() == 0):
            self._queue.popleft()
        if not self._queue:
            return None
        head = self._queue[0]
        return head if isinstance(head, _Segment) else None

    def _pop_ready(self):
        """Pop the next executable unit (update barrier or query chunk) if
        one is ready.  Caller holds the mutex."""
        self._head_segment()
        if not self._queue:
            return None
        head = self._queue[0]
        if isinstance(head, UpdateFuture):
            self._queue.popleft()
            self._in_flight.append(head)
            return head
        if head.depth() == 0:
            return None
        with tracing.span("serve.form_chunk"):
            return self._form_chunk(head)

    def _form_chunk(self, seg: _Segment) -> Optional[List[QueryFuture]]:
        """Expire dead requests, then pop a chunk from the preferred lane
        when a ship condition holds.  Caller holds the mutex."""
        now = self._clock()
        for lane, q in seg.lanes.items():
            live: collections.deque = collections.deque()
            while q:
                r = q.popleft()
                if r.deadline is not None and now >= r.deadline:
                    r.error = DeadlineExceeded(
                        f"deadline expired "
                        f"{(now - r.deadline) * 1e3:.1f}ms before the "
                        f"{r.kind} query ({r.s}, {r.t}) was served")
                    self._resolve(r, Status.DEADLINE)
                else:
                    live.append(r)
            seg.lanes[lane] = live
        lane = GREEN if seg.lanes[GREEN] else YELLOW   # green ships first
        reqs = seg.lanes[lane]
        if not reqs:
            return None
        ship = (len(reqs) >= self.batch_size
                or len(self._queue) > 1      # barrier fenced behind us
                or self._flushes > 0
                or self._stop
                or self._deadline_pressed(reqs, now)
                # repr: ignore[RPR003] wall-clock pairs _enqueued_wall above
                or (time.monotonic() - reqs[0]._enqueued_wall
                    >= self.batch_wait))
        if not ship:
            return None
        chunk = [reqs.popleft()
                 for _ in range(min(self.batch_size, len(reqs)))]
        for r in chunk:
            r.status = Status.RUNNING
        self._in_flight.extend(chunk)
        return chunk

    def _deadline_pressed(self, reqs, now: float) -> bool:
        """True when the oldest latency budget in the lane is nearly spent:
        ship the partial bucket now rather than wait for it to fill."""
        deadlines = [r.deadline for r in reqs if r.deadline is not None]
        if not deadlines:
            return False
        return min(deadlines) - now <= self.ship_margin

    def _poll_s(self, seg: _Segment) -> float:
        """Bounded wait until the head segment's next ship condition can
        trigger on its own (batch_wait expiry or deadline pressure)."""
        wait = self.batch_wait
        oldest = None
        for q in seg.lanes.values():
            for r in q:
                if oldest is None or r._enqueued_wall < oldest:
                    oldest = r._enqueued_wall
                if r.deadline is not None:
                    press = r.deadline - self.ship_margin - self._clock()
                    wait = min(wait, press)
        if oldest is not None:
            # repr: ignore[RPR003] wall-clock pairs _enqueued_wall
            wait = min(wait, self.batch_wait - (time.monotonic() - oldest))
        return max(1e-4, min(wait, 0.05))

    # -- execution ---------------------------------------------------------

    def _serve_chunk(self, reqs: List[QueryFuture]) -> None:
        """Fail requests that expired while queued behind a slow batch,
        then serve the rest with retries."""
        now = self._clock()
        live = []
        for r in reqs:
            if r.deadline is not None and now >= r.deadline:
                r.error = DeadlineExceeded(
                    f"deadline expired {(now - r.deadline) * 1e3:.1f}ms "
                    f"before the {r.kind} query ({r.s}, {r.t}) was served")
                self._resolve(r, Status.DEADLINE)
            else:
                live.append(r)
        self._serve_with_retry(live)

    def _serve_with_retry(self, reqs: List[QueryFuture]) -> None:
        """One chunk through the session with capped-backoff retries; a
        chunk that exhausts its retries is bisected so that the poison
        request is dead-lettered alone and its batchmates are served.  A
        device fault is re-raised at once (see :meth:`_halt`)."""
        if not reqs:
            return
        last: Optional[BaseException] = None
        for attempt in range(1, self.retry.max_attempts + 1):
            if attempt > 1:
                self.retries += 1
                self._sleep(self.retry.delay_s(attempt - 1))
            for r in reqs:
                r.attempts += 1
            try:
                with tracing.span("serve.batch"):
                    self._serve_batch(reqs)
            except Exception as exc:           # noqa: BLE001 — retried
                if is_device_fault(exc):
                    raise
                last = exc
                if getattr(exc, "permanent", False):
                    break                      # retrying cannot help
                continue
            with tracing.span("serve.resolve"):
                for r in reqs:
                    self._resolve(r, Status.DONE)
            return
        if len(reqs) == 1:
            r = reqs[0]
            r.error = DeadLetterError(r.attempts, last)
            if (self.dead_letter_cap is not None
                    and len(self.dead_letters) >= self.dead_letter_cap):
                self.dead_letters_evicted += 1   # deque drops the oldest
            self.dead_letters.append(r)
            self._resolve(r, Status.DEAD_LETTER)
            return
        mid = len(reqs) // 2                   # bisect: quarantine poison
        self._serve_with_retry(reqs[:mid])
        self._serve_with_retry(reqs[mid:])

    def _serve_batch(self, reqs: List[QueryFuture]) -> None:
        """ONE session.run mixed batch.  In MVCC mode the batch pins the
        head snapshot for its whole run: a repair that publishes meanwhile
        never moves the ground under it, and the pinned version cannot be
        reclaimed until the batch releases it (re-pinning on each retry is
        sound: head reads are monotonic).  A request's queue wait ends as
        its first batch starts."""
        # repr: ignore[RPR003] wall-clock pairs _enqueued_wall
        start = time.monotonic()
        for r in reqs:
            if r._queue_wait_s is None:
                r._queue_wait_s = start - r._enqueued_wall
                if tracing.ON:
                    tracing.wait("serve.queue_wait",
                                 int(r._enqueued_wall * 1e9),
                                 int(start * 1e9), r.id)
        if self.store is not None:
            ver = self.store.acquire_head()
            try:
                results = self.session.run([r.to_query() for r in reqs],
                                           version=ver)
            finally:
                self.store.release(ver)
        else:
            results = self.session.run([r.to_query() for r in reqs])
        for r, res in zip(reqs, results):
            r.value = res.distance if r.kind == "dist" else res.answer
            r.cache_version = res.cache_version
            r.degraded = res.degraded
        self.batches_run += 1
        self.telemetry.record_batch(len(reqs), self.batch_size)

    def _apply_update(self, fut: UpdateFuture) -> None:
        """Apply one barrier delta.  On failure the session has already
        rolled back to the pre-delta snapshot; the failure resolves the
        future and serving continues: a poison delta never blocks the
        requests queued behind it.  A device fault is re-raised."""
        try:
            fut.value = self.session.apply(fut.delta)
        except DeltaApplyFailed as exc:
            if is_device_fault(exc.cause):
                raise
            fut.error = exc
            self.updates_failed += 1
            self._resolve(fut, Status.FAILED)
            return
        self.updates_applied += 1
        self._resolve(fut, Status.APPLIED)

    def _apply_update_mvcc(self, fut: UpdateFuture) -> None:
        """Commit one delta as a new MVCC version.  On failure the clone is
        dropped and the head keeps serving: no rollback, no pause; the
        failure resolves the future ``FAILED`` as on the barrier path.  A
        device fault is re-raised.  The delta's wait, from its submit to
        here, is recorded as ``serve.delta_wait`` (recorder on)."""
        with tracing.span("serve.commit"):
            if tracing.ON and fut._enqueued_ns is not None:
                tracing.wait("serve.delta_wait", fut._enqueued_ns,
                             time.monotonic_ns(), fut.id)
            try:
                _ver, fut.value = self.store.commit_delta(fut.delta)
            except DeltaApplyFailed as exc:
                if is_device_fault(exc.cause):
                    raise
                fut.error = exc
                self.updates_failed += 1
                self._resolve(fut, Status.FAILED)
                return
            self.updates_applied += 1
            self._resolve(fut, Status.APPLIED)

    def _resolve(self, fut: _Future, status: Status) -> None:
        """Move a future to its terminal status: exactly once, ever."""
        with self._mutex:
            if fut.status.terminal:
                if self.fault is not None:
                    return                     # already failed by _halt
                raise AssertionError(
                    f"future resolved twice ({fut.status} -> {status}): "
                    f"{fut!r}")
            fut.status = status
            fut.resolved_at = self._clock()
            self._resolved_seq += 1
            fut._seq = self._resolved_seq
            try:
                self._in_flight.remove(fut)
            except ValueError:
                pass                           # expired before dispatch
        if isinstance(fut, QueryFuture):
            route, waited = f"{fut.kind}/{fut.lane}", fut._queue_wait_s
        else:
            route, waited = "update", None
        self.telemetry.record(route, fut.latency_s, status, waited)
        fut._event.set()
