"""Serving layer: continuous-batching, futures-based query serving over a
shared :class:`~repro_torch.core.session.QuerySession`, on the card.

Everything here is re-exported at this level:

* :class:`QueryServer`: intake and lifecycle; validates and admits
  requests, returns futures, owns the scheduler thread (``start=True``) or
  the deterministic deferred mode (``start=False`` + ``flush()``).
* :class:`AsyncQueryEngine`: the continuous-batching scheduler (segments
  fenced by delta barriers, GREEN-before-YELLOW lanes, partial buckets
  shipped on deadline pressure or ``batch_wait`` expiry,
  retry/bisect/dead-letter execution, the MVCC repair worker).
* :class:`QueryFuture` / :class:`UpdateFuture`: awaitable handles;
  ``QueryRequest`` / ``UpdateRequest`` are their older names.
* :class:`Status`: the one lifecycle enum, shared with session results and
  the error taxonomy.
* :class:`RetryPolicy`: capped exponential backoff.
* :class:`Version` / :class:`VersionedCacheStore`: the MVCC snapshot store
  behind ``QueryServer(..., mvcc=True)`` (:mod:`repro_torch.core.versions`).
* :class:`Telemetry`: sliding-window p50/p95/p99 per route, qps, batch
  occupancy, lane depths.
* :class:`AdmissionPolicy` / :func:`estimate_cost` and the lanes ``GREEN``
  / ``YELLOW`` / ``RED`` / ``LANES``.
* :class:`FaultInjector` / :class:`FaultSpec` / ``SITES``: seeded fault
  injection.
* the typed errors (:class:`ServingError` and its subclasses).
* :class:`Request` / :class:`ServeEngine`: the LM family's batched greedy
  decoder (:mod:`repro_torch.serve.lm`), unrelated to the query server.
"""
from ..core.versions import Version, VersionedCacheStore
from ..errors import (DeadLetterError, DeadlineExceeded, DeltaApplyFailed,
                      InjectedFault, QueryTooExpensive, ServingError,
                      Status)
from .admission import (GREEN, LANES, RED, YELLOW, AdmissionPolicy,
                        estimate_cost)
from .engine import (AsyncQueryEngine, QueryFuture, RetryPolicy,
                     UpdateFuture)
from .faults import SITES, FaultInjector, FaultSpec
from .lm import Request, ServeEngine
from .query_server import (QueryRequest, QueryServer, UpdateRequest,
                           VALID_KINDS)
from .telemetry import Telemetry

__all__ = [
    "QueryServer", "AsyncQueryEngine",
    "QueryFuture", "UpdateFuture", "QueryRequest", "UpdateRequest",
    "Status", "RetryPolicy", "Telemetry", "VALID_KINDS",
    "Version", "VersionedCacheStore",
    "AdmissionPolicy", "estimate_cost",
    "GREEN", "YELLOW", "RED", "LANES",
    "FaultInjector", "FaultSpec", "SITES",
    "ServingError", "QueryTooExpensive", "DeadlineExceeded",
    "DeadLetterError", "DeltaApplyFailed", "InjectedFault",
    "Request", "ServeEngine",
]
