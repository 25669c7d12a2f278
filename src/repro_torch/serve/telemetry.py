"""Live serving telemetry for the continuous-batching engine.

The scheduler records one sample per resolved future and one per executed
batch; :meth:`Telemetry.snapshot` folds them into the serving dashboard:
p50/p95/p99 latency per route (``"<kind>/<lane>"`` for queries,
``"update"`` for deltas), each query route's p50/p95 queue wait (enqueue
to the start of the request's first batch, from the engine's own stamps:
no clock is read on submit), queries per second over the sliding window,
mean batch occupancy (chunk size over the configured batch size: how full
the fused buckets ship), and the lane depths the engine passes in.

Everything is windowed (bounded deques), so a long-running server's
telemetry stays O(window), and every recorder takes one short lock, so
submitter threads, the scheduler, the repair worker and readers never
block each other for long.  Latencies are host-clock seconds.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) of an unsorted sample list."""
    if not samples:
        return 0.0
    ordered = sorted(samples)
    idx = min(len(ordered) - 1, int(q * len(ordered)))
    return ordered[idx]


class Telemetry:
    """Sliding-window latency / throughput / occupancy recorder.

    ``window`` bounds the retained samples per route and the throughput
    and occupancy windows.  ``clock`` only times the qps window (latencies
    come from the engine, which may run on a fake clock in tests).
    """

    def __init__(self, window: int = 2048, clock=time.monotonic):
        self.window = int(window)
        self._clock = clock
        self._lock = threading.Lock()
        # route -> deque of latencies in seconds
        self._latency: Dict[str, deque] = {}
        # route -> deque of queue waits in seconds (queries that reached
        # a batch)
        self._queue_wait: Dict[str, deque] = {}
        # resolve timestamps (wall clock) for the qps window
        self._events: deque = deque(maxlen=self.window)
        # (chunk_size, batch_size) per executed batch
        self._batches: deque = deque(maxlen=self.window)
        # terminal status -> count, over the server's whole lifetime
        self.status_counts: Dict[str, int] = {}
        self.resolved = 0

    # -- recorders (called by the engine) ---------------------------------

    def record(self, route: str, latency_s: Optional[float],
               status, queue_wait_s: Optional[float] = None) -> None:
        """One future reached a terminal status; ``queue_wait_s``: how long
        it queued before its first batch started (None: it reached
        none)."""
        with self._lock:
            self.resolved += 1
            key = str(status)
            self.status_counts[key] = self.status_counts.get(key, 0) + 1
            self._events.append(self._clock())
            for samples, v in ((self._latency, latency_s),
                               (self._queue_wait, queue_wait_s)):
                if v is not None:
                    lane = samples.get(route)
                    if lane is None:
                        lane = samples[route] = deque(maxlen=self.window)
                    lane.append(float(v))

    def record_batch(self, chunk_size: int, batch_size: int) -> None:
        """One fused chunk was executed."""
        with self._lock:
            self._batches.append((int(chunk_size), max(1, int(batch_size))))

    # -- readers -----------------------------------------------------------

    def snapshot(self, lane_depths: Optional[Dict[str, int]] = None,
                 gauges: Optional[Dict] = None) -> Dict:
        """One coherent dashboard sample (a plain, JSON-serializable dict).

        ``gauges``: the live MVCC gauges of
        :meth:`AsyncQueryEngine.mvcc_gauges` (versions, pins, repair
        queue), included under ``"mvcc"`` when the server runs in MVCC
        mode."""
        with self._lock:
            routes = {}
            for route, lane in self._latency.items():
                ms = [s * 1e3 for s in lane]
                routes[route] = {
                    "count": len(ms),
                    "p50_ms": percentile(ms, 0.50),
                    "p95_ms": percentile(ms, 0.95),
                    "p99_ms": percentile(ms, 0.99),
                }
                waits = [s * 1e3 for s in self._queue_wait.get(route, ())]
                if waits:
                    routes[route]["queue_wait_p50_ms"] = percentile(waits,
                                                                    0.50)
                    routes[route]["queue_wait_p95_ms"] = percentile(waits,
                                                                    0.95)
            if len(self._events) >= 2:
                span = self._events[-1] - self._events[0]
                qps = (len(self._events) - 1) / span if span > 0 else 0.0
            else:
                qps = 0.0
            if self._batches:
                occupancy = (sum(c / b for c, b in self._batches)
                             / len(self._batches))
            else:
                occupancy = 0.0
            out = {
                "resolved": self.resolved,
                "qps": qps,
                "batches": len(self._batches),
                "batch_occupancy": occupancy,
                "lane_depths": dict(lane_depths or {}),
                "routes": routes,
                "statuses": dict(self.status_counts),
            }
            if gauges is not None:
                out["mvcc"] = dict(gauges)
            return out
