"""The open loop: reads (and deltas) sent to a ``QueryServer`` on a
schedule fixed before the window opens, whether or not earlier ones have
been answered, as independent users send them.  The traffic file gives
``read_rate_per_s``, ``mix``, ``pairs``, ``arrivals`` and ``deltas``.

A read's latency runs from when it was due, so that a stall of the
sender or of the server counts against every read it delays; how late the
sender ran is recorded beside it (``sent - due``).  Reads are answered
when their future resolves (``QueryFuture.resolved_at``, the engine's
``time.monotonic``), deltas when their version is committed and readable
(``UpdateFuture`` resolved).

The records are made before the window opens (:func:`prepare`), and the
loop lets go of each future once it has copied out its answer, so that
the loop's own objects do not grow the heap the collector scans while the
program serves.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import List

from bench.data import generate as gen
from bench.record import DeltaRec, ReadRec
from bench.traffic.serving import (submit_read, take_delta, take_read,
                                   window_deltas)

#: how long after the window closes the loop waits for the last answers
GRACE_S = 60.0


@dataclasses.dataclass
class Plan:
    """The window's sends in time order: ``(offset, is_delta, index)``,
    and a record for each read and delta, its ``due`` the offset until
    the window opens."""

    events: list
    reads: List[ReadRec]
    deltas: List[DeltaRec]
    program_deltas: list


def prepare(system, traffic: dict, seed: int, seconds: float) -> Plan:
    if system.server is None:
        raise ValueError(f"{system.cell.name}: an open loop needs a server")
    bench_dir = system.cell.bench_dir
    n_reads = round(traffic["read_rate_per_s"] * seconds)
    reads = gen.make_reads(system.graph.n, n_reads, traffic, seed, bench_dir)
    read_times = gen.make_arrivals(n_reads, seconds, traffic.get("arrivals"),
                                   seed, gen.ARRIVALS, bench_dir)
    deltas, delta_times, program = window_deltas(system, traffic, seed,
                                                 seconds)
    events = sorted([(float(t), False, i) for i, t in enumerate(read_times)]
                    + [(t, True, i) for i, t in enumerate(delta_times)])
    return Plan(events,
                [ReadRec(r, float(t), 0.0) for r, t in zip(reads, read_times)],
                [DeltaRec(d, t, 0.0) for d, t in zip(deltas, delta_times)],
                program)


def drive(system, plan: Plan, seconds: float, clock=time.monotonic):
    """Send the plan's reads and deltas, each at its offset from the
    window's opening; wait until every answer is in or :data:`GRACE_S`
    has passed since the close.  Returns ``(t0, t_end, give_up,
    read_recs, delta_recs)``."""
    server, v_base = system.server, system.v_base
    rrecs, drecs = plan.reads, plan.deltas
    pending: collections.deque = collections.deque()   # (rec, fut, is_delta)
    t0 = clock()
    for off, is_delta, i in plan.events:
        rec = drecs[i] if is_delta else rrecs[i]
        rec.due = due = t0 + off
        wait = due - clock()
        if wait > 0:
            time.sleep(wait)
        rec.sent = clock()
        try:
            fut = (server.submit_delta(plan.program_deltas[i]) if is_delta
                   else submit_read(server, rec.read))
        except Exception as exc:           # refused: attempted and failed
            rec.error = f"{type(exc).__name__}: {exc}"
        else:
            pending.append((rec, fut, is_delta))
        while pending and pending[0][1].done():
            _take(pending.popleft(), v_base)
    t_end = t0 + seconds
    if clock() < t_end:
        time.sleep(max(t_end - clock(), 0.0))
    give_up = t_end + GRACE_S
    while pending:
        item = pending.popleft()
        try:
            item[1].result(timeout=max(give_up - clock(), 0.0))
        except TimeoutError:
            item[0].error = "no answer"
            continue
        except Exception:                  # failed: its status says so
            pass
        _take(item, v_base)
    return t0, t_end, min(give_up, clock()), rrecs, drecs


def _take(item, v_base: int) -> None:
    rec, fut, is_delta = item
    if is_delta:
        take_delta(rec, fut)
    else:
        take_read(rec, fut, v_base)
