"""The backlog loop: a fixed number of reads kept in flight at a
``QueryServer``.  A read is sent as soon as an earlier one has been
answered, so that full batches always wait at the server, and the reads
answered inside the window measure what the served path completes at
saturation.  Deltas, where the traffic has them, are sent on a schedule
fixed before the window opens, as in the open loop.

The load is the backlog, ``in_flight`` reads, and not an offered rate
above capacity: under such a rate the server's queue would grow all
through the window, and its batch former walks the whole queue for every
batch it forms, so the rate completed would depend on how far the offered
rate lay above capacity.  A fixed backlog keeps that queue at
``in_flight`` reads in every run.

The traffic file gives ``in_flight``, ``reads`` (the number drawn, sent
in turn, from the first again when they run out), ``mix``, ``pairs`` and
``deltas``.  A read's latency runs from its send to its answer.
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
    reads: list
    deltas: List[DeltaRec]         # ``due``: the offset, until the window
    program_deltas: list
    in_flight: int


def prepare(system, traffic: dict, seed: int, seconds: float) -> Plan:
    if system.server is None:
        raise ValueError(f"{system.cell.name}: a backlog needs a server")
    reads = gen.make_reads(system.graph.n, traffic["reads"], traffic, seed,
                           system.cell.bench_dir)
    deltas, times, program = window_deltas(system, traffic, seed, seconds)
    return Plan(reads, [DeltaRec(d, t, 0.0) for d, t in zip(deltas, times)],
                program, int(traffic["in_flight"]))


def _wait(fut, timeout: float) -> None:
    try:
        fut.result(timeout=max(timeout, 0.0))
    except Exception:              # unresolved, or failed: its status says
        pass


def drive(system, plan: Plan, seconds: float, clock=time.monotonic):
    """Keep ``plan.in_flight`` reads at the server and send each delta at
    its offset until ``seconds`` have passed; then wait until every answer
    is in or :data:`GRACE_S` has passed since the close.  Returns ``(t0,
    t_end, give_up, read_recs, delta_recs)``."""
    server, v_base = system.server, system.v_base
    reads, drecs = plan.reads, plan.deltas
    recs: List[ReadRec] = []
    flying: collections.deque = collections.deque()     # (rec, fut)
    updating: collections.deque = collections.deque()   # (rec, fut)

    def send_read() -> None:
        r = reads[len(recs) % len(reads)]
        now = clock()
        rec = ReadRec(r, now, now)
        recs.append(rec)
        try:
            flying.append((rec, submit_read(server, r)))
        except Exception as exc:           # refused: attempted and failed
            rec.error = f"{type(exc).__name__}: {exc}"

    def send_delta(i: int) -> None:
        rec = drecs[i]
        rec.sent = clock()
        try:
            updating.append((rec, server.submit_delta(plan.program_deltas[i])))
        except Exception as exc:
            rec.error = f"{type(exc).__name__}: {exc}"

    def take_done() -> None:
        while flying and flying[0][1].done():
            take_read(*flying.popleft(), v_base)
        while updating and updating[0][1].done():
            take_delta(*updating.popleft())

    t0 = clock()
    t_end = t0 + seconds
    for rec in drecs:
        rec.due += t0
    nd = 0
    while True:
        now = clock()
        if now >= t_end:
            break
        while nd < len(drecs) and drecs[nd].due <= now:
            send_delta(nd)
            nd += 1
        while len(flying) < plan.in_flight:
            send_read()
        until = min(t_end, drecs[nd].due if nd < len(drecs) else t_end)
        if flying:
            _wait(flying[0][1], until - clock())
        else:
            time.sleep(max(until - clock(), 0.0))
        take_done()
    while nd < len(drecs):                 # due inside the window: sent late
        send_delta(nd)
        nd += 1
    give_up = t_end + GRACE_S
    for rec, fut in list(flying) + list(updating):
        _wait(fut, give_up - clock())
    for items, take in ((flying, lambda r, f: take_read(r, f, v_base)),
                        (updating, take_delta)):
        for rec, fut in items:
            if fut.done():
                take(rec, fut)
            else:
                rec.error = "no answer"
    return t0, t_end, min(give_up, clock()), recs, drecs
