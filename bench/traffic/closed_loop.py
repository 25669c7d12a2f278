"""The closed loop: one caller that sends its next read only when the
last one has been answered, ``session.run([q])`` one query at a time, as a
caller that asks once per graph version does.

A read's latency runs from the call to its return.  The window closes
with the first answer at or after ``seconds``; its length is the time to
that answer, so that the rate counts all the work and all the time.
The traffic file gives ``reads``, the number drawn (sent in turn, from
the first again when they run out), ``mix`` and ``pairs``.
"""
from __future__ import annotations

import time
from typing import List

from bench.data import generate as gen
from bench.record import ReadRec


def query_of(r):
    from repro_torch import Dist, Reach, Rpq
    if r.kind == "reach":
        return Reach(r.s, r.t)
    if r.kind == "dist":
        return Dist(r.s, r.t)
    if r.kind == "rpq":
        return Rpq(r.s, r.t, regex=r.regex)
    return Dist(r.s, r.t, bound=r.bound)


def value_of(kind: str, res):
    return res.distance if kind == "dist" else res.answer


def prepare(system, traffic: dict, seed: int, seconds: float):
    reads = gen.make_reads(system.graph.n, traffic["reads"], traffic, seed,
                           system.cell.bench_dir)
    return reads, [query_of(r) for r in reads]


def drive(system, plan, seconds: float, clock=time.monotonic):
    """Call ``session.run`` on the reads in turn until ``seconds`` have
    passed.  Returns ``(t0, t_end, give_up, read_recs, [])``."""
    reads, queries = plan
    session = system.session
    recs: List[ReadRec] = []
    t0 = clock()
    now = t0
    i = 0
    while now < t0 + seconds:
        r = reads[i % len(reads)]
        rec = ReadRec(r, now, now)
        try:
            res = session.run([queries[i % len(reads)]])[0]
        except Exception as exc:        # attempted and failed
            rec.error = f"{type(exc).__name__}: {exc}"
        else:
            rec.ok = res.status == "done"
            rec.value = value_of(r.kind, res)
            rec.version = 0
        now = rec.done = clock()
        recs.append(rec)
        i += 1
    return t0, now, now, recs, []
