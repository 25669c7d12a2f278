"""The comparison that decides ``correct``: every read of the window
against the plain reference (:mod:`bench.reference.bfs`, and
:mod:`bench.reference.rpq` for regular path queries) at the version of the
graph the read was answered from, and the guarantees the configuration
states.

Numbers compared, each with its limit (an exact comparison: limit 0):

* ``wrong_answers``: answered reads whose answer differs from the
  reference's (reach a bool, dist the hop count or None for unreachable,
  bounded a bool, rpq a bool), or whose version stamp names no version of
  the graph;
* ``unanswered_reads``: reads that failed, were refused or never came;
* ``failed_deltas``: deltas whose version was not committed;
* ``stale_reads``: reads answered from a version older than one whose
  commit the server had confirmed before the read was sent (MVCC's
  guarantee that a committed delta is visible to every later read).

A control (:func:`controlled`) is the plain reference, with one guarantee
broken, put in the program's place: a copy of the run whose answers are
the control's, judged by :func:`judge` as the program's are.
``depth_cap`` stops the search one level short of the deepest level the
window's reads need (a fixpoint cut short by one step: for an rpq read,
the product search one edge short of the longest shortest accepted path
that a True answer needs); ``stale`` answers
each read from the version before the one it names (a read that misses the
last commit).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional

from .reference import bfs, rpq

LIMITS = {"wrong_answers": 0, "unanswered_reads": 0, "failed_deltas": 0,
          "stale_reads": 0}


def same(kind: str, got, want) -> bool:
    """``got`` equals ``want`` as an answer of ``kind``: a dist is an int
    (not a bool) or None, a reach, bounded or rpq answer a bool."""
    if kind == "dist":
        if want is None or got is None:
            return got is None and want is None
        return (not isinstance(got, bool) and isinstance(got, int)
                and got == want)
    return isinstance(got, bool) and got == want


def _graph_deltas(run) -> List[tuple]:
    """The committed deltas in the order they were sent, each ``(inserted
    edges, deleted edges)``: the versions of the graph (a delta that failed
    made none)."""
    return [(d.delta.inserts, d.delta.deletes)
            for d in run.warm_deltas + run.deltas if d.ok]


def reference_distances(run, device, versions=None,
                        max_depth: Optional[int] = None
                        ) -> List[Optional[int]]:
    """Each answered read's hop distance at ``versions`` (default: the
    versions the reads name), for an rpq read the length of its shortest
    accepted path (:func:`bench.reference.rpq.lengths`); -1 where there
    is none, None for a read not answered."""
    g = run.graph
    answered = [r for r in run.reads if r.ok]
    vs = [r.version for r in answered] if versions is None else versions
    deltas = _graph_deltas(run)
    out: List[Optional[int]] = [None] * len(answered)
    for regular in (False, True):
        idx = [i for i, r in enumerate(answered)
               if (r.read.kind == "rpq") == regular]
        if not idx:
            continue
        search = rpq.lengths if regular else bfs.distances
        args = (g.labels,) if regular else ()
        got = search(g.n, g.src, g.dst, *args, deltas,
                     [answered[i].read for i in idx], [vs[i] for i in idx],
                     device, max_depth)
        for i, d in zip(idx, got):
            out[i] = d
    it = iter(out)
    return [next(it) if r.ok else None for r in run.reads]


def answer(read, d: int):
    """What ``read`` answers when the reference reads ``d``: an rpq read
    whether an accepted path exists, the others as
    :func:`bench.reference.bfs.answer` says."""
    if read.kind == "rpq":
        return d >= 0
    return bfs.answer(read.kind, d, read.bound)


def judge(run, device) -> Dict[str, Dict[str, int]]:
    """Every number compared, with its limit."""
    dist = reference_distances(run, device)
    wrong = 0
    for r, d in zip(run.reads, dist):
        if not r.ok:
            continue
        if d is None or not same(r.read.kind, r.value, answer(r.read, d)):
            wrong += 1
    return _checks(run, wrong)


def _checks(run, wrong: int) -> Dict[str, Dict[str, int]]:
    commits = sorted(d.done for d in run.warm_deltas + run.deltas
                     if d.ok and d.done is not None)
    stale = 0
    for r in run.reads:
        if r.ok and r.version is not None:
            stale += r.version < bisect.bisect_left(commits, r.sent)
    values = {"wrong_answers": wrong,
              "unanswered_reads": sum(1 for r in run.reads if not r.ok),
              "failed_deltas": sum(1 for d in run.warm_deltas + run.deltas
                                   if not d.ok),
              "stale_reads": stale}
    return {k: {"value": int(v), "limit": LIMITS[k]}
            for k, v in values.items()}


def correct(checks: Dict[str, Dict[str, int]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def controlled(run, device, which: str):
    """A copy of ``run`` in which control ``which`` answered every read
    the program answered, at the version the program's answer names."""
    exact = reference_distances(run, device)
    if which == "depth_cap":
        # the deepest level an answer depends on: a bounded read's only
        # where its distance is within the bound
        deepest = max((d for r, d in zip(run.reads, exact) if d is not None
                       and (r.read.kind != "bounded" or d <= r.read.bound)),
                      default=0)
        ctl = reference_distances(run, device, max_depth=max(deepest - 1, 0))
    elif which == "stale":
        answered = [r for r in run.reads if r.ok]
        ctl = reference_distances(
            run, device,
            versions=[max((r.version or 0) - 1, 0) for r in answered])
    else:
        raise ValueError(f"unknown control {which!r}")
    reads = [r if not r.ok or d is None else dataclasses.replace(
                 r, value=answer(r.read, d))
             for r, d in zip(run.reads, ctl)]
    return dataclasses.replace(run, reads=reads)
