"""Spans and counters inside the port, on the host's monotonic clock.

Off by default.  A site in the program is one of::

    with tracing.span("cache.inputs"):          # a unit of host work
        ...
    tracing.count("host.syncs")                 # a count, n=1 by default
    tracing.wait("serve.queue_wait", t0_ns, t1_ns, request_id)

Off, a site is one call that reads the module flag :data:`ON` and returns
(a span site gets a shared no-op context manager): no clock is read, no
record made, no lock taken and nothing waits for the device.

On (:func:`enable`), a span records its name, its start and end on
``time.monotonic_ns()`` (the clock ``bench/trace.py`` maps onto the device
trace), the thread's CPU time over it (``time.thread_time_ns()``: wall
minus CPU is time off the CPU, a wait for the GIL, a lock, a sleep or a
blocking device read, though a CUDA sync may spin), its own id, the id of
the span open around it on the same thread, the id of the request or batch
it serves, a few attributes, and its counts.  A count adds to the
innermost span open on its thread, and a span adds its counts to that of
its parent when it closes, so that the top span of a batch or a query
holds the totals of everything under it.  A ``wait`` records an interval
in which a request waited, not host work.

Records go into per-thread lists with no lock: :func:`drain` takes what
each list holds and leaves what is appended meanwhile.  :func:`enable`
starts afresh, dropping what was not drained.

A span's attributes may also be given once its work is done, from the
object the ``with`` statement binds (a no-op while off)::

    with tracing.span("repair.apply") as sp:
        stats = ...
        sp.set(kind=stats.mode)

Counter names: ``host.syncs`` (a blocking read of the device: a
``torch.equal``, ``bool(t.any())``, ``torch.nonzero``, ``.cpu()``, a
Python number of a tensor), ``fixpoint.steps`` (an iteration of a host
fixpoint loop of :mod:`repro_torch.core.engine`), ``h2d.pageable_bytes``
(bytes copied onto the device from host arrays by ``torch.tensor``, a
copy from pageable memory on the card), ``closure.squarings`` (a
squaring of a Boolean or min-plus closure, one launch on the card),
``evaldg.rows`` and ``evaldg.levels`` (the rows of W a dist or bounded
evalDG read and the distance levels it settled before it stopped); in
the repair lane ``repair.rows`` (the changed boundary rows a repair
pushes through the closures), ``repair.launches`` (the rank updates'
or-and and min-plus products other than their closures' squarings, one
launch each on the card), ``mvcc.clone_bytes`` (host bytes a
copy-on-write clone copies) and ``mvcc.version_bytes`` (device bytes a
published version holds that the version it was cloned from does not).
"""
from __future__ import annotations

import itertools
import threading
import time
import types
from typing import Dict, List, Mapping, NamedTuple, Optional

#: whether sites record; flipped by :func:`enable` and :func:`disable`
ON = False


class _Off:
    """What a span site gives while the recorder is off: enters, sets and
    exits doing nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()
# shared by every record without attributes or counts: a record makes as
# few objects as it can for the collector to scan
_EMPTY: Mapping = types.MappingProxyType({})
_ids = itertools.count(1)
_epoch = 0                      # bumped by enable(): stale thread lists
_lists: List[list] = []         # every thread's record list this epoch


class Record(NamedTuple):
    """One drained record."""

    kind: str           # "span", "wait", or "count" (a count outside spans)
    name: str
    id: int             # a span's own id; a wait's request id; 0
    parent: int         # the span open around it on its thread, 0 if none
    serves: int         # the batch or query it serves: its top span's id
    thread: int         # threading.get_ident()
    start_ns: int       # time.monotonic_ns(); 0 for a count
    end_ns: int
    cpu_ns: int         # the thread's CPU time over a span; 0 otherwise
    attrs: Mapping[str, object]
    counts: Mapping[str, int]

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Thread(threading.local):
    epoch = -1
    records: Optional[list] = None
    stack: Optional[list] = None
    ident = 0


_here = _Thread()


def _thread() -> _Thread:
    """This thread's lists, registered once an epoch."""
    t = _here
    if t.epoch != _epoch:
        t.records, t.stack = [], []
        t.ident = threading.get_ident()
        t.epoch = _epoch
        _lists.append(t.records)            # list.append is atomic
    return t


class _Span:
    __slots__ = ("name", "id", "parent", "serves", "attrs", "counts",
                 "t0", "c0", "stack", "records", "thread")

    def __init__(self, name: str, attrs: Mapping[str, object]):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.counts: Optional[Dict[str, int]] = None    # made on a count

    def __enter__(self) -> "_Span":
        here = _thread()
        # the lists of this epoch: an enable() while the span is open
        # gives the thread new ones, and the span closes into its own
        self.stack, self.records, self.thread = (here.stack, here.records,
                                                 here.ident)
        top = self.stack[-1] if self.stack else None
        self.parent, self.serves = ((top.id, top.serves) if top is not None
                                    else (0, self.id))
        self.stack.append(self)
        self.c0 = time.thread_time_ns()
        self.t0 = time.monotonic_ns()
        return self

    def set(self, **attrs) -> None:
        """Add or replace attributes, kept in the record when the span
        closes."""
        self.attrs = dict(self.attrs, **attrs)

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic_ns()
        c1 = time.thread_time_ns()
        stack = self.stack
        stack.pop()
        counts = self.counts
        if counts and stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = dict(counts)
            else:
                for k, v in counts.items():
                    top.counts[k] = top.counts.get(k, 0) + v
        self.records.append(Record(
            "span", self.name, self.id, self.parent, self.serves,
            self.thread, self.t0, t1, c1 - self.c0, self.attrs,
            counts or _EMPTY))
        return False


def span(name: str, kind: object = None, n: object = None,
         size: object = None):
    """A context manager that records one span (see the module
    docstring); ``kind``, ``n``, ``size``: attributes, kept where given."""
    if not ON:
        return _OFF
    if kind is None and n is None and size is None:
        return _Span(name, _EMPTY)
    return _Span(name, {k: v for k, v in (("kind", kind), ("n", n),
                                           ("size", size)) if v is not None})


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span of this
    thread (a record of its own outside any span)."""
    if not ON:
        return
    here = _thread()
    if here.stack:
        top = here.stack[-1]
        if top.counts is None:
            top.counts = {name: n}
        else:
            top.counts[name] = top.counts.get(name, 0) + n
    else:
        here.records.append(Record("count", name, 0, 0, 0, here.ident, 0, 0,
                                   0, _EMPTY, {name: n}))


def wait(name: str, start_ns: int, end_ns: int, id: int) -> None:
    """Record that request ``id`` waited from ``start_ns`` to ``end_ns``
    (``time.monotonic_ns()``), under the innermost open span of this
    thread."""
    if not ON:
        return
    here = _thread()
    top = here.stack[-1] if here.stack else None
    here.records.append(Record(
        "wait", name, id, top.id if top is not None else 0,
        top.serves if top is not None else id, here.ident, start_ns, end_ns,
        0, _EMPTY, _EMPTY))


def enable() -> None:
    """Start recording afresh: records not drained are dropped."""
    global ON, _epoch, _lists
    _lists = []
    _epoch += 1
    ON = True


def disable() -> None:
    """Stop recording; spans open now still record when they close."""
    global ON
    ON = False


def drain() -> List[Record]:
    """Every record made since :func:`enable` or the last drain, by start
    time, taken out of the thread lists."""
    out: List[Record] = []
    for records in list(_lists):
        n = len(records)
        out.extend(records[:n])
        del records[:n]                 # appends meanwhile land after n
    out.sort(key=lambda r: r.start_ns)
    return out
