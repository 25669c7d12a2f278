"""MVCC snapshot store: immutable ``(Fragmentation, RvsetCache)`` versions
with copy-on-write deltas and repair that runs beside the readers.

``session.apply`` mutates the head fragmentation in place, so every delta
is a barrier: no query may overlap the repair.  This module removes the
barrier by making a delta produce a **new version** instead:

* a :class:`Version` is a published snapshot; nothing mutates its
  ``fr`` or its cache after publication, so any number of readers run
  against it once they have pinned it;
* :func:`cow_clone` builds the next version from the head by copying only
  what ``apply_delta`` can write into (the padded-headroom design keeps
  every array's shape, so the copy is a handful of small host arrays: the
  edge lists always, the stub and boundary family only for cross-edge
  deltas) and sharing everything else by reference, the cache's device
  tensors included.  A repair binds new tensors and writes into none that
  a cache holds (:mod:`repro_torch.core.incremental`), and
  ``refresh_device_arrays`` binds a new dict, so an older version never
  sees a tensor change under it;
* :meth:`VersionedCacheStore.commit_delta` repairs the private clone,
  holding the session lock only while it clones, and publishes the result
  as the new head.  Readers that pinned an older version keep it alive
  until they release it; a failed repair is dropped (the head was never
  touched), with no snapshot to restore.

Consistency: readers always pin the head, the latest fully repaired
version (monotonic reads); a delta becomes visible exactly when its
repair publishes.  ``UpdateFuture.result()`` is the commit point.

On the card, a version costs what its repair binds anew: the Boolean
closure and its K-major copy (2 nb^2 bytes), the distance closure (4 nb^2
bytes) and the two frontier matrices ([nb, n_max+1], 1 and 4 bytes an
entry); it shares the rest.  Resident at once are the store's
``capacity`` versions, the clone being repaired, and the session's own
version once the store has let it go (the session holds it): at most
``capacity + 2`` of them, whatever the readers pin, unless every version
the store holds but the head is pinned.  The repair's own scratch at
that moment is the Boolean update's ``[r, nb]`` operands
(:func:`incremental._repair_insert`), r the changed rows.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..errors import DeltaApplyFailed
from . import incremental
from .cache import RvsetCache
from .fragments import Fragmentation, GraphDelta

# fr.arrays keys apply_delta may mutate, by delta shape.  Deletions and
# intra-fragment insertions only rewrite edge slots; cross-fragment
# insertions can also activate boundary slots and virtual stubs.
_COW_ALWAYS = ("esrc", "edst")
_COW_CROSS = incremental._CROSS_TOUCHED


def touched_array_names(fr: Fragmentation, delta: GraphDelta) -> set:
    """Upper bound, before the delta runs, on the ``fr.arrays`` keys that
    applying ``delta`` to ``fr`` can mutate: what :func:`cow_clone` must
    copy (the exact set, after the fact, is
    :func:`incremental.touched_arrays`)."""
    names = set(_COW_ALWAYS)
    if delta.n_add and bool(np.any(fr.part[delta.add_src]
                                   != fr.part[delta.add_dst])):
        names.update(_COW_CROSS)
    return names


def _clone_cache(clone_fr: Fragmentation,
                 base: Optional[RvsetCache]) -> Optional[RvsetCache]:
    """The clone's cache: every field of ``base`` (device, closures and
    their K-major copies, frontiers, version, debt), every tensor shared
    by reference, so that no tensor is copied.  The three dicts are copied:
    a refresh rebinds ``arrays``, but ``product_closure_kmajor`` reorders
    and evicts ``rpq_closures``/``rpq_closures_t`` in place."""
    if base is None:
        return None
    return dataclasses.replace(
        base, fr=clone_fr, arrays=dict(base.arrays),
        rpq_closures=dict(base.rpq_closures),
        rpq_closures_t=dict(base.rpq_closures_t))


def cow_clone(fr: Fragmentation, delta: GraphDelta) -> Fragmentation:
    """Copy-on-write clone of ``fr`` that ``delta`` can be applied to
    without the base ever observing a change.

    Copied: the delta-touched ``arrays`` (:func:`touched_array_names`) and
    every host bookkeeping array ``apply_delta`` mutates in place
    (``b_index``, ``frag_sizes``, ``n_edges``, ``src_fill``, ``stubs``,
    ``_slot_of``).  Shared by reference: the graph, the partition, the
    untouched arrays, and the fields that are only ever rebound (``bnodes``
    grows by ``np.append``, ``g`` is replaced whole).

    ``dataclasses.replace`` (not ``copy.copy``), so that the clone's
    ``__dict__`` holds dataclass fields only: the memoized default sessions
    and sharded device uploads stay with the base, and the clone's first
    sharded batch uploads its own arrays."""
    touched = touched_array_names(fr, delta)
    arrays = {k: (v.copy() if k in touched else v)
              for k, v in fr.arrays.items()}
    if tracing.ON:
        tracing.count("mvcc.clone_bytes", sum(
            x.nbytes for x in (*(arrays[k] for k in touched if k in arrays),
                               fr.b_index, fr.frag_sizes, fr._slot_of,
                               fr.n_edges, fr.src_fill) if x is not None))
    clone = dataclasses.replace(
        fr, arrays=arrays,
        b_index=fr.b_index.copy(),
        frag_sizes=fr.frag_sizes.copy(),
        rvset_cache=None,
        _slot_of=None if fr._slot_of is None else fr._slot_of.copy(),
        n_edges=None if fr.n_edges is None else fr.n_edges.copy(),
        src_fill=None if fr.src_fill is None else fr.src_fill.copy(),
        stubs=None if fr.stubs is None else [dict(s) for s in fr.stubs])
    clone.rvset_cache = _clone_cache(clone, fr.rvset_cache)
    return clone


def _new_device_bytes(fr: Fragmentation, base: Fragmentation) -> int:
    """Device bytes that ``fr``'s cache holds and ``base``'s does not: what
    one version costs beyond the version it was cloned from (a repair
    binds new closures, frontiers and arrays, and shares the rest)."""
    seen = {t.untyped_storage().data_ptr()
            for t in _cache_tensors(base.rvset_cache)}
    total = 0
    for t in _cache_tensors(fr.rvset_cache):
        storage = t.untyped_storage()
        if storage.data_ptr() not in seen:
            seen.add(storage.data_ptr())
            total += storage.nbytes()
    return total


def _cache_tensors(cache: Optional[RvsetCache]):
    """Every tensor a cache holds (none without a cache)."""
    if cache is None:
        return
    for v in (cache.closure, cache.closure_t, cache.bl_frontier,
              cache.bl_dist, cache.dist_closure,
              *cache.arrays.values(), *cache.rpq_closures.values(),
              *cache.rpq_closures_t.values()):
        if isinstance(v, torch.Tensor):
            yield v


@dataclasses.dataclass
class Version:
    """One published snapshot.  ``pins`` counts the readers (query chunks)
    running against it; the store never reclaims a pinned version."""

    vid: int
    fr: Fragmentation
    pins: int = 0
    retired: bool = False     # dropped: reclaimed once unpinned

    @property
    def cache_version(self) -> Optional[int]:
        """The snapshot id that results computed against this version
        carry."""
        c = self.fr.rvset_cache
        return None if c is None else c.version


class VersionedCacheStore:
    """Keeps the last few versions live over one
    :class:`~repro_torch.core.session.QuerySession`.

    * :meth:`acquire_head` / :meth:`release` pin a reader to the head for
      the duration of one batch;
    * :meth:`commit_delta` clones the head copy-on-write, repairs the clone
      while readers go on (the session lock is held only for the clone),
      and publishes it as the new head, or drops it on failure;
    * :meth:`drop` retires a version explicitly (rollback by drop);
    * capacity eviction reclaims the oldest **unpinned, non-head** versions
      beyond ``capacity``; pinned versions persist until their readers
      drain, so the store can exceed its capacity for a while.

    Reclaiming a version also detaches its cache from its fragmentation:
    the two point at each other, so without that the version's tensors
    would wait for the cycle collector; with it they go back to the
    allocator at once (tensors a newer version shares stay with it).  The
    session's own ``fr`` (version 0) keeps its cache: the session holds
    it.

    Commits are serialized by ``_repair_lock`` (deltas are ordered);
    bookkeeping is guarded by ``_lock``.  The lock order is always
    ``_repair_lock -> session._lock (briefly) -> _lock``, and readers take
    only ``session._lock`` and ``_lock``, so the store adds no deadlock.
    """

    def __init__(self, session, capacity: int = 4):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.session = session
        self.capacity = capacity
        self._lock = threading.Lock()
        self._repair_lock = threading.Lock()
        self._versions: "OrderedDict[int, Version]" = OrderedDict()
        self._versions[0] = Version(0, session.fr)
        self._head_vid = 0
        self._next_vid = 1
        self.committed = 0       # deltas published as new versions
        self.dropped = 0         # versions dropped (failed repair, drop())
        self.evicted = 0         # unpinned versions reclaimed by capacity

    # -- readers ------------------------------------------------------------

    def head(self) -> Version:
        with self._lock:
            return self._versions[self._head_vid]

    def acquire_head(self) -> Version:
        """Pin the head snapshot for one reader; pair with :meth:`release`."""
        with self._lock:
            ver = self._versions[self._head_vid]
            ver.pins += 1
            return ver

    def release(self, ver: Version) -> None:
        with self._lock:
            if ver.pins <= 0:
                raise RuntimeError(f"version {ver.vid} released more often "
                                   "than it was pinned")
            ver.pins -= 1
            self._reclaim()

    def live(self):
        """The live (not retired) versions, oldest first."""
        with self._lock:
            return [v for v in self._versions.values() if not v.retired]

    # -- writers ------------------------------------------------------------

    def commit_delta(self, delta: GraphDelta
                     ) -> Tuple[Version, incremental.UpdateStats]:
        """Apply ``delta`` as a new version and publish it as the head.

        The head is pinned while its clone is cut and repaired; the session
        lock is held only for the clone (a few small host copies), so
        readers wait at most that long and never for the repair.  A failed
        repair raises :class:`~repro_torch.errors.DeltaApplyFailed` and
        leaves the head untouched: the clone is dropped."""
        with self._repair_lock:
            base = self.acquire_head()
            try:
                if delta.is_empty():
                    return base, incremental.UpdateStats(mode="noop")
                with tracing.span("mvcc.clone") as sp:
                    with self.session._lock:
                        work_fr = cow_clone(base.fr, delta)
                    if tracing.ON:
                        sp.set(**self._sizes(clone=1))
                try:
                    stats = self.session.repair_on(work_fr, delta)
                except Exception as exc:
                    with self._lock:
                        self.dropped += 1
                    self.session.stats.rollbacks += 1
                    raise DeltaApplyFailed(exc) from exc
                with tracing.span("mvcc.publish") as sp:
                    with self._lock:
                        ver = Version(self._next_vid, work_fr)
                        self._next_vid += 1
                        self._versions[ver.vid] = ver
                        self._head_vid = ver.vid
                        self.committed += 1
                        self._reclaim()
                    if tracing.ON:
                        sp.set(**self._sizes())
                        tracing.count("mvcc.version_bytes",
                                      _new_device_bytes(work_fr, base.fr))
                return ver, stats
            finally:
                self.release(base)

    def drop(self, vid: int) -> None:
        """Retire version ``vid`` (rollback by drop).  Pinned readers keep
        their snapshot until they release it; if the head is dropped, the
        newest remaining live version becomes the head.  The last live
        version cannot be dropped: reads must have a head to pin."""
        with self._lock:
            ver = self._versions.get(vid)
            if ver is None or ver.retired:
                raise KeyError(f"no live version {vid}")
            live = [v for v in self._versions.values() if not v.retired]
            if len(live) == 1:
                raise ValueError(
                    f"cannot drop version {vid}: it is the last live "
                    "version (reads must have a head to pin)")
            ver.retired = True
            self.dropped += 1
            if vid == self._head_vid:
                for v in reversed(self._versions.values()):
                    if not v.retired:
                        self._head_vid = v.vid
                        break
            self._reclaim()

    def _reclaim(self) -> None:
        """(lock held) Delete retired versions whose readers drained, then
        evict the oldest unpinned non-head versions beyond capacity."""
        for vid in [v.vid for v in self._versions.values()
                    if v.retired and v.pins == 0]:
            self._forget(vid)
        while len(self._versions) > self.capacity:
            victim = next((v for v in self._versions.values()
                           if v.vid != self._head_vid and v.pins == 0), None)
            if victim is None:
                break       # everything pinned: over capacity until drained
            self._forget(victim.vid)
            self.evicted += 1

    def _sizes(self, clone: int = 0) -> dict:
        """The tracing attributes of a clone or a publish: ``n``, the
        versions the store holds (with ``clone``, the one being repaired,
        counted in), and ``size``, the versions whose caches are resident
        (``n``, and the session's own version once the store let it go)."""
        with self._lock:
            n = len(self._versions) + clone
            held = any(v.fr is self.session.fr
                       for v in self._versions.values())
        return {"n": n, "size": n + (not held)}

    def _forget(self, vid: int) -> None:
        """(lock held) Drop version ``vid`` and break its fr <-> cache
        cycle, so that its tensors are freed now (see the class
        docstring)."""
        ver = self._versions.pop(vid)
        if ver.fr is not self.session.fr:
            ver.fr.rvset_cache = None

    # -- observability ------------------------------------------------------

    def gauges(self) -> dict:
        """Live MVCC gauges for :meth:`QueryServer.telemetry`."""
        with self._lock:
            return dict(
                live_versions=len(self._versions),
                head_vid=self._head_vid,
                pinned_readers={v.vid: v.pins
                                for v in self._versions.values() if v.pins},
                versions_committed=self.committed,
                versions_dropped=self.dropped,
                versions_evicted=self.evicted)
