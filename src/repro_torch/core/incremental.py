"""Incremental rvset-cache maintenance for dynamic graphs.

The paper's guarantees hold for a static fragmentation; the amortized
cache pays off because real workloads re-query one graph, and real graphs
change between queries.  This module keeps the cached structures of
:mod:`repro_torch.core.cache` valid under edge updates without rebuilding
them from scratch:

* **insertions** are monotone, so the cached state is reusable twice over:
  the dirty fragments' all-sources fixpoints resume from the cached
  frontiers (``engine.resume_frontier_*`` converge in O(new-path length)
  steps instead of O(diam)), and the changed rows of the boundary matrix
  ``D0`` go through the cached closure by a rank-style semiring update: a
  closure over the r x r block of changed rows instead of the whole
  |V_f| x |V_f| matrix (:func:`_rank_update_bool` on the or-and kernel,
  :func:`_rank_update_tropical` on the min-plus kernel);
* **cross-edge insertions** grow ``V_f`` into the spare boundary slots
  that ``fragment_graph(reserve_boundary=...)`` set aside, so no tensor
  changes shape;
* **deletions** are not monotone, so the dirty fragments' frontiers are
  recomputed cold and the closures rebuilt from ``D0`` (mostly cached
  rows); a debt counter decides when enough deletions have piled up that a
  full rebuild (which also compacts stale boundary slots and stubs) is
  cheaper than further repair.

Correctness of the rank-style update: let ``R`` be the changed rows and
``T = D0'[R] (x) C`` (one possibly-new hop out of R, then old paths).  Any
path in the updated dependency graph splits at its uses of R-row edges
into ``u --C--> r_1 --T--> r_2 --T--> ... --T--> v``, so with
``M = T[:, R]`` and ``M*`` its closure,

    C' = C  |  C[:, R] (x) M* (x) T          (Boolean; min-plus alike)

exact for monotone updates because old entries stay valid bounds.  The
changed rows are padded to ``ROW_PAD`` buckets, as in the reference
package, so the repair products come in a few shapes.

Every repair binds new tensors and writes into none that the cache holds:
``QuerySession.apply`` rolls a failed delta back by restoring references
(``RvsetCache.snapshot``), which is only sound while no old tensor changes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..kernels.bool_matmul.ops import (kmajor_copy, or_and_floor_pair,
                                       or_and_matmul_nt, padded)
from ..kernels.tropical_matmul.ops import min_plus_matmul, padded_i32
from . import bes, engine
from .cache import (_gather_boundary_matrix, _to_host, _upload,
                    prepare_rvset_cache)
from .engine import INF
from .fragments import Fragmentation, GraphDelta

ROW_PAD = 64                 # changed-row padding bucket
RECOMPUTE_DIRTY_FRAC = 0.5   # most fragments dirty -> recompute beats repair
DEBT_PER_RECOMPUTE = 0.5     # deletion-recompute cost, in full-rebuild units
REBUILD_DEBT = 4.0           # accumulated debt that triggers a full rebuild


@dataclasses.dataclass
class UpdateStats:
    """What one :func:`apply_delta` call did to the fragmentation + cache."""

    mode: str                # noop | structural | repair | recompute | rebuild
    n_add_intra: int = 0
    n_add_cross: int = 0
    n_del: int = 0
    dirty_fragments: int = 0
    new_boundary: int = 0
    changed_rows: int = 0
    reason: str = ""


def _stats_base(report) -> dict:
    return dict(n_add_intra=report.n_add_intra,
                n_add_cross=report.n_add_cross, n_del=report.n_del,
                dirty_fragments=int(report.dirty.sum()),
                new_boundary=len(report.new_boundary))


# fragment arrays a cross-edge insertion can mutate beyond the edge lists:
# _ensure_boundary touches src_local/src_row, _ensure_stub touches
# gids/labels/tgt_local/n_local (Fragmentation.apply_delta)
_CROSS_TOUCHED = ("src_local", "src_row", "gids", "labels", "tgt_local",
                  "n_local")


def touched_arrays(report) -> set:
    """``fr.arrays`` keys the applied delta mutated, from its
    :class:`~repro_torch.core.fragments.DeltaReport`: what
    :meth:`RvsetCache.refresh_device_arrays` uploads.  Intra-fragment edges
    and deletions rewrite only the edge lists; cross insertions also grow
    stubs and sources (``_CROSS_TOUCHED``)."""
    names = {"esrc", "edst"}
    if report.n_add_cross:
        names.update(_CROSS_TOUCHED)
    return names


def rebuild_cache(fr: Fragmentation, old_version: int, report,
                  with_dist: bool, device, reason: str = "") -> UpdateStats:
    """Drop the cache and build it anew on ``device`` from the current
    fragmentation.  The version stays monotone across rebuilds (results
    are stamped with it)."""
    fr.rvset_cache = None
    fresh = prepare_rvset_cache(fr, device, with_dist=with_dist)
    fresh.version = old_version + 1
    return UpdateStats(mode="rebuild", reason=reason, **_stats_base(report))


def apply_delta(fr: Fragmentation, delta: GraphDelta,
                chaos=None) -> UpdateStats:
    """Apply ``delta`` to ``fr`` and repair its rvset cache incrementally,
    on the cache's device.

    Afterwards the attached cache (if any) answers as one rebuilt from
    scratch would.  An empty delta is a strict no-op (the cache keeps its
    tensors).  The mode follows the reference package: ``structural`` with
    no cache; ``rebuild`` when a reserve ran out or deletions piled up
    ``REBUILD_DEBT``; ``recompute`` for deletions, or insertions that dirty
    more than ``RECOMPUTE_DIRTY_FRAC`` of the fragments; ``repair`` (the
    rank-style update) otherwise.

    ``chaos`` is any object with a ``maybe_fail(site)`` method; it is
    consulted at the ``"delta.repair"`` site after the host arrays have
    mutated, so an injected failure leaves the fragmentation mid-update,
    and the caller (``QuerySession.apply``) rolls back through
    :meth:`Fragmentation.snapshot` / ``restore``.
    """
    if delta.is_empty():
        return UpdateStats(mode="noop")
    cache = fr.rvset_cache
    with_dist = cache is not None and cache.bl_dist is not None
    report = fr.apply_delta(delta)
    if chaos is not None:
        chaos.maybe_fail("delta.repair")
    base = _stats_base(report)
    if cache is None:
        return UpdateStats(mode="structural", **base)
    if report.rebuilt:
        return rebuild_cache(fr, cache.version, report, with_dist,
                             cache.device, reason=report.reason)

    dirty_frac = float(report.dirty.mean())
    if report.n_del:
        cache.repair_debt += DEBT_PER_RECOMPUTE + 0.5 * dirty_frac
        if cache.repair_debt >= REBUILD_DEBT:
            fr.rebuild()
            return rebuild_cache(fr, cache.version, report, with_dist,
                                 cache.device, reason="repair debt")
        _recompute(cache, report.dirty, warm=False)
        _refresh(cache, report)
        return UpdateStats(mode="recompute", **base)
    if dirty_frac > RECOMPUTE_DIRTY_FRAC:
        # insert-only but wide: the changed rows are most of the matrix,
        # so a warm-started recompute beats the rank update
        _recompute(cache, report.dirty, warm=True)
        _refresh(cache, report)
        return UpdateStats(mode="recompute", **base)
    changed = _repair_insert(cache, report.dirty)
    _refresh(cache, report)
    return UpdateStats(mode="repair", changed_rows=changed, **base)


def _refresh(cache, report) -> None:
    """Upload the arrays the delta touched (:func:`touched_arrays`)."""
    with tracing.span("repair.refresh"):
        cache.refresh_device_arrays(touched_arrays(report))


# ---------------------------------------------------------------------------
# frontier maintenance (dirty fragments, warm- or cold-started)
# ---------------------------------------------------------------------------

def _frontier_init(fr: Fragmentation, frags: np.ndarray, warm_rows,
                   dist: bool, device):
    """[F, S, n_max+1] initial state of the all-sources fixpoints of the
    fragments ``frags``: each owned source row starts from the cached
    boundary row ``warm_rows`` (a device tensor; insert-only deltas leave
    the old fixpoint a valid start) or, cold (``None``), from nothing; its
    own source slot is set either way.  Also returns the (fragment, row)
    indices of the owned source rows and their boundary positions."""
    src_local = fr.arrays["src_local"][frags]             # [F, S]
    src_row = fr.arrays["src_row"][frags]
    fi, si = np.nonzero(src_row < fr.B - 2)
    bpos = _upload(src_row[fi, si], device, torch.long)
    fi_t, si_t = (_upload(x, device, torch.long) for x in (fi, si))
    slot = _upload(src_local[fi, si], device, torch.long)
    shape = (len(frags), fr.s_max, fr.n_max + 1)
    if dist:
        init = torch.full(shape, INF, dtype=torch.int32, device=device)
    else:
        init = torch.zeros(shape, dtype=torch.bool, device=device)
    if warm_rows is not None:
        init[fi_t, si_t] = warm_rows[bpos]
    init[fi_t, si_t, slot] = 0 if dist else True
    return init, (fi_t, si_t), bpos


def _update_frontiers(cache, dirty: np.ndarray, warm: bool) -> None:
    """Re-run the all-sources fixpoints of the dirty fragments (all of
    them in one batch) and bind new [nb, n_max+1] frontier matrices with
    the refreshed rows: ``index_put``, never in place."""
    fr, dev = cache.fr, cache.device
    frags = np.nonzero(dirty)[0]
    esrc = _upload(fr.arrays["esrc"][frags], dev)
    edst = _upload(fr.arrays["edst"][frags], dev)
    init, owned, bpos = _frontier_init(
        fr, frags, cache.bl_frontier if warm else None, False, dev)
    front = engine.resume_frontier_reach(esrc, edst, init, n_max=fr.n_max)
    cache.bl_frontier = cache.bl_frontier.index_put((bpos,), front[owned])
    if cache.bl_dist is not None:
        init, owned, bpos = _frontier_init(
            fr, frags, cache.bl_dist if warm else None, True, dev)
        front = engine.resume_frontier_dist(esrc, edst, init,
                                            n_max=fr.n_max)
        cache.bl_dist = cache.bl_dist.index_put((bpos,), front[owned])


# ---------------------------------------------------------------------------
# closure maintenance: rank-style update (inserts) / recompute (deletes)
# ---------------------------------------------------------------------------

def changed_row_ids(fr: Fragmentation, dirty: np.ndarray) -> np.ndarray:
    """Active boundary positions whose D0 row may have changed: exactly the
    in-nodes owned by dirty fragments (a fragment's stubs, and so its row
    reads, change only when its own edge list does)."""
    owner = fr.boundary_owner()
    mask = dirty[owner]
    mask[fr.nb_active:] = False            # spare slots own no rows
    return np.nonzero(mask)[0]


def pad_row_ids(row_ids: np.ndarray, pad: int = ROW_PAD,
                cap: int = None) -> np.ndarray:
    """Pad the changed-row set to a bucket size by repeating the first id.
    Duplicate rows are semiring no-ops and keep the repair products' shapes
    in a few buckets.  ``cap`` (the matrix side) bounds the bucket, so a
    small boundary never pays for more rows than the matrix has."""
    r = len(row_ids)
    rp = ((r + pad - 1) // pad) * pad
    if cap is not None:
        rp = min(rp, max(cap, r))
    return np.concatenate([row_ids, np.full(rp - r, row_ids[0], np.int64)])


def gather_rows(fr: Fragmentation, bl, row_ids: np.ndarray):
    """D0 rows ``row_ids`` read out of the frontier matrix ``bl`` (the
    gather of ``cache._gather_boundary_matrix``, cut to those rows; the pad
    column holds the semiring zero, so spare targets read inert).  Rows go
    by owning fragment, each reading that fragment's [nb] stub columns, so
    no [r, nb] index is built."""
    nb, dev = fr.n_boundary, bl.device
    owner = fr.boundary_owner()[row_ids]
    out = torch.empty((len(row_ids), nb), dtype=bl.dtype, device=dev)
    for f in np.unique(owner):
        sel = np.nonzero(owner == f)[0]
        cols = _upload(fr.arrays["tgt_local"][f, :nb], dev, torch.long)
        rows = bl[_upload(row_ids[sel], dev, torch.long)]
        out[_upload(sel, dev, torch.long)] = rows[:, cols]
    return out


def _rank_update_bool(C, Ct, rows_new, idx):
    """C' = C | C[:, R] (x) closure(T[:, R]) (x) T with T = rows_new (x) C;
    exact for monotone row updates (module docstring).  ``Ct`` is C's
    K-major copy C^T; returns the pair (C', C'^T), both in fresh padded
    storage, so later composes read C'^T without a transposition.  C and
    Ct are left as they were (MVCC versions hold them).

    Or-and launches: T [r, nb] and T^T through ``Ct`` in one; the r x r
    closure; ``left = C[:, R] (x) M*`` [nb, r] with ``C[:, R] = Ct[R].T``
    copied K-major once; and one launch of ``left (x) T`` with the floor
    pair (C, Ct), which writes C | P and Ct | P^T with no OR pass after it.
    A K-major ``rows_new`` (padded, as the repair gathers it) is read as
    it is."""
    idx_t = _upload(idx, C.device, torch.long)
    T, Tt = or_and_matmul_nt(rows_new, Ct, with_transpose=True)  # [r, nb]
    Mc, Mct = bes.bool_closure_kmajor(T[:, idx_t])         # [r, r]
    left = or_and_matmul_nt(kmajor_copy(Ct[idx_t].T), Mct)  # [nb, r]
    tracing.count("repair.launches", 3)     # T and T^T, left, floor pair
    return or_and_floor_pair(left, Tt, C, Ct)


def _rank_update_tropical(Cd, rows_new, idx):
    """Min-plus twin of :func:`_rank_update_bool` on the distance closure
    (the kernel clips every product at INF): three min-plus launches and
    the r x r closure.  The last product takes Cd as its floor (``init``)
    and returns C' in fresh padded storage; Cd is left as it was.
    ``C[:, R]`` is gathered into padded storage, so with a padded
    ``rows_new`` no product copies an operand."""
    idx_t = _upload(idx, Cd.device, torch.long)
    T = min_plus_matmul(rows_new, Cd)                      # [r, nb]
    Mc = bes.tropical_closure(T[:, idx_t])
    cols = torch.index_select(Cd, 1, idx_t,
                              out=padded_i32(Cd.shape[0], len(idx_t),
                                             Cd.device))
    left = min_plus_matmul(cols, Mc)                       # [nb, r]
    del cols
    tracing.count("repair.launches", 3)     # T, left, the floored product
    return min_plus_matmul(left, T, init=Cd)


def _repair_insert(cache, dirty: np.ndarray) -> int:
    """Insert-only repair: warm frontier resume + rank-style closure update.

    The candidate rows (every in-node of a dirty fragment) are diffed
    against the pre-update frontiers, and only rows whose D0 entries did
    change go through the closure update: in a dense fragment most
    insertions change few or no boundary rows.  Returns the number of
    changed D0 rows pushed through the closure."""
    fr = cache.fr
    bl_old, bl_d_old = cache.bl_frontier, cache.bl_dist
    with tracing.span("repair.frontiers"):
        _update_frontiers(cache, dirty, warm=True)
    candidates = changed_row_ids(fr, dirty)
    if fr.n_boundary == 0 or candidates.size == 0:
        return 0
    with tracing.span("repair.diff"):
        # diff candidate D0 rows old vs new (new stub columns read
        # all-false / INF out of the old frontiers, so freshly activated
        # rows always diff)
        rows_new = gather_rows(fr, cache.bl_frontier, candidates)
        changed = (rows_new != gather_rows(fr, bl_old, candidates)).any(1)
        rows_d_new = None
        if cache.bl_dist is not None:
            rows_d_new = gather_rows(fr, cache.bl_dist, candidates)
            changed |= (rows_d_new != gather_rows(fr, bl_d_old,
                                                  candidates)).any(1)
        changed = _to_host(changed)
    if not changed.any():
        return 0
    sel = np.nonzero(changed)[0]
    padded_sel = pad_row_ids(sel, cap=fr.n_boundary)
    idx = candidates[padded_sel]
    pick = _upload(padded_sel, cache.device, torch.long)
    # only the changed rows go on: the candidates' rows are let go before
    # the updates allocate the new closures, and the distance closure is
    # updated first, so that the repair's peak holds the Boolean update's
    # [r, nb] bytes beside the new version and not the min-plus update's
    # four-times-wider ones (:mod:`repro_torch.core.versions`)
    rows = torch.index_select(rows_new, 0, pick,
                              out=padded(len(pick), fr.n_boundary,
                                         cache.device))
    del rows_new
    if rows_d_new is not None:
        with tracing.span("repair.rank_update", kind="tropical"):
            rows_d = torch.index_select(
                rows_d_new, 0, pick,
                out=padded_i32(len(pick), fr.n_boundary, cache.device))
            del rows_d_new
            cache.dist_closure = _rank_update_tropical(
                cache.dist_closure, rows_d, idx)
            del rows_d
    with tracing.span("repair.rank_update", kind="bool"):
        cache.closure, cache.closure_t = _rank_update_bool(
            cache.closure, cache.closure_t, rows, idx)
    return int(sel.size)


def _recompute(cache, dirty: np.ndarray, warm: bool) -> None:
    """Per-fragment recompute: refresh the dirty fragments' frontiers (cold
    when the delta deletes: the old state over-approximates), then gather
    D0 anew and close it.  The clean fragments' frontier rows, the
    expensive part, are reused as they are."""
    fr = cache.fr
    with tracing.span("repair.frontiers"):
        _update_frontiers(cache, dirty, warm=warm)
    with tracing.span("repair.recompute"):
        owner = fr.boundary_owner()
        D0 = _gather_boundary_matrix(fr, cache.bl_frontier, owner)
        cache.closure, cache.closure_t = bes.bool_closure_kmajor(D0)
        if cache.bl_dist is not None:
            W0 = _gather_boundary_matrix(fr, cache.bl_dist, owner)
            cache.dist_closure = bes.tropical_closure(W0)
