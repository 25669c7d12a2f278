"""Amortized rvset cache + batched multi-query engine.

The paper's guarantees are per query, but a server answers many queries
against the *same* fragmentation, and localEval splits cleanly:

* **query-independent phase** (once per Fragmentation): every fragment's
  all-sources local fixpoint, assembled into the boundary-to-boundary
  dependency matrix ``D0 [|V_f|, |V_f|]`` and closed by repeated squaring
  (``bes.bool_closure_kmajor`` / ``tropical_closure``: the or-and and
  min-plus kernels);
* **per-query phase** (cheap): one single-source propagation from ``s`` in
  its own fragment, a gather of the ``t``-column out of the cached
  frontiers, and one semiring vector-matrix product through the closure.

Correctness identity:

    reach(s, t) = direct(s, t)                                  # local path
                | OR_{u,v in V_f}  sb[u] & C[u, v] & tc[v]

where ``sb[u]`` = s locally reaches the stub of boundary node u, ``C`` is
the reflexive-transitive closure of D0, and ``tc[v]`` = in-node v locally
reaches t.  The tropical and product-automaton variants replace (OR, AND)
with (min, +) and the state-expanded matrix respectively.

Every Boolean closure is kept beside its K-major copy (its transpose,
rows 16-byte aligned), the form in which the or-and kernel takes the right
operand of the compose: ``closure_t`` and ``rpq_closures_t``.  That costs
one more ``side^2`` bytes per closure and saves a transpose per batch.

Every device tensor lives on the cache's ``device``.  Uploads copy
(``torch.tensor``), never alias a host buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..kernels.bool_matmul.ops import kmajor, kmajor_copy, or_and_matmul_nt
from ..kernels.tropical_matmul.ops import min_plus_matmul, padded_i32
from . import bes, engine
from .automaton import QueryAutomaton
from .engine import INF
from .fragments import Fragmentation

NO_NODE = -(2 ** 30)     # gid that matches no L_S / L_T state

MAX_RPQ_CLOSURES = 32    # LRU-evicted: each is an [(nb*Q), (nb*Q)] matrix


# ---------------------------------------------------------------------------
# cache container + construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RvsetCache:
    """Query-independent closures + frontiers for one Fragmentation."""

    fr: Fragmentation
    device: torch.device
    arrays: Dict[str, torch.Tensor]   # fr.arrays uploaded once to device
    bl_frontier: torch.Tensor         # [nb, n_max+1] bool, in-node -> slot
    closure: torch.Tensor             # [nb, nb] bool, reflexive-transitive
    closure_t: torch.Tensor           # [nb, nb] bool, closure.T, K-major
    part_b: np.ndarray                # [nb] owning fragment of boundary node
    bl_dist: Optional[torch.Tensor] = None       # [nb, n_max+1] int32
    dist_closure: Optional[torch.Tensor] = None  # [nb, nb] int32, diag 0
    rpq_closures: Dict[Tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict)         # automaton key -> [(nb*Q), (nb*Q)]
    rpq_closures_t: Dict[Tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict)         # the same keys -> K-major copies
    # incremental-maintenance state (core.incremental)
    version: int = 0                  # snapshot id stamped on results,
                                      # bumped on every repair / recompute
    repair_debt: float = 0.0          # deletion-recompute cost accumulator

    @property
    def nb(self) -> int:
        return self.fr.n_boundary

    def refresh_device_arrays(self, touched=None) -> None:
        """Upload the fragment arrays a delta mutated on the host, and drop
        the cached product closures (they bake in the old arrays; they
        rebuild on the next regular query).

        ``touched`` names the ``fr.arrays`` keys the delta changed
        (``incremental.touched_arrays``); the rest keep their device
        tensors (``None`` uploads all).  A new dict is bound, and every
        upload copies (never aliases the host buffer, which
        ``Fragmentation.apply_delta`` mutates in place), so a snapshot
        taken before the refresh keeps seeing the old tensors."""
        names = self.fr.arrays.keys() if touched is None else touched
        arrays = dict(self.arrays)
        for name in names:
            arrays[name] = _upload(self.fr.arrays[name], self.device)
        self.arrays = arrays
        self.part_b = self.fr.boundary_owner()
        self.rpq_closures, self.rpq_closures_t = {}, {}
        self.version += 1

    # -- rollback snapshots (failed-delta recovery) --------------------------

    _SNAP_FIELDS = ("arrays", "bl_frontier", "closure", "closure_t",
                    "part_b", "bl_dist", "dist_closure", "rpq_closures",
                    "rpq_closures_t", "version", "repair_debt")

    def snapshot(self) -> dict:
        """State capture for rollback.  References suffice for the tensors:
        every repair (``core.incremental``) binds new tensors and never
        writes into one the cache holds, so a snapshot's tensors keep
        their contents.  The dicts are copied."""
        snap = {name: getattr(self, name) for name in self._SNAP_FIELDS}
        snap["arrays"] = dict(self.arrays)
        snap["rpq_closures"] = dict(self.rpq_closures)
        snap["rpq_closures_t"] = dict(self.rpq_closures_t)
        return snap

    def restore(self, snap: dict) -> None:
        for name in self._SNAP_FIELDS:
            setattr(self, name, snap[name])
        self.arrays = dict(snap["arrays"])
        self.rpq_closures = dict(snap["rpq_closures"])
        self.rpq_closures_t = dict(snap["rpq_closures_t"])


def _upload(x, device, dtype=None) -> torch.Tensor:
    """Copy a host array onto ``device`` (never an alias of ``x``), as
    ``dtype`` when given; counted in ``h2d.pageable_bytes``."""
    out = torch.tensor(np.asarray(x), dtype=dtype, device=device)
    tracing.count("h2d.pageable_bytes", out.nbytes)
    return out


def _upload_padded(x, device) -> torch.Tensor:
    """An int32 host matrix copied onto ``device`` into padded storage (rows
    16 bytes apart), the min-plus kernel's operand layout."""
    x = np.asarray(x, dtype=np.int32)
    tracing.count("h2d.pageable_bytes", x.nbytes)
    return padded_i32(*x.shape, device).copy_(torch.tensor(x))


def _to_host(x: torch.Tensor) -> np.ndarray:
    """``x`` read back into a host array: a blocking read of the device,
    counted in ``host.syncs``."""
    tracing.count("host.syncs")
    return x.cpu().numpy()


def _upload_arrays(fr: Fragmentation, device) -> Dict[str, torch.Tensor]:
    return {name: _upload(v, device) for name, v in fr.arrays.items()}


def _boundary_rows(fr: Fragmentation, frontiers, fill, reduce: str):
    """Scatter stacked per-fragment source rows [k, S, n+1] into one
    [nb, n+1] matrix indexed by boundary position (each in-node is owned by
    exactly one fragment, so rows never collide; pad rows go to row B and
    are cut off)."""
    B = fr.B
    width = frontiers.shape[-1]
    rows = torch.tensor(fr.arrays["src_row"].reshape(-1), dtype=torch.long,
                        device=frontiers.device)
    flat = frontiers.reshape(-1, width)
    boolean = flat.dtype == torch.bool
    if boolean:
        flat = flat.view(torch.uint8)
    out = torch.full((B + 1, width), fill, dtype=flat.dtype,
                     device=frontiers.device)
    out.scatter_reduce_(0, rows[:, None].expand(-1, width), flat, reduce,
                        include_self=True)
    out = out[: fr.n_boundary]
    return out.view(torch.bool) if boolean else out


def _gather_boundary_matrix(fr: Fragmentation, bl, part_b: np.ndarray):
    """D0[u, w] = cached frontier of in-node u read at the stub slot of
    boundary node w inside u's fragment.  Gathered fragment by fragment
    (an [nb, nb] int64 index would cost 8 nb^2 bytes)."""
    nb = fr.n_boundary
    D0 = torch.empty((nb, nb), dtype=bl.dtype, device=bl.device)
    if nb == 0:
        return D0
    tgt = torch.tensor(fr.arrays["tgt_local"][:, :nb], dtype=torch.long,
                       device=bl.device)
    for f in np.unique(part_b):
        rows = torch.tensor(np.nonzero(part_b == f)[0], device=bl.device)
        D0[rows] = bl[rows][:, tgt[int(f)]]
    return D0


def prepare_rvset_cache(fr: Fragmentation, device,
                        with_dist: bool = False) -> RvsetCache:
    """Build (or extend) the amortized cache on ``device`` and attach it
    to ``fr``."""
    device = torch.device(device)
    cache = fr.rvset_cache
    if cache is not None and cache.device != device:
        raise ValueError(f"the fragmentation's cache lives on {cache.device}, "
                         f"not {device}")
    if cache is None:
        arrs = _upload_arrays(fr, device)
        part_b = fr.boundary_owner()
        front = engine.local_frontier_reach(
            arrs["esrc"], arrs["edst"], arrs["src_local"], n_max=fr.n_max)
        bl = _boundary_rows(fr, front, 0, "amax")            # [nb, n+1]
        C, Ct = bes.bool_closure_kmajor(
            _gather_boundary_matrix(fr, bl, part_b))
        cache = RvsetCache(fr=fr, device=device, arrays=arrs, bl_frontier=bl,
                           closure=C, closure_t=Ct, part_b=part_b)
        fr.rvset_cache = cache
    if with_dist and cache.bl_dist is None:
        arrs = cache.arrays
        front = engine.local_frontier_dist(
            arrs["esrc"], arrs["edst"], arrs["src_local"], n_max=fr.n_max)
        bl_d = _boundary_rows(fr, front, INF, "amin")
        W0 = _gather_boundary_matrix(fr, bl_d, cache.part_b)
        cache.bl_dist = bl_d
        cache.dist_closure = bes.tropical_closure(W0)
    return cache


def get_rvset_cache(fr: Fragmentation, device,
                    with_dist: bool = False) -> RvsetCache:
    cache = fr.rvset_cache
    if (cache is None or cache.device != torch.device(device)
            or (with_dist and cache.bl_dist is None)):
        cache = prepare_rvset_cache(fr, device, with_dist=with_dist)
    return cache


def load_rvset_state(fr: Fragmentation, arrays: Dict[str, np.ndarray],
                     device) -> RvsetCache:
    """Attach a cache built elsewhere: ``arrays`` holds ``bl_frontier`` and
    ``closure`` and, optionally, ``bl_dist`` and ``dist_closure`` as numpy
    arrays.  Every array is copied onto ``device``; the closure is kept
    K-major, as the repair's floor pair needs it, and its K-major copy is
    made there."""
    device = torch.device(device)
    dist = arrays.get("bl_dist")
    closure = kmajor(_upload(arrays["closure"], device))
    cache = RvsetCache(
        fr=fr, device=device, arrays=_upload_arrays(fr, device),
        bl_frontier=_upload(arrays["bl_frontier"], device),
        closure=closure, closure_t=kmajor_copy(closure.T),
        part_b=fr.boundary_owner(),
        bl_dist=None if dist is None else _upload(dist, device),
        dist_closure=(None if dist is None else _upload_padded(
            arrays["dist_closure"], device)))
    fr.rvset_cache = cache
    return cache


# ---------------------------------------------------------------------------
# combine stage: compose the per-query phase through a closure
# ---------------------------------------------------------------------------

def combine_bool(direct, sb, tc, Ct):
    """``ans = direct | OR_u (sb (or-and) C)[u] & tc[u]``, composed through
    the closure's K-major copy ``Ct = C^T``.

    ``sb``/``tc`` [N, side], ``Ct`` [side, side] with ``side = nb`` for
    plain reachability or ``nb * |Q|`` for the product-automaton (RPQ)
    case.
    """
    if Ct.shape[0] == 0:
        return direct
    sbc = or_and_matmul_nt(sb, Ct)                         # [N, side]
    return direct | (sbc & tc).any(dim=1)


def combine_dist(direct, sb, tc, Cd):
    """Tropical twin of :func:`combine_bool`:
    ``min(direct, min_u (sb (min-plus) Cd)[u] + tc[u])`` clipped at INF."""
    if Cd.shape[0] == 0:
        return direct.clamp_max(INF)
    sbc = min_plus_matmul(sb, Cd)                          # [N, nb]
    via = (sbc + tc).clamp_max_(INF).amin(dim=1)
    return torch.minimum(direct, via).clamp_max_(INF)


# ---------------------------------------------------------------------------
# per-rank local stage (sharded backend: each rank contributes its own
# fragments' D0/W0 rows, per-pair s-rows and t-column entries, which ride
# the ONE collective of core.distributed.dis_*_batch_sharded)
# ---------------------------------------------------------------------------
#
# Every function takes the rank's owned fragments as a leading [fpd, ...]
# axis and returns the contributions already merged over it.  The merge is
# exact because every d0/sb row and tc column is computed by exactly one
# fragment, the others contributing the semiring zero (False or INF), so
# the functions write each fragment's owned rows and columns straight into
# one [nb, nb] buffer instead of stacking [fpd, nb, nb] and reducing.  The
# same disjointness lets them skip the work whose result is all zero: a
# pair's forward propagation runs only in the fragment that holds its
# source, and a fragment that owns no boundary row adds no rows.  Pad
# slots (no edges, no sources, nothing owned) therefore cost nothing.
# Shapes: ``s_slot``/``t_slot`` [fpd, N] (local slot of s_j / t_j in each
# fragment, ``n_max`` if absent); ``srcidx`` [fpd, nb] (boundary position ->
# source row, pad row elsewhere); ``own`` [fpd, nb] ownership mask;
# ``tgt_mine`` [fpd, nb] (stub slot of boundary node w in each fragment).

def _local_stage_packed(F, single_source, zero, esrc, edst, s_slot, t_slot,
                        srcidx, own, tgt_mine, n_max: int):
    """Shared body of the reach and dist stages over all-sources frontiers
    F [fpd, S, n_max+1] (Boolean or tropical, semiring zero ``zero``)."""
    fpd, nb = own.shape
    N = s_slot.shape[1]
    dev = F.device
    d0 = torch.full((nb, nb), zero, dtype=F.dtype, device=dev)
    sb = torch.full((N, nb), zero, dtype=F.dtype, device=dev)
    direct = torch.full((N,), zero, dtype=F.dtype, device=dev)
    tc = torch.full((N, nb), zero, dtype=F.dtype, device=dev)
    tgt = tgt_mine.long()
    frag, pair = torch.nonzero(s_slot < n_max, as_tuple=True)
    if frag.numel():
        f = single_source(esrc[frag], edst[frag], s_slot[frag, pair],
                          n_max=n_max)                     # [P, n+1]
        sb[pair] = torch.gather(f, 1, tgt[frag])
        direct[pair] = torch.gather(f, 1, t_slot[frag, pair].long()[:, None])[:, 0]
    for j in range(fpd):
        mine = torch.nonzero(own[j])[:, 0]
        if mine.numel() == 0:
            continue
        rows = F[j][srcidx[j, mine].long()]                # [r, n+1]
        d0[mine] = rows[:, tgt[j]]
        tc[:, mine] = rows[:, t_slot[j].long()].T
    return d0, sb, direct, tc


def local_stage_reach_packed(esrc, edst, src_local, s_slot, t_slot, srcidx,
                             own, tgt_mine, *, n_max: int):
    """One rank's local stage of a fused reach batch over its ``fpd``
    owned fragments: their all-sources fixpoints and the single-source
    propagations of the pairs whose source they hold.  Returns ``(d0
    [nb, nb], sb [N, nb], direct [N], tc [N, nb])`` bool — all-false outside
    the rank's ownership, so the cross-rank merge is a plain bitwise OR."""
    F = engine.local_frontier_reach(esrc, edst, src_local, n_max=n_max)
    return _local_stage_packed(F, engine.single_source_reach, False, esrc,
                               edst, s_slot, t_slot, srcidx, own, tgt_mine,
                               n_max)


def local_stage_dist_packed(esrc, edst, src_local, s_slot, t_slot, srcidx,
                            own, tgt_mine, *, n_max: int):
    """Tropical twin of :func:`local_stage_reach_packed`: non-owned entries
    are INF, so the cross-rank merge is a min.  Returns ``(w0 [nb, nb],
    sb [N, nb], direct [N], tc [N, nb])`` int32."""
    F = engine.local_frontier_dist(esrc, edst, src_local, n_max=n_max)
    return _local_stage_packed(F, engine.single_source_dist, INF, esrc, edst,
                               s_slot, t_slot, srcidx, own, tgt_mine, n_max)


def local_stage_rpq_packed(esrc, edst, src_local, src_row, tgt_local, labels,
                           gids, q_labels, q_trans, q_start, s_slot, t_slot,
                           s_gids, t_gids, local_b, mine, *, n_max: int,
                           B: int):
    """Product-automaton local stage of a fused RPQ batch on one rank.

    The query-independent part is the owned fragments' product rvset rows
    (``local_eval_regular`` with the s/t sentinels matched off, as in
    :func:`product_closure`); the per-pair part is one forward product
    propagation from ``(s_j, u_s)`` in the fragment holding ``s_j`` and one
    reverse propagation to ``(t_j, u_t)`` in every owned fragment that
    holds ``t_j`` and owns boundary rows.  Per-fragment arguments carry
    ``[fpd, ...]``; ``q_*``, ``s_gids``/``t_gids`` [N] and ``local_b`` [nb]
    (local slot of each boundary node in its owner) are shared; ``mine``
    [fpd, nb] masks the in-nodes each fragment owns.  Returns ``(d0
    [(nb*Q), (nb*Q)], sb [N, nb*Q], direct [N], tc [N, nb*Q])``."""
    fpd = esrc.shape[0]
    Q = q_labels.shape[0]
    nb = B - 2
    N = s_slot.shape[1]
    dev = esrc.device
    no_slot = torch.full((fpd,), n_max, dtype=torch.int32, device=dev)
    d0 = engine.regular_rvset(
        esrc, edst, src_local, src_row, tgt_local, labels, gids, q_labels,
        q_trans, no_slot, no_slot, NO_NODE, NO_NODE, n_max=n_max, B=B,
        side=nb * Q)
    direct = torch.zeros(N, dtype=torch.bool, device=dev)
    sb = torch.zeros((N, nb, Q), dtype=torch.bool, device=dev)
    tc = torch.zeros((N, nb, Q), dtype=torch.bool, device=dev)
    frag, pair = torch.nonzero(s_slot < n_max, as_tuple=True)
    if frag.numel():
        f = engine.single_source_regular(
            esrc[frag], edst[frag], labels[frag], gids[frag], q_labels,
            q_trans, s_slot[frag, pair], q_start, s_gids[pair], t_gids[pair],
            n_max=n_max)                                   # [P, n+1, Q]
        hit = t_slot[frag, pair].long()
        direct[pair] = f[torch.arange(len(pair), device=dev), hit, Q - 1]
        tgt = tgt_local[frag, :nb].long()
        sb[pair] = torch.gather(f, 1, tgt[:, :, None].expand(-1, nb, Q))
    frag, pair = torch.nonzero((t_slot < n_max) & mine.any(1)[:, None],
                               as_tuple=True)
    if frag.numel():
        rev = engine.reverse_target_regular(
            esrc[frag], edst[frag], labels[frag], gids[frag], q_labels,
            q_trans, t_slot[frag, pair], s_gids[pair], t_gids[pair],
            n_max=n_max)                                   # [C, n+1, Q]
        for j in range(fpd):
            owned = torch.nonzero(mine[j])[:, 0]
            sel = torch.nonzero(frag == j)[:, 0]
            if owned.numel() and sel.numel():
                tc[pair[sel][:, None], owned[None, :]] = \
                    rev[sel][:, local_b[owned].long(), :]
    return d0, sb.reshape(N, nb * Q), direct, tc.reshape(N, nb * Q)


def local_stage_reach(esrc, edst, src_local, s_slot, t_slot, srcidx, own,
                      tgt_mine, *, n_max: int):
    """:func:`local_stage_reach_packed` for one fragment: every argument
    without the leading ``[fpd]`` axis."""
    return local_stage_reach_packed(
        esrc[None], edst[None], src_local[None], s_slot[None], t_slot[None],
        srcidx[None], own[None], tgt_mine[None], n_max=n_max)


def local_stage_dist(esrc, edst, src_local, s_slot, t_slot, srcidx, own,
                     tgt_mine, *, n_max: int):
    """:func:`local_stage_dist_packed` for one fragment."""
    return local_stage_dist_packed(
        esrc[None], edst[None], src_local[None], s_slot[None], t_slot[None],
        srcidx[None], own[None], tgt_mine[None], n_max=n_max)


def local_stage_rpq(esrc, edst, src_local, src_row, tgt_local, labels, gids,
                    q_labels, q_trans, q_start, s_slot, t_slot, s_gids,
                    t_gids, local_b, mine, *, n_max: int, B: int):
    """:func:`local_stage_rpq_packed` for one fragment."""
    return local_stage_rpq_packed(
        esrc[None], edst[None], src_local[None], src_row[None],
        tgt_local[None], labels[None], gids[None], q_labels, q_trans,
        q_start, s_slot[None], t_slot[None], s_gids, t_gids, local_b,
        mine[None], n_max=n_max, B=B)


# ---------------------------------------------------------------------------
# batched per-query phase
# ---------------------------------------------------------------------------

def _per_query(fr, cache, frag_s, s_slot, t_slot_sfrag, single_source):
    """Single-source propagation of every pair on its source's fragment;
    returns (direct [N], sb [N, nb]).  An int32 sb is gathered into padded
    storage, the min-plus compose's operand layout."""
    arrs = cache.arrays
    f = single_source(arrs["esrc"][frag_s], arrs["edst"][frag_s], s_slot,
                      n_max=fr.n_max)                      # [N, n+1]
    direct = torch.gather(f, 1, t_slot_sfrag[:, None])[:, 0]
    tgt_s = arrs["tgt_local"][frag_s][:, : cache.nb].long()
    out = (padded_i32(*tgt_s.shape, f.device) if f.dtype == torch.int32
           else None)
    return direct, torch.gather(f, 1, tgt_s, out=out)


def _t_column(bl, t_cols):
    """tc[j, u] = bl[u, t_cols[j, u]]: in-node u locally reaches t_j."""
    nb = bl.shape[0]
    return bl[torch.arange(nb, device=bl.device)[None, :], t_cols]


def _batch_inputs(fr: Fragmentation, cache: RvsetCache, pairs: np.ndarray):
    """Per-batch index arrays (host numpy gathers, one upload each)."""
    ss, tt = pairs[:, 0], pairs[:, 1]
    slot_of = fr.slot_index()                              # [n, k]
    frag_s = fr.part[ss]
    s_slot = fr.owner_local[ss]
    t_slot_sfrag = slot_of[tt, frag_s]                     # [N]
    t_cols = slot_of[tt][:, cache.part_b]                  # [N, nb]
    return tuple(_upload(x, cache.device, torch.long)
                 for x in (frag_s, s_slot, t_slot_sfrag, t_cols))


def _as_pairs(pairs) -> np.ndarray:
    p = np.asarray(pairs, dtype=np.int64)
    if p.ndim != 2 or p.shape[1] != 2:
        raise ValueError(f"pairs must be [N, 2], got {p.shape}")
    return p


def dis_reach_batch(fr: Fragmentation, pairs, device) -> np.ndarray:
    """Answer N (s, t) reachability queries against the amortized rvset
    cache on ``device``.  Returns [N] bool."""
    pairs = _as_pairs(pairs)
    if len(pairs) == 0:
        return np.zeros(0, dtype=bool)
    cache = get_rvset_cache(fr, device)
    with tracing.span("cache.inputs"):
        frag_s, s_slot, t_slot_sfrag, t_cols = _batch_inputs(fr, cache,
                                                             pairs)
    with tracing.span("cache.per_query"):
        direct, sb = _per_query(fr, cache, frag_s, s_slot, t_slot_sfrag,
                                engine.single_source_reach)
    with tracing.span("cache.t_column"):
        tc = _t_column(cache.bl_frontier, t_cols)
    with tracing.span("cache.compose"):
        ans = combine_bool(direct, sb, tc, cache.closure_t)
    with tracing.span("cache.readback"):
        return _to_host(ans)


def dis_dist_batch(fr: Fragmentation, pairs, device,
                   bound: Optional[int] = None) -> np.ndarray:
    """N shortest distances (or bounded-reachability answers when ``bound``
    is given: dist <= bound).  Returns [N] int64 distances with -1 for
    unreachable, or [N] bool when ``bound`` is not None."""
    pairs = _as_pairs(pairs)
    if len(pairs) == 0:
        return np.zeros(0, dtype=bool if bound is not None else np.int64)
    cache = get_rvset_cache(fr, device, with_dist=True)
    with tracing.span("cache.inputs"):
        frag_s, s_slot, t_slot_sfrag, t_cols = _batch_inputs(fr, cache,
                                                             pairs)
    with tracing.span("cache.per_query"):
        direct, sb = _per_query(fr, cache, frag_s, s_slot, t_slot_sfrag,
                                engine.single_source_dist)
    with tracing.span("cache.t_column"):
        tc = _t_column(cache.bl_dist, t_cols)
    with tracing.span("cache.compose"):
        d = combine_dist(direct, sb, tc, cache.dist_closure)
    with tracing.span("cache.readback"):
        d = _to_host(d).astype(np.int64)
    if bound is not None:
        return d <= bound
    d[d >= INF] = -1
    return d


# ---------------------------------------------------------------------------
# cached single-query wrappers (batch of one)
# ---------------------------------------------------------------------------

def reach_cached(fr: Fragmentation, s: int, t: int, device) -> bool:
    return bool(dis_reach_batch(fr, [(s, t)], device)[0])


def dist_cached(fr: Fragmentation, s: int, t: int,
                device) -> Optional[int]:
    d = int(dis_dist_batch(fr, [(s, t)], device)[0])
    return None if d < 0 else d


# ---------------------------------------------------------------------------
# regular (RPQ) cached path
# ---------------------------------------------------------------------------

def product_closure(fr: Fragmentation, qa: QueryAutomaton,
                    device) -> torch.Tensor:
    """Query-independent product-automaton closure [(nb*Q), (nb*Q)]: the
    first of :func:`product_closure_kmajor`'s pair."""
    return product_closure_kmajor(fr, qa, device)[0]


def product_closure_kmajor(fr: Fragmentation, qa: QueryAutomaton, device
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-independent product-automaton closure [(nb*Q), (nb*Q)] and
    its K-major copy, kept together in the cache's LRU.

    Sound because the Glushkov automaton's u_s has no incoming and u_t no
    outgoing transitions: neither s-only nor t-only states can occur
    strictly inside a boundary-to-boundary path, so matching them off
    (NO_NODE gid) loses nothing the per-query phase doesn't re-add.
    """
    cache = get_rvset_cache(fr, device)
    key = qa.cache_key()
    if key in cache.rpq_closures:
        # true LRU: a hit moves the key back to the MRU end of the (insert-
        # ordered) dicts, so a hot automaton is never FIFO-evicted by churn
        pair = cache.rpq_closures.pop(key), cache.rpq_closures_t.pop(key)
        cache.rpq_closures[key], cache.rpq_closures_t[key] = pair
        return pair
    arrs = cache.arrays
    dev = cache.device
    k, n_max, B, Q = fr.k, fr.n_max, fr.B, qa.n_states
    no_slot = torch.full((k,), n_max, dtype=torch.int32, device=dev)
    D = engine.regular_rvset(
        arrs["esrc"], arrs["edst"], arrs["src_local"], arrs["src_row"],
        arrs["tgt_local"], arrs["labels"], arrs["gids"],
        _upload(qa.state_labels, dev), _upload(qa.trans, dev),
        no_slot, no_slot, NO_NODE, NO_NODE, n_max=n_max, B=B,
        side=fr.n_boundary * Q)
    C, Ct = bes.bool_closure_kmajor(D)
    # bound the per-automaton cache; dict order is recency order, so the
    # first key is the least recently used one
    while len(cache.rpq_closures) >= MAX_RPQ_CLOSURES:
        lru = next(iter(cache.rpq_closures))
        del cache.rpq_closures[lru], cache.rpq_closures_t[lru]
    cache.rpq_closures[key] = C
    cache.rpq_closures_t[key] = Ct
    return C, Ct


def _batch_rpq(fr, cache, qa, Ct, pairs):
    """N pairs -> N answers for ONE automaton against its cached product
    closure, given as its K-major copy ``Ct``: per pair one forward
    product propagation from (s, u_s) on s's fragment and k reverse product
    propagations to (t, u_t) (one per fragment — the t-column); then ONE
    or-and product [N, nb*Q] x [(nb*Q), (nb*Q)] composes them through the
    closure."""
    dev = cache.device
    arrs = cache.arrays
    k, n_max, Q, nb = fr.k, fr.n_max, qa.n_states, cache.nb
    ss, tt = pairs[:, 0], pairs[:, 1]
    N = len(pairs)
    slot_of = fr.slot_index()
    frag_s_np = fr.part[ss]
    frag_s = torch.tensor(frag_s_np, dtype=torch.long, device=dev)
    s_slot = torch.tensor(fr.owner_local[ss], dtype=torch.long, device=dev)
    t_slot_sfrag = torch.tensor(slot_of[tt, frag_s_np], dtype=torch.long,
                                device=dev)
    t_slots = torch.tensor(slot_of[tt, :], dtype=torch.long, device=dev)
    s_gids = torch.tensor(ss, dtype=torch.int32, device=dev)
    t_gids = torch.tensor(tt, dtype=torch.int32, device=dev)
    q_labels = _upload(qa.state_labels, dev)
    q_trans = _upload(qa.trans, dev)

    f = engine.single_source_regular(
        arrs["esrc"][frag_s], arrs["edst"][frag_s], arrs["labels"][frag_s],
        arrs["gids"][frag_s], q_labels, q_trans, s_slot, qa.start, s_gids,
        t_gids, n_max=n_max)                               # [N, n+1, Q]
    direct = torch.gather(f[:, :, Q - 1], 1, t_slot_sfrag[:, None])[:, 0]
    if nb == 0:
        return direct

    def per_pair_fragment(x):                              # [k, ...] -> [N*k, ...]
        return x[None].expand(N, *x.shape).reshape(N * k, *x.shape[1:])

    rev = engine.reverse_target_regular(
        per_pair_fragment(arrs["esrc"]), per_pair_fragment(arrs["edst"]),
        per_pair_fragment(arrs["labels"]), per_pair_fragment(arrs["gids"]),
        q_labels, q_trans, t_slots.reshape(-1),
        s_gids.repeat_interleave(k), t_gids.repeat_interleave(k),
        n_max=n_max).reshape(N, k, n_max + 1, Q)
    tgt_s = arrs["tgt_local"][frag_s][:, :nb].long()       # [N, nb]
    sb = torch.gather(f, 1, tgt_s[:, :, None].expand(N, nb, Q))
    # spare boundary slots read the (all-false) pad row of rev via local_b
    part_b = torch.tensor(cache.part_b, dtype=torch.long, device=dev)
    local_b = torch.tensor(fr.boundary_local(), dtype=torch.long, device=dev)
    tc = rev[:, part_b, local_b, :]                        # [N, nb, Q]
    return combine_bool(direct, sb.reshape(N, nb * Q),
                        tc.reshape(N, nb * Q), Ct)


def dis_rpq_batch(fr: Fragmentation, pairs, qa: QueryAutomaton,
                  device) -> np.ndarray:
    """Answer N (s, t) regular path queries for one automaton against the
    cached product closure on ``device``.  Returns [N] bool."""
    pairs = _as_pairs(pairs)
    if len(pairs) == 0:
        return np.zeros(0, dtype=bool)
    _, Ct = product_closure_kmajor(fr, qa, device)
    cache = get_rvset_cache(fr, device)
    ans = _batch_rpq(fr, cache, qa, Ct, pairs).cpu().numpy().copy()
    ans[pairs[:, 0] == pairs[:, 1]] = bool(qa.nullable)  # s == t is |R|-free
    return ans


def rpq_cached(fr: Fragmentation, s: int, t: int, qa: QueryAutomaton,
               device) -> bool:
    """Cached disRPQ (batch of one): the per-automaton product closure
    (amortized) + one forward and k reverse product propagations."""
    if s == t:
        return bool(qa.nullable)
    return bool(dis_rpq_batch(fr, [(s, t)], qa, device)[0])
