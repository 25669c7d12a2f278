"""Partial-evaluation engine: localEval and evalDG in PyTorch.

The paper's localEval (Sections 3-5) as batched frontier propagation over
each fragment's padded edge list, and its evalDG as a single-source
fixpoint on the assembled dependency matrix, on the card one launch of a
hand-written kernel (or-and or min-plus) that runs every step on the
device and reads nothing back, as the reference's ``while_loop`` does.
Every localEval function takes the fragment axis
written out as the leading dimension (one row per fragment, or one row per
query with that query's fragment gathered in), so one ``gather`` and one
``scatter_reduce_`` per step cover every fragment at once.  A localEval
loop stops when a step changes nothing: one host sync per step, which is
cheap because a fragment's diameter is small.

Conventions (set up by ``fragments.fragment_graph``):
  * local node slots 0..n_max-1 are real nodes + virtual stubs; slot n_max
    is the pad node; pad edges self-loop on it; pad target columns point at
    it.  The pad slot is never set at the start and only pad edges reach
    it, so it never becomes reached.
  * boundary rows/cols 0..B-3 are V_f in-nodes; row B-2 is s; col B-1 is t;
    row index B means "dropped".
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from ..kernels.bool_matmul.ops import or_and_fixpoint, padded_zeros
from ..kernels.tropical_matmul.ops import min_plus_fixpoint

INF = 1 << 29          # with int32 tensors; INF + INF still fits in int32


class QueryStats(NamedTuple):
    """Measured guarantees (paper Theorems 1-3).

    Queries served inside a fused batch carry *group-amortized* stats
    (core.session): the group's ONE collective is split across its
    queries, so summing over any group yields exactly the wire size of
    that collective and one round — never N copies of it.
    """
    payload_bits: int        # rvset bits shipped (amortized share when fused)
    collective_rounds: int   # visits per site (1 per fused group, stamped on
                             # the group's first query)
    boundary: int            # |V_f| + 2 query slots
    states: int              # |Q| (1 for plain/bounded reachability)


# ---------------------------------------------------------------------------
# fixpoint marks, read by the collective record of core.distributed
# ---------------------------------------------------------------------------

class _FixpointTrace(threading.local):
    """Per-thread state of :func:`repro_torch.core.distributed.
    record_collectives`: while a record is open (``recording``), every
    fixpoint loop of the engine and of ``core.bes`` raises ``depth`` as it
    iterates and counts itself in ``loops``, so a collective issued inside
    a loop is seen as such."""

    recording = False
    record = None          # the open CollectiveRecord
    depth = 0
    loops = 0


TRACE = _FixpointTrace()


class _Fixpoint:
    """``with FIXPOINT:`` around a fixpoint loop.  Outside a record it
    costs one attribute read on entry and one on exit."""

    def __enter__(self):
        t = TRACE
        if t.recording:
            t.depth += 1
            t.loops += 1

    def __exit__(self, *exc):
        t = TRACE
        if t.recording and t.depth:
            t.depth -= 1
        return False


FIXPOINT = _Fixpoint()


# ---------------------------------------------------------------------------
# local propagation primitives (leading axis: fragment or query)
# ---------------------------------------------------------------------------

def _edge_index(e: torch.Tensor, shape) -> torch.Tensor:
    """Edge slots [F, E] as an int64 index broadcast over the source axes
    of ``shape`` = (F, S, E): a view, no copy of the [F, S, E] block."""
    return e.long()[:, None, :].expand(shape)


def _propagate_bool(esrc, edst, frontier):
    """Fixpoint of frontier[f, j, v'] |= OR_{(v, v') in E_f} frontier[f, j, v].

    esrc/edst [F, E] local slots; frontier [F, S, n_max+1] bool, batched
    over S sources per fragment.  Returns a new tensor."""
    F, S, _ = frontier.shape
    shape = (F, S, esrc.shape[-1])
    src, dst = _edge_index(esrc, shape), _edge_index(edst, shape)
    seen = frontier.clone()
    if not bool(seen.any()):
        return seen
    with FIXPOINT:
        while True:
            msgs = torch.gather(seen, 2, src).view(torch.uint8)
            new = seen.view(torch.uint8).scatter_reduce(
                2, dst, msgs, "amax", include_self=True).view(torch.bool)
            if torch.equal(new, seen):
                return seen
            seen = new


def _propagate_dist(esrc, edst, dist, cap: int = INF):
    """Fixpoint of dist[f, j, v'] = min(dist, min_{(v,v') in E_f} dist[v] + 1),
    with every entry above ``cap`` snapped to INF after each step (paper
    Sec. 4 keeps only distances within the query bound; the default INF
    keeps every distance).

    dist [F, S, n_max+1] int32 in [0, INF].  The ``amin`` keeps each entry
    at most its old value, so nothing rises above INF.  Returns a new
    tensor."""
    F, S, _ = dist.shape
    shape = (F, S, esrc.shape[-1])
    src, dst = _edge_index(esrc, shape), _edge_index(edst, shape)
    d = dist.clone()
    if not bool((d < INF).any()):
        return d
    with FIXPOINT:
        while True:
            msgs = torch.gather(d, 2, src) + 1
            new = d.scatter_reduce(2, dst, msgs, "amin", include_self=True)
            if cap < INF:
                new = torch.where(new > cap, INF, new)
            if torch.equal(new, d):
                return d
            d = new


def _with_query_source(src_local, src_row, s_local, n_max: int, B: int):
    """Fill each fragment's reserved last source slot with the query source
    s (active only in the fragment owning s; dropped elsewhere).
    src_local/src_row [k, S], s_local [k]."""
    src_local, src_row = src_local.clone(), src_row.clone()
    src_local[:, -1] = s_local
    src_row[:, -1] = torch.where(s_local < n_max, B - 2, B)
    return src_local, src_row


# ---------------------------------------------------------------------------
# query-independent frontiers (the rvset cache phase)
# ---------------------------------------------------------------------------

def local_frontier_reach(esrc, edst, src_local, *, n_max: int):
    """All-sources local fixpoint WITHOUT the query slots:
    frontier[f, j, v] = 1 iff in-node source j of fragment f reaches local
    slot v inside f.  esrc/edst [k, E], src_local [k, S] ->
    [k, S, n_max+1] bool."""
    k, S = src_local.shape
    frontier = torch.zeros((k, S, n_max + 1), dtype=torch.bool,
                           device=src_local.device)
    frontier.scatter_(2, src_local.long()[:, :, None], True)
    frontier[:, :, n_max] = False
    return _propagate_bool(esrc, edst, frontier)


def local_frontier_dist(esrc, edst, src_local, *, n_max: int):
    """Tropical counterpart of :func:`local_frontier_reach`: local hop
    distances, INF where absent (uncapped; a per-query bound is applied at
    answer time, which is equivalent for shortest distances)."""
    k, S = src_local.shape
    dist = torch.full((k, S, n_max + 1), INF, dtype=torch.int32,
                      device=src_local.device)
    dist.scatter_(2, src_local.long()[:, :, None], 0)
    dist[:, :, n_max] = INF
    return _propagate_dist(esrc, edst, dist)


def resume_frontier_reach(esrc, edst, frontier, *, n_max: int):
    """Continue a Boolean all-sources fixpoint from a warm state.

    Used by incremental cache repair: after edge insertions the old
    converged frontier is a valid under-approximation, so the fixpoint run
    from it converges in O(new-path length) steps instead of O(diam).
    ``frontier`` [F, S, n_max+1] bool with each row's own source bit set."""
    frontier = frontier.clone()
    frontier[:, :, n_max] = False
    return _propagate_bool(esrc, edst, frontier)


def resume_frontier_dist(esrc, edst, dist, *, n_max: int):
    """Tropical twin of :func:`resume_frontier_reach`: the old distances
    are realizable upper bounds after insertions, so relaxation from them
    converges to the new exact distances."""
    dist = dist.clone()
    dist[:, :, n_max] = INF
    return _propagate_dist(esrc, edst, dist)


# ---------------------------------------------------------------------------
# per-query propagation (the cheap phase against the cache)
# ---------------------------------------------------------------------------

def single_source_reach(esrc, edst, src, *, n_max: int):
    """One-source Boolean fixpoint per query: esrc/edst [N, E] (each
    query's own fragment), src [N] -> frontier [N, n_max+1] bool.
    ``src == n_max`` (pad) yields the all-false frontier."""
    N = src.shape[0]
    frontier = torch.zeros((N, 1, n_max + 1), dtype=torch.bool,
                           device=src.device)
    frontier.scatter_(2, src.long()[:, None, None], (src < n_max)[:, None, None])
    frontier[:, :, n_max] = False
    return _propagate_bool(esrc, edst, frontier)[:, 0]


def single_source_dist(esrc, edst, src, *, n_max: int):
    """One-source tropical fixpoint per query: [N, n_max+1] int32 (INF
    absent); ``src == n_max`` yields all INF."""
    N = src.shape[0]
    dist = torch.full((N, 1, n_max + 1), INF, dtype=torch.int32,
                      device=src.device)
    start = torch.where(src < n_max, 0, INF).to(torch.int32)
    dist.scatter_(2, src.long()[:, None, None], start[:, None, None])
    dist[:, :, n_max] = INF
    return _propagate_dist(esrc, edst, dist)[:, 0]


# ---------------------------------------------------------------------------
# localEval of the one-shot algorithms (paper Fig. 3 and Sec. 4): one row
# block of the dependency matrix per call
# ---------------------------------------------------------------------------
#
# Each local_eval_* takes F fragments along a leading axis (all k, or a
# rank's own, or one) and returns ``(rows, block)``: the dependency-matrix
# rows its sources own, and their row block.  Every row is owned by exactly
# one fragment (an in-node by its owner, the s row by s's fragment), so a
# caller assembles the matrix by writing each block into one buffer that
# holds the semiring zero elsewhere (``D[rows] = block``): the elementwise
# OR / min of the per-fragment matrices, without stacking them.

def _target_cols(tgt_local, t_local, n_max: int, B: int):
    """[F, B] local slot read for each dependency-matrix column: the stub
    of each boundary node, nothing (the pad) for the s column, and t."""
    F = tgt_local.shape[0]
    return torch.cat([tgt_local[:, : B - 2].long(),
                      torch.full((F, 1), n_max, dtype=torch.long,
                                 device=tgt_local.device),
                      t_local.long()[:, None]], dim=1)


def _owned_rows(src_row, B: int):
    """Flat indices of the source slots that own a row (< B), and rows."""
    flat = src_row.reshape(-1).long()
    keep = torch.nonzero(flat < B)[:, 0]
    return keep, flat[keep]


def local_eval_reach(esrc, edst, src_local, src_row, tgt_local, s_local,
                     t_local, *, n_max: int, B: int):
    """localEval (paper Fig. 3) on F fragments: rvset rows of the
    dependency matrix.  ``rows`` [r] and ``block`` [r, B] bool with
    ``block[i, col(w)] = 1`` iff source ``rows[i]`` (an owned in-node, or s
    at row B-2) reaches virtual node w (or t, column B-1) inside its
    fragment.  Fragment arguments carry a leading [F] axis; s_local and
    t_local are [F] (``n_max`` where absent)."""
    src_local, src_row = _with_query_source(src_local, src_row, s_local,
                                            n_max, B)
    F, S = src_local.shape
    frontier = torch.zeros((F, S, n_max + 1), dtype=torch.bool,
                           device=src_local.device)
    frontier.scatter_(2, src_local.long()[:, :, None], True)
    frontier[:, :, n_max] = False          # the pad node is never seen
    frontier = _propagate_bool(esrc, edst, frontier)
    cols = _target_cols(tgt_local, t_local, n_max, B)
    out = torch.gather(frontier, 2, cols[:, None, :].expand(F, S, B))
    out &= (cols != n_max)[:, None, :]
    keep, rows = _owned_rows(src_row, B)
    return rows, out.reshape(F * S, B)[keep]


def local_eval_dist(esrc, edst, src_local, src_row, tgt_local, s_local,
                    t_local, cap: int = INF, *, n_max: int, B: int):
    """localEval_d (paper Sec. 4) on F fragments: the tropical rows
    ``(rows [r], block [r, B] int32)``, block entries the local hop
    distance from source to virtual node (INF where absent).  Distances
    above ``cap`` (the query bound) are snapped to INF during the
    propagation, as the paper keeps only dist < l."""
    src_local, src_row = _with_query_source(src_local, src_row, s_local,
                                            n_max, B)
    F, S = src_local.shape
    dist = torch.full((F, S, n_max + 1), INF, dtype=torch.int32,
                      device=src_local.device)
    dist.scatter_(2, src_local.long()[:, :, None], 0)
    dist[:, :, n_max] = INF
    dist = _propagate_dist(esrc, edst, dist, cap)
    cols = _target_cols(tgt_local, t_local, n_max, B)
    out = torch.gather(dist, 2, cols[:, None, :].expand(F, S, B))
    out = torch.where((cols == n_max)[:, None, :], INF, out)
    keep, rows = _owned_rows(src_row, B)
    return rows, out.reshape(F * S, B)[keep]


# ---------------------------------------------------------------------------
# evalDG: assembling at the coordinator (paper Fig. 4, Secs. 4-5)
# ---------------------------------------------------------------------------

def evaldg_reach(D, src_rows, tgt_cols) -> bool:
    """Single-source fixpoint on the dependency matrix D [B, B] bool:
    x := x | x (or-and) D until nothing changes (at most diam(G_f) + 1
    steps), then whether any column in ``tgt_cols`` is reached.
    src_rows / tgt_cols: bool masks [B].

    The fixpoint is :func:`~repro_torch.kernels.bool_matmul.ops.
    or_and_fixpoint`: on the card one launch whose steps each read only
    the rows of D that the step before reached, on D as it is stored when
    its rows lie 16 bytes apart, as every path makes it
    (:func:`~repro_torch.kernels.bool_matmul.ops.padded_zeros`).  The
    answer is read back once, at the end."""
    with FIXPOINT:
        x, _ = or_and_fixpoint(src_rows, D)
    return bool((x & tgt_cols).any())


def evaldg_dist(W, src_rows, tgt_cols) -> int:
    """Single-source tropical fixpoint on W [B, B] int32 (Bellman-Ford on
    the dependency graph: the paper uses Dijkstra, Bellman-Ford is its
    matrix form): d := min(d, d (min-plus) W) until nothing changes.
    Returns the least distance onto ``tgt_cols`` (INF if none is reached).

    The fixpoint is :func:`~repro_torch.kernels.tropical_matmul.ops.
    min_plus_fixpoint`: on the card one launch whose steps each read only
    the rows of W whose distance fell in the step before, on W as it is
    stored (the paths make it in padded storage,
    :func:`~repro_torch.kernels.tropical_matmul.ops.padded_i32`).  The
    answer is read back once, at the end."""
    d0 = torch.full((W.shape[0],), INF, dtype=torch.int32, device=W.device)
    d0.masked_fill_(src_rows, 0)
    with FIXPOINT:
        d, _ = min_plus_fixpoint(d0, W)
    return int(torch.where(tgt_cols, d, INF).min())


# ---------------------------------------------------------------------------
# product-automaton propagation (regular queries, paper Fig. 7)
# ---------------------------------------------------------------------------

def _match_matrix(labels, gids, q_labels, s_gid, t_gid):
    """match[..., v, q]: node in local slot v can occupy automaton state q.

    labels/gids [F, n_max+1]; s_gid/t_gid [F] (or scalars).  q_labels
    sentinels: >=0 symbol, -1 only-s, -2 only-t, -3 wildcard.  Pad slots
    (labels -9 / gids -1) match nothing.
    """
    s_gid = torch.as_tensor(s_gid, device=labels.device)
    t_gid = torch.as_tensor(t_gid, device=labels.device)
    lv = labels[..., :, None]
    gv = gids[..., :, None]
    lq = q_labels
    s = s_gid.reshape(s_gid.shape + (1, 1))
    t = t_gid.reshape(t_gid.shape + (1, 1))
    return (((lq >= 0) & (lv == lq)) | ((lq == -3) & (lv >= 0))
            | ((lq == -1) & (gv == s)) | ((lq == -2) & (gv == t)))


def _advance(cur, trans_f):
    """One automaton step: OR_q cur[..., q] & trans[q, q'].  A float32
    product is exact here (the count is at most Q < 2^24), and an int8
    accumulator would wrap once 128 states are active."""
    return (cur.float() @ trans_f) > 0


def _gather_scatter_or(x, esrc, edst):
    """Push Boolean rows along edges: out[f, v', :] = OR_{(v,v') in E_f}
    x[f, v, :].  x [F, n_max+1, Q]; esrc/edst [F, E]."""
    F, _, Q = x.shape
    shape = (F, esrc.shape[-1], Q)
    src = esrc.long()[:, :, None].expand(shape)
    dst = edst.long()[:, :, None].expand(shape)
    msgs = torch.gather(x, 1, src).view(torch.uint8)
    out = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
    return out.scatter_reduce_(1, dst, msgs, "amax").view(torch.bool)


def single_source_regular(esrc, edst, labels, gids, q_labels, q_trans,
                          s_slot, q_start: int, s_gid, t_gid, *, n_max: int):
    """Per-query product-automaton forward fixpoint from (s, u_s) on s's
    fragment: f [N, n_max+1, Q] bool — f[j, v, q] = 1 iff a path from s_j
    occupying the start state reaches local slot v in state q (every step
    matching).  esrc/edst [N, E], labels/gids [N, n_max+1], s_slot/s_gid/
    t_gid [N]."""
    N = s_slot.shape[0]
    Q = q_labels.shape[0]
    match = _match_matrix(labels, gids, q_labels, s_gid, t_gid)
    match[:, n_max, :] = False                                # [N, n+1, Q]
    f = torch.zeros((N, n_max + 1, Q), dtype=torch.bool, device=s_slot.device)
    rows = torch.arange(N, device=s_slot.device)
    sl = s_slot.long()
    f[rows, sl, q_start] = (sl < n_max) & match[rows, sl, q_start]
    tf = q_trans.float()
    if not bool(f.any()):
        return f
    with FIXPOINT:
        while True:
            new = f | (_gather_scatter_or(_advance(f, tf), esrc, edst)
                       & match)
            if torch.equal(new, f):
                return f
            f = new


def reverse_target_regular(esrc, edst, labels, gids, q_labels, q_trans,
                           t_slot, s_gid, t_gid, *, n_max: int):
    """Per-query product-automaton BACKWARD fixpoint to (t, u_t): r [F,
    n_max+1, Q] bool — r[j, v, q] = 1 iff from local slot v occupying state
    q a local path reaches t (or the stub of t) in the accepting state,
    with every step's target matching its state.  Leading axis F: one row
    per (query, fragment) pair."""
    F = t_slot.shape[0]
    Q = q_labels.shape[0]
    match = _match_matrix(labels, gids, q_labels, s_gid, t_gid)
    match[:, n_max, :] = False
    r = torch.zeros((F, n_max + 1, Q), dtype=torch.bool, device=t_slot.device)
    rows = torch.arange(F, device=t_slot.device)
    tl = t_slot.long()
    r[rows, tl, Q - 1] = (tl < n_max) & match[rows, tl, Q - 1]
    tf_t = q_trans.float().T.contiguous()
    if not bool(r.any()):
        return r
    with FIXPOINT:
        while True:
            back = _gather_scatter_or(r & match, edst, esrc)   # [F, n+1, Q']
            new = r | _advance(back, tf_t)
            if torch.equal(new, r):
                return r
            r = new


def local_eval_regular(esrc, edst, src_local, src_row, tgt_local, labels,
                       gids, q_labels, q_trans, s_local, t_local, s_gid,
                       t_gid, *, n_max: int, B: int):
    """localEval_r (paper Fig. 7) on F fragments: the product-automaton
    rvset rows ``(rows [r], block [r, B*Q] bool)`` of the dependency matrix
    [(B*Q), (B*Q)].

    Row (v, q0) = v*Q + q0: the source pair "in-node v occupying state q0";
    column (w, q') = w*Q + q': "a path leaves the fragment arriving at
    virtual node w in state q'" (or arrives at t in q').  Each row is
    computed by the one fragment that owns it (see the note above
    :func:`local_eval_reach`).  All fragment arguments carry a leading [F]
    axis; s_local/t_local are [F]; s_gid/t_gid are [F] or scalars.
    """
    k = esrc.shape[0]
    Q = q_labels.shape[0]
    dev = esrc.device
    src_local, src_row = _with_query_source(src_local, src_row, s_local,
                                            n_max, B)
    S = src_local.shape[1]
    match = _match_matrix(labels, gids, q_labels, s_gid, t_gid)
    match[:, n_max, :] = False                                # [k, n+1, Q]

    # frontier[f, j*Q + q0, v, q]: from source pair (src j of fragment f,
    # state q0) one can reach local slot v occupying state q
    sl = src_local.long()
    src_match = torch.gather(match, 1, sl[:, :, None].expand(k, S, Q))
    eye = torch.eye(Q, dtype=torch.bool, device=dev)
    seed = src_match[:, :, :, None] & eye                     # [k, S, Q, Q]
    frontier = torch.zeros((k, S, Q, n_max + 1, Q), dtype=torch.bool,
                           device=dev)
    frontier.scatter_(3, sl[:, :, None, None, None].expand(k, S, Q, 1, Q),
                      seed[:, :, :, None, :])
    frontier[:, :, :, n_max, :] = False
    frontier = frontier.reshape(k, S * Q, n_max + 1, Q)

    tf = q_trans.float()
    E = esrc.shape[1]
    shape = (k, S * Q, E, Q)
    src = esrc.long()[:, None, :, None].expand(shape)
    dst = edst.long()[:, None, :, None].expand(shape)
    if bool(frontier.any()):
        with FIXPOINT:
            while True:
                msgs = torch.gather(_advance(frontier, tf), 2, src)
                agg = torch.zeros(frontier.shape, dtype=torch.uint8,
                                  device=dev)
                agg.scatter_reduce_(2, dst, msgs.view(torch.uint8), "amax")
                new = frontier | (agg.view(torch.bool) & match[:, None])
                if torch.equal(new, frontier):
                    break
                frontier = new

    cols = _target_cols(tgt_local, t_local, n_max, B)         # [k, B]
    out = torch.gather(frontier, 2,
                       cols[:, None, :, None].expand(k, S * Q, B, Q))
    out = out & (cols != n_max)[:, None, :, None]
    out = out.reshape(k * S * Q, B * Q)
    q = torch.arange(Q, device=dev)
    rows = (src_row.long()[:, :, None] * Q + q).reshape(-1)
    owned = (src_row.long() < B)[:, :, None].expand(k, S, Q).reshape(-1)
    keep = torch.nonzero(owned)[:, 0]
    return rows[keep], out[keep]


def regular_rvset(esrc, edst, src_local, src_row, tgt_local, labels, gids,
                  q_labels, q_trans, s_local, t_local, s_gid, t_gid, *,
                  n_max: int, B: int, side: int):
    """The product rvset of F fragments assembled into one bool matrix
    [side, side]: the first ``side`` rows and columns of the [(B*Q), (B*Q)]
    dependency matrix (``side = nb*Q`` cuts off the query slots).  Built
    one fragment at a time, so the product frontier of only one fragment
    is alive at once, into zero-padded storage (rows 16 bytes apart, as
    evalDG's fixpoint reads them); arguments as for
    :func:`local_eval_regular`, with s_gid/t_gid scalars."""
    D = padded_zeros(side, side, esrc.device)
    for f in range(esrc.shape[0]):
        one = slice(f, f + 1)
        rows, block = local_eval_regular(
            esrc[one], edst[one], src_local[one], src_row[one],
            tgt_local[one], labels[one], gids[one], q_labels, q_trans,
            s_local[one], t_local[one], s_gid, t_gid, n_max=n_max, B=B)
        keep = torch.nonzero(rows < side)[:, 0]
        D[rows[keep]] = block[keep, :side]
    return D
