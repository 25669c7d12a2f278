"""Amortized rvset cache + batched multi-query engine.

The paper's guarantees are per query, but a server answers many queries
against the *same* fragmentation, and localEval splits cleanly:

* **query-independent phase** (once per Fragmentation): every fragment's
  all-sources local fixpoint, assembled into the boundary-to-boundary
  dependency matrix ``D0 [|V_f|, |V_f|]`` and closed by repeated squaring
  (``bes.bool_closure`` / ``tropical_closure``: the or-and and min-plus
  kernels);
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

Every device tensor lives on the cache's ``device``.  Uploads copy
(``torch.tensor``), never alias a host buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.bool_matmul.ops import or_and_matmul
from ..kernels.tropical_matmul.ops import min_plus_matmul
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
    part_b: np.ndarray                # [nb] owning fragment of boundary node
    bl_dist: Optional[torch.Tensor] = None       # [nb, n_max+1] int32
    dist_closure: Optional[torch.Tensor] = None  # [nb, nb] int32, diag 0
    rpq_closures: Dict[Tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict)         # automaton key -> [(nb*Q), (nb*Q)]
    version: int = 0                  # snapshot id stamped on results

    @property
    def nb(self) -> int:
        return self.fr.n_boundary


def _upload(x, device) -> torch.Tensor:
    """Copy a host array onto ``device`` (never an alias of ``x``)."""
    return torch.tensor(np.asarray(x), device=device)


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
        C = bes.bool_closure(_gather_boundary_matrix(fr, bl, part_b))
        cache = RvsetCache(fr=fr, device=device, arrays=arrs, bl_frontier=bl,
                           closure=C, part_b=part_b)
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
    arrays.  Every array is copied onto ``device``."""
    device = torch.device(device)
    dist = arrays.get("bl_dist")
    cache = RvsetCache(
        fr=fr, device=device, arrays=_upload_arrays(fr, device),
        bl_frontier=_upload(arrays["bl_frontier"], device),
        closure=_upload(arrays["closure"], device),
        part_b=fr.boundary_owner(),
        bl_dist=None if dist is None else _upload(dist, device),
        dist_closure=(None if dist is None
                      else _upload(arrays["dist_closure"], device)))
    fr.rvset_cache = cache
    return cache


# ---------------------------------------------------------------------------
# combine stage: compose the per-query phase through a closure
# ---------------------------------------------------------------------------

def combine_bool(direct, sb, tc, C):
    """``ans = direct | OR_u (sb (or-and) C)[u] & tc[u]``.

    ``sb``/``tc`` [N, side], ``C`` [side, side] with ``side = nb`` for plain
    reachability or ``nb * |Q|`` for the product-automaton (RPQ) case.
    """
    if C.shape[0] == 0:
        return direct
    sbc = or_and_matmul(sb, C)                             # [N, side]
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
# batched per-query phase
# ---------------------------------------------------------------------------

def _per_query(fr, cache, frag_s, s_slot, t_slot_sfrag, single_source):
    """Single-source propagation of every pair on its source's fragment;
    returns (direct [N], sb [N, nb])."""
    arrs = cache.arrays
    f = single_source(arrs["esrc"][frag_s], arrs["edst"][frag_s], s_slot,
                      n_max=fr.n_max)                      # [N, n+1]
    direct = torch.gather(f, 1, t_slot_sfrag[:, None])[:, 0]
    tgt_s = arrs["tgt_local"][frag_s][:, : cache.nb].long()
    return direct, torch.gather(f, 1, tgt_s)


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
    dev = cache.device
    return tuple(torch.tensor(x, dtype=torch.long, device=dev)
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
    frag_s, s_slot, t_slot_sfrag, t_cols = _batch_inputs(fr, cache, pairs)
    direct, sb = _per_query(fr, cache, frag_s, s_slot, t_slot_sfrag,
                            engine.single_source_reach)
    tc = _t_column(cache.bl_frontier, t_cols)
    return combine_bool(direct, sb, tc, cache.closure).cpu().numpy()


def dis_dist_batch(fr: Fragmentation, pairs, device,
                   bound: Optional[int] = None) -> np.ndarray:
    """N shortest distances (or bounded-reachability answers when ``bound``
    is given: dist <= bound).  Returns [N] int64 distances with -1 for
    unreachable, or [N] bool when ``bound`` is not None."""
    pairs = _as_pairs(pairs)
    if len(pairs) == 0:
        return np.zeros(0, dtype=bool if bound is not None else np.int64)
    cache = get_rvset_cache(fr, device, with_dist=True)
    frag_s, s_slot, t_slot_sfrag, t_cols = _batch_inputs(fr, cache, pairs)
    direct, sb = _per_query(fr, cache, frag_s, s_slot, t_slot_sfrag,
                            engine.single_source_dist)
    tc = _t_column(cache.bl_dist, t_cols)
    d = combine_dist(direct, sb, tc,
                     cache.dist_closure).cpu().numpy().astype(np.int64)
    if bound is not None:
        return d <= bound
    d[d >= INF] = -1
    return d


# ---------------------------------------------------------------------------
# regular (RPQ) cached path
# ---------------------------------------------------------------------------

def product_closure(fr: Fragmentation, qa: QueryAutomaton,
                    device) -> torch.Tensor:
    """Query-independent product-automaton closure [(nb*Q), (nb*Q)].

    Sound because the Glushkov automaton's u_s has no incoming and u_t no
    outgoing transitions: neither s-only nor t-only states can occur
    strictly inside a boundary-to-boundary path, so matching them off
    (NO_NODE gid) loses nothing the per-query phase doesn't re-add.
    """
    cache = get_rvset_cache(fr, device)
    key = qa.cache_key()
    C = cache.rpq_closures.get(key)
    if C is not None:
        # true LRU: a hit moves the key back to the MRU end of the (insert-
        # ordered) dict, so a hot automaton is never FIFO-evicted by churn
        cache.rpq_closures.pop(key)
        cache.rpq_closures[key] = C
        return C
    arrs = cache.arrays
    dev = cache.device
    k, n_max, B, Q = fr.k, fr.n_max, fr.B, qa.n_states
    no_slot = torch.full((k,), n_max, dtype=torch.int32, device=dev)
    D = engine.local_eval_regular(
        arrs["esrc"], arrs["edst"], arrs["src_local"], arrs["src_row"],
        arrs["tgt_local"], arrs["labels"], arrs["gids"],
        _upload(qa.state_labels, dev), _upload(qa.trans, dev),
        no_slot, no_slot, NO_NODE, NO_NODE, n_max=n_max, B=B)
    nb = fr.n_boundary
    D = D.reshape(B, Q, B, Q)[:nb, :, :nb, :].reshape(nb * Q, nb * Q)
    C = bes.bool_closure(D)
    # bound the per-automaton cache; dict order is recency order, so the
    # first key is the least recently used one
    while len(cache.rpq_closures) >= MAX_RPQ_CLOSURES:
        cache.rpq_closures.pop(next(iter(cache.rpq_closures)))
    cache.rpq_closures[key] = C
    return C


def _batch_rpq(fr, cache, qa, C, pairs):
    """N pairs -> N answers for ONE automaton against its cached product
    closure: per pair one forward product propagation from (s, u_s) on s's
    fragment and k reverse product propagations to (t, u_t) (one per
    fragment — the t-column); then ONE or-and product
    [N, nb*Q] x [(nb*Q), (nb*Q)] composes them through the closure."""
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
                        tc.reshape(N, nb * Q), C)


def dis_rpq_batch(fr: Fragmentation, pairs, qa: QueryAutomaton,
                  device) -> np.ndarray:
    """Answer N (s, t) regular path queries for one automaton against the
    cached product closure on ``device``.  Returns [N] bool."""
    pairs = _as_pairs(pairs)
    if len(pairs) == 0:
        return np.zeros(0, dtype=bool)
    C = product_closure(fr, qa, device)
    cache = get_rvset_cache(fr, device)
    ans = _batch_rpq(fr, cache, qa, C, pairs).cpu().numpy().copy()
    ans[pairs[:, 0] == pairs[:, 1]] = bool(qa.nullable)  # s == t is |R|-free
    return ans
