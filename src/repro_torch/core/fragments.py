"""Fragmentation F = (F, G_f) of a graph (paper Section 2.1), padded so that
one batched program evaluates every fragment at once.

Host-side preparation (numpy) that turns ``(Graph, partition)`` into
stacked ``[k, ...]`` per-fragment arrays.

Local node layout inside fragment ``F_i`` (paper Fig. 1 / Sec 2.1):

  * locals ``0 .. n_i-1``       — the real nodes ``V_i`` (partition class i);
  * locals ``n_i .. n_i+o_i-1`` — *virtual nodes* ``F_i.O``: one stub per
    distinct cross-edge target (labels copied from the target node so that
    regular queries can match on them);
  * local ``n_max``             — a pad node; pad edges self-loop on it.

The fragment graph's node set ``V_f`` is ``bnodes``: every node with an
incoming cross edge, plus two reserved slots for the query endpoints: row
``B-2`` is ``s`` and column ``B-1`` is ``t``.  ``reserve_*`` headroom adds
spare boundary positions ``nb_active .. nb_cap-1`` that stay inert (no
source row maps to them and their target columns point at the pad node).

Dynamic graphs: a fragmentation built with ``reserve_*`` headroom also
carries spare edge slots, virtual-stub slots and source rows, so
:meth:`Fragmentation.apply_delta` absorbs edge insertions and deletions
without changing any array shape; when a reserve runs out it rebuilds the
whole fragmentation with the same headroom.  Cache repair is the job of
:mod:`repro_torch.core.incremental`, which calls it first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..graph.graph import Graph
from ..kernels.bitpack_ops.ops import packed_bits


@dataclasses.dataclass
class GraphDelta:
    """A batch of edge insertions and deletions against a fragmented graph.

    Node set and partition are fixed; only edges change (the paper's
    fragmentation is node-partitioned, so edge churn never moves a node
    between sites).  Deletions must name existing edges; one (u, v) entry
    removes one occurrence (multi-edges are deleted one at a time).
    """

    add_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    add_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    del_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    del_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))

    def __post_init__(self):
        for name in ("add_src", "add_dst", "del_src", "del_dst"):
            setattr(self, name, np.asarray(getattr(self, name),
                                           dtype=np.int64).reshape(-1))
        if self.add_src.shape != self.add_dst.shape:
            raise ValueError("add_src and add_dst differ in length")
        if self.del_src.shape != self.del_dst.shape:
            raise ValueError("del_src and del_dst differ in length")

    @property
    def n_add(self) -> int:
        return int(self.add_src.size)

    @property
    def n_del(self) -> int:
        return int(self.del_src.size)

    def is_empty(self) -> bool:
        return self.n_add == 0 and self.n_del == 0

    @classmethod
    def insert(cls, edges) -> "GraphDelta":
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        return cls(add_src=e[:, 0], add_dst=e[:, 1])

    @classmethod
    def delete(cls, edges) -> "GraphDelta":
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        return cls(del_src=e[:, 0], del_dst=e[:, 1])


@dataclasses.dataclass
class DeltaReport:
    """What :meth:`Fragmentation.apply_delta` changed (drives cache repair)."""

    dirty: np.ndarray            # [k] bool: fragments with local changes
    new_boundary: List[int]      # global ids activated into spare slots
    n_add_intra: int = 0
    n_add_cross: int = 0
    n_del: int = 0
    rebuilt: bool = False        # a reserve ran out: rebuilt from scratch
    reason: str = ""


@dataclasses.dataclass
class Fragmentation:
    """Host metadata + stacked padded per-fragment arrays."""

    g: Graph
    part: np.ndarray          # [n] fragment id per node
    k: int                    # number of fragments (sites)
    bnodes: np.ndarray        # [nb_active] global ids of boundary nodes (V_f)
    b_index: np.ndarray       # [n] position in bnodes or -1
    n_max: int                # max local slots (real + stubs) over fragments
    e_max: int                # max local edges over fragments
    s_max: int                # max sources per fragment (in-nodes + 1 for s)
    arrays: Dict[str, np.ndarray]   # stacked [k, ...] arrays
    frag_sizes: np.ndarray    # [k] |F_i| = n_i + e_i  (paper's |F_i|)
    owner_local: np.ndarray   # [n] local index of a node in its own fragment
    nb_cap: int = -1          # boundary slot capacity (-1: len(bnodes))
    # --- dynamic-graph bookkeeping (host-side; see apply_delta) ------------
    n_edges: np.ndarray = dataclasses.field(default=None, repr=False,
                                            compare=False)   # [k] used slots
    src_fill: np.ndarray = dataclasses.field(default=None, repr=False,
                                             compare=False)  # [k] used rows
    stubs: List[dict] = dataclasses.field(default=None, repr=False,
                                          compare=False)  # gid -> stub slot
    reserve: Dict[str, int] = dataclasses.field(default=None, repr=False,
                                                compare=False)
    # bumped on every in-place mutation of the host arrays (apply_delta,
    # rebuild); consumers that memoize device uploads key on it
    arrays_version: int = 0
    # amortized rvset cache (built lazily by core.cache.get_rvset_cache)
    rvset_cache: object = dataclasses.field(default=None, repr=False,
                                            compare=False)
    _slot_of: np.ndarray = dataclasses.field(default=None, repr=False,
                                             compare=False)

    @classmethod
    def from_numpy(cls, fields: dict) -> "Fragmentation":
        """Rebuild a fragmentation from plain numpy fields: ``n``, ``src``,
        ``dst``, ``labels`` (and optionally ``label_names``) of the graph,
        then ``part``, ``k``, ``bnodes``, ``b_index``, ``n_max``, ``e_max``,
        ``s_max``, ``arrays`` (a dict), ``frag_sizes``, ``owner_local``,
        ``nb_cap`` and optionally ``arrays_version`` and the dynamic
        bookkeeping ``n_edges``, ``src_fill``, ``stubs`` (a list of dicts)
        and ``reserve`` (a dict).  Every array is copied, so the caller's
        buffers are never shared."""
        g = Graph(int(fields["n"]), np.array(fields["src"]),
                  np.array(fields["dst"]), np.array(fields["labels"]),
                  fields.get("label_names"))

        def copied(name):
            v = fields.get(name)
            return None if v is None else np.array(v)

        stubs, reserve = fields.get("stubs"), fields.get("reserve")
        return cls(g=g, part=np.array(fields["part"], dtype=np.int32),
                   k=int(fields["k"]), bnodes=np.array(fields["bnodes"]),
                   b_index=np.array(fields["b_index"]),
                   n_max=int(fields["n_max"]), e_max=int(fields["e_max"]),
                   s_max=int(fields["s_max"]),
                   arrays={name: np.array(v)
                           for name, v in fields["arrays"].items()},
                   frag_sizes=np.array(fields["frag_sizes"]),
                   owner_local=np.array(fields["owner_local"]),
                   nb_cap=int(fields["nb_cap"]),
                   n_edges=copied("n_edges"), src_fill=copied("src_fill"),
                   stubs=None if stubs is None else [dict(m) for m in stubs],
                   reserve=None if reserve is None else dict(reserve),
                   arrays_version=int(fields.get("arrays_version", 0)))

    @property
    def B(self) -> int:       # boundary matrix side (capacity + query slots)
        return (self.nb_cap if self.nb_cap >= 0 else len(self.bnodes)) + 2

    @property
    def n_boundary(self) -> int:   # boundary matrix rows (|V_f| + spares)
        return self.B - 2

    @property
    def nb_active(self) -> int:    # |V_f| proper: activated boundary slots
        return len(self.bnodes)

    def boundary_owner(self) -> np.ndarray:
        """[n_boundary] int32: owning fragment of each boundary slot (spare
        slots map to fragment 0 — inert, since no frontier row or target
        column ever carries data for them)."""
        own = np.zeros(self.n_boundary, dtype=np.int32)
        own[: self.nb_active] = self.part[self.bnodes]
        return own

    def boundary_local(self) -> np.ndarray:
        """[n_boundary] int32: local slot of each boundary node inside its
        owning fragment (pad slot ``n_max`` for spare positions)."""
        loc = np.full(self.n_boundary, self.n_max, dtype=np.int32)
        loc[: self.nb_active] = self.owner_local[self.bnodes]
        return loc

    def slot_index(self) -> np.ndarray:
        """[n, k] int32: local slot of every global node inside every
        fragment — its owned slot in its home fragment, its virtual-stub
        slot in fragments that have a cross edge to it, ``n_max`` elsewhere.
        Built once and memoized."""
        if self._slot_of is None:
            slot_of = np.full((self.g.n, self.k), self.n_max, dtype=np.int32)
            gids = self.arrays["gids"]               # [k, n_max+1], pad -1
            for f in range(self.k):
                valid = np.nonzero(gids[f] >= 0)[0]
                slot_of[gids[f, valid], f] = valid
            self._slot_of = slot_of
        return self._slot_of

    @property
    def S_ROW(self) -> int:   # reserved boundary row/col for s
        return self.B - 2

    @property
    def T_COL(self) -> int:   # reserved boundary col for t
        return self.B - 1

    def fragment_of(self, v: int) -> int:
        """The fragment (site) that owns node ``v``."""
        return int(self.part[v])

    def traffic_bits_reach(self) -> int:
        """Upper bound the paper proves: O(|V_f|^2) bits of rvset payload."""
        return self.B * self.B

    def packed_traffic_bits(self, states: int = 1) -> int:
        """Bits the one collective ships once the Boolean payload is
        bitpacked into uint32 words: rows x ceil(cols/32) words.
        ``states`` > 1 gives the product-automaton (B*|Q|)^2 case."""
        side = self.B * states
        return packed_bits(side, side)

    def traffic_bits(self, kind: str = "reach", states: int = 1,
                     batch: Optional[int] = None) -> int:
        """Wire size of the ONE collective, the same formula as the
        reference package so ``QueryStats.payload_bits`` agree bit for bit.

        Single query (``batch=None``): Boolean kinds ship the bitpacked
        ``B*states`` square, the tropical kinds the raw int32 square.
        Fused batch (``batch=N``): the ``side = |V_f| * states`` boundary
        rows plus one s-row and one t-column per query, each ``side + 1``
        wide; bitpacked for Boolean kinds, raw int32 for tropical ones.
        """
        if kind not in ("reach", "dist", "bounded", "rpq"):
            raise ValueError(f"unknown query kind {kind!r}; expected one of "
                             "('reach', 'dist', 'bounded', 'rpq')")
        if batch is None:
            if kind in ("reach", "rpq"):
                return self.packed_traffic_bits(states=states)
            side = self.B * states
            return side * side * 32
        side = self.n_boundary * states
        rows, cols = side + 2 * batch, side + 1
        if kind in ("reach", "rpq"):
            return packed_bits(rows, cols)
        return rows * cols * 32

    def traffic_bits_update(self, r: int) -> int:
        """Wire size of the ONE collective of a sharded cache repair
        (``core.distributed.update_rows_sharded``) over ``r`` changed
        boundary rows (padded count): each row ships its D0 row bitpacked,
        ``ceil(nb/32)`` words, and its resumed frontier row bitpacked,
        ``ceil((n_max+1)/32)`` words.  The first term is the reference
        package's payload; the second scales with the largest fragment,
        not with |G|, and is what the reference gathers to the host
        without counting it."""
        words = (self.n_boundary + 31) // 32 + (self.n_max + 1 + 31) // 32
        return r * 32 * words

    def largest_fragment(self) -> int:
        return int(self.frag_sizes.max())

    # -- rollback snapshots (failed-delta recovery) -------------------------

    def snapshot(self) -> dict:
        """Capture every piece of host state a delta (apply + cache repair)
        can touch, so a failed update can roll back to a consistent
        pre-delta point.  Arrays that :meth:`apply_delta` mutates in place
        are copied; fields that are only ever rebound wholesale (``g``,
        ``bnodes``, the rebinds of :meth:`_rebuild_in_place`) are captured
        by reference.  The attached rvset cache is snapshotted too: its
        repairs bind new tensors and never write into old ones, so its
        snapshot holds references."""
        snap = {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}
        snap["arrays"] = {k: v.copy() for k, v in self.arrays.items()}
        snap["b_index"] = self.b_index.copy()
        snap["frag_sizes"] = self.frag_sizes.copy()
        for name in ("n_edges", "src_fill", "_slot_of"):
            v = getattr(self, name)
            if v is not None:
                snap[name] = v.copy()
        if self.stubs is not None:
            snap["stubs"] = [dict(m) for m in self.stubs]
        snap["_cache_state"] = (None if self.rvset_cache is None
                                else self.rvset_cache.snapshot())
        return snap

    def restore(self, snap: dict) -> None:
        """Roll back to a :meth:`snapshot`: ``arrays_version`` and the
        attached cache's ``version`` return to their pre-delta values and
        all host arrays to their pre-delta contents.  The memoized sharded
        device uploads (``core.distributed._device_inputs``) are dropped:
        they are keyed on ``arrays_version``, which a later delta can bump
        back to a value already used, so a stale entry must never survive
        a rollback."""
        cache_state = snap["_cache_state"]
        for f in dataclasses.fields(self):
            setattr(self, f.name, snap[f.name])
        if self.rvset_cache is not None and cache_state is not None:
            self.rvset_cache.restore(cache_state)
        self.__dict__.pop("_sharded_device_inputs", None)

    # -- dynamic updates -----------------------------------------------------

    def apply_delta(self, delta: GraphDelta) -> DeltaReport:
        """Apply a :class:`GraphDelta` to the fragmentation in place.

        Insertions land in pre-allocated padded slots (edges, virtual stubs,
        source rows, boundary positions), so no array changes shape;
        deletions compact the owning fragment's edge list.  When any
        reserve runs out, the whole fragmentation is rebuilt from the
        updated graph (``report.rebuilt``) with the same headroom.  Only
        host structures change here."""
        g_new = self._updated_graph(delta)
        report = DeltaReport(dirty=np.zeros(self.k, dtype=bool),
                             new_boundary=[], n_del=delta.n_del)
        if delta.is_empty():
            return report
        try:
            self._apply_insertions(delta, report)
            self._apply_deletions(delta, report)
        except _CapacityExceeded as exc:
            self._rebuild_in_place(g_new)
            report.dirty[:] = True
            report.rebuilt = True
            report.reason = str(exc)
            return report
        self.g = g_new
        self.arrays_version += 1
        return report

    def _updated_graph(self, delta: GraphDelta) -> Graph:
        """The post-delta graph; raises ValueError for a deletion of a
        missing edge or an endpoint out of range, and leaves ``self.g``
        untouched.  One sort of the edge keys: O((m + n_del) log m)."""
        g = self.g
        keep = np.ones(g.m, dtype=bool)
        if delta.n_del:
            key = g.src * np.int64(g.n) + g.dst
            order = np.argsort(key, kind="stable")
            skey = key[order]
            taken: Dict[int, int] = {}      # duplicate deletes take distinct ids
            for u, v in zip(delta.del_src, delta.del_dst):
                kk = int(u) * g.n + int(v)
                lo = int(np.searchsorted(skey, kk, "left"))
                hi = int(np.searchsorted(skey, kk, "right"))
                j = lo + taken.get(kk, 0)
                if j >= hi:
                    raise ValueError(
                        f"delta deletes nonexistent edge {u}->{v}")
                taken[kk] = taken.get(kk, 0) + 1
                keep[order[j]] = False
        if delta.n_add:
            ends = np.concatenate([delta.add_src, delta.add_dst])
            if ends.min(initial=0) < 0 or ends.max(initial=-1) >= g.n:
                raise ValueError("delta inserts edge with out-of-range "
                                 f"node id (n={g.n})")
        src = np.concatenate([g.src[keep], delta.add_src])
        dst = np.concatenate([g.dst[keep], delta.add_dst])
        return Graph(g.n, src, dst, g.labels, g.label_names)

    def _apply_insertions(self, delta: GraphDelta, report: DeltaReport):
        esrc, edst = self.arrays["esrc"], self.arrays["edst"]
        for u, w in zip(delta.add_src, delta.add_dst):
            i = int(self.part[u])
            if self.part[w] == i:                      # intra-fragment edge
                dst_slot = int(self.owner_local[w])
                report.n_add_intra += 1
            else:                                      # cross edge -> stub
                self._ensure_boundary(int(w), report)
                dst_slot = self._ensure_stub(i, int(w))
                report.n_add_cross += 1
            slot = int(self.n_edges[i])
            if slot >= self.e_max:
                raise _CapacityExceeded(f"edge slots of fragment {i}")
            esrc[i, slot] = self.owner_local[u]
            edst[i, slot] = dst_slot
            self.n_edges[i] += 1
            self.frag_sizes[i] += 1
            report.dirty[i] = True

    def _apply_deletions(self, delta: GraphDelta, report: DeltaReport):
        esrc, edst = self.arrays["esrc"], self.arrays["edst"]
        for u, w in zip(delta.del_src, delta.del_dst):
            i = int(self.part[u])
            if self.part[w] == i:
                dst_slot = int(self.owner_local[w])
            else:
                dst_slot = self.stubs[i].get(int(w), -1)
            ne = int(self.n_edges[i])
            hits = np.nonzero((esrc[i, :ne] == self.owner_local[u])
                              & (edst[i, :ne] == dst_slot))[0]
            if dst_slot < 0 or hits.size == 0:
                raise _CapacityExceeded(   # stale bookkeeping: rebuild
                    f"deleted edge {u}->{w} not found in fragment {i}")
            j = int(hits[0])
            esrc[i, j], edst[i, j] = esrc[i, ne - 1], edst[i, ne - 1]
            esrc[i, ne - 1] = edst[i, ne - 1] = self.n_max     # pad self-loop
            self.n_edges[i] -= 1
            self.frag_sizes[i] -= 1
            report.dirty[i] = True
        # boundary membership and stubs stay as they are on deletion: a
        # boundary node with no in-edges left is inert (sound, it costs one
        # slot) until the repair debt in core.incremental forces a rebuild

    def _ensure_boundary(self, w: int, report: DeltaReport):
        """Activate node ``w`` as a boundary in-node in a spare slot."""
        if self.b_index[w] >= 0:
            return
        pos = self.nb_active
        if pos >= self.n_boundary:
            raise _CapacityExceeded("boundary slots")
        j = int(self.part[w])                 # the owner gains a source row
        row = int(self.src_fill[j])
        if row >= self.s_max - 1:             # the last row is kept for s
            raise _CapacityExceeded(f"source rows of fragment {j}")
        self.arrays["src_local"][j, row] = self.owner_local[w]
        self.arrays["src_row"][j, row] = pos
        self.src_fill[j] += 1
        self.b_index[w] = pos
        self.bnodes = np.append(self.bnodes, w)
        report.dirty[j] = True
        report.new_boundary.append(w)

    def _ensure_stub(self, i: int, w: int) -> int:
        """Virtual-stub slot of global node ``w`` inside fragment ``i``."""
        slot = self.stubs[i].get(w)
        if slot is not None:
            return slot
        slot = int(self.arrays["n_local"][i])
        if slot >= self.n_max:
            raise _CapacityExceeded(f"local slots of fragment {i}")
        self.stubs[i][w] = slot
        self.arrays["gids"][i, slot] = w
        self.arrays["labels"][i, slot] = self.g.labels[w]
        self.arrays["n_local"][i] = slot + 1
        self.arrays["tgt_local"][i, self.b_index[w]] = slot
        if self._slot_of is not None:
            self._slot_of[w, i] = slot
        return slot

    def rebuild(self) -> None:
        """Re-fragment the current graph from scratch (compacts the stale
        boundary slots and stubs that deletions leave behind, and restores
        the full reserve headroom).  Drops the attached cache."""
        self._rebuild_in_place(self.g)

    def _rebuild_in_place(self, g_new: Graph):
        """Re-fragment the updated graph with the same reserves and adopt
        the result, keeping this object's identity (callers hold it)."""
        version = self.arrays_version
        fresh = fragment_graph(g_new, self.part, self.k,
                               **(self.reserve or {}))
        for field in dataclasses.fields(self):
            setattr(self, field.name, getattr(fresh, field.name))
        self.rvset_cache = None
        self.arrays_version = version + 1


class _CapacityExceeded(Exception):
    """A delta outgrew the pre-allocated padded slots: rebuild instead."""


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def fragment_graph(g: Graph, part: np.ndarray, k: int,
                   pad_multiple: int = 8, reserve_boundary: int = 0,
                   reserve_edges: int = 0, reserve_stubs: int = 0,
                   reserve_sources: Optional[int] = None) -> Fragmentation:
    """Build the padded fragmentation (host, numpy).

    ``reserve_*`` pre-allocate headroom for :meth:`Fragmentation.apply_delta`
    (spare boundary positions, edge slots, virtual-node slots and source
    rows per fragment); ``reserve_sources`` defaults to ``reserve_boundary``
    (the worst case is every new in-node landing in one fragment).
    """
    part = np.asarray(part, dtype=np.int32)
    if part.shape != (g.n,):
        raise ValueError(f"part must be [{g.n}], got {part.shape}")
    if part.min(initial=0) < 0 or part.max(initial=0) >= k:
        raise ValueError(f"fragment ids must lie in [0, {k})")
    if reserve_sources is None:
        reserve_sources = reserve_boundary

    cross_mask = part[g.src] != part[g.dst]
    bnodes = np.unique(g.dst[cross_mask])          # in-nodes == V_f core
    b_index = np.full(g.n, -1, dtype=np.int64)
    b_index[bnodes] = np.arange(len(bnodes))
    nb_cap = len(bnodes) + reserve_boundary
    B = nb_cap + 2

    # --- per-fragment local structures -------------------------------------
    glists = [np.where(part == i)[0] for i in range(k)]
    g2l = np.full(g.n, -1, dtype=np.int64)
    for gl in glists:
        g2l[gl] = np.arange(len(gl))

    frag_src = [[] for _ in range(k)]
    frag_dst = [[] for _ in range(k)]
    stub_maps: list[dict] = [dict() for _ in range(k)]   # global id -> stub

    src_part = part[g.src]
    internal = ~cross_mask
    for i in range(k):
        sel = internal & (src_part == i)
        frag_src[i] = list(g2l[g.src[sel]])
        frag_dst[i] = list(g2l[g.dst[sel]])
    # cross edges -> stubs
    cs, cd = g.src[cross_mask], g.dst[cross_mask]
    for u, w in zip(cs, cd):
        i = int(part[u])
        sm = stub_maps[i]
        if int(w) not in sm:
            sm[int(w)] = len(glists[i]) + len(sm)
        frag_src[i].append(int(g2l[u]))
        frag_dst[i].append(sm[int(w)])

    n_locals = [len(glists[i]) + len(stub_maps[i]) for i in range(k)]
    n_max = _round_up((max(n_locals) if k else 1) + reserve_stubs,
                      pad_multiple)
    e_max = _round_up(max((len(frag_src[i]) for i in range(k)), default=1)
                      + reserve_edges, pad_multiple)
    e_max = max(e_max, 1)

    in_counts = [int(np.sum(part[bnodes] == i)) for i in range(k)] or [0]
    s_maxr = max(in_counts) + 1 + reserve_sources  # +1 reserved slot for s

    esrc = np.full((k, e_max), n_max, dtype=np.int32)
    edst = np.full((k, e_max), n_max, dtype=np.int32)
    gids = np.full((k, n_max + 1), -1, dtype=np.int32)
    labels = np.full((k, n_max + 1), -9, dtype=np.int32)
    src_local = np.full((k, s_maxr), n_max, dtype=np.int32)
    src_row = np.full((k, s_maxr), B, dtype=np.int32)      # B == dropped
    tgt_local = np.full((k, B), n_max, dtype=np.int32)

    for i in range(k):
        ne = len(frag_src[i])
        esrc[i, :ne] = frag_src[i]
        edst[i, :ne] = frag_dst[i]
        nl = len(glists[i])
        gids[i, :nl] = glists[i]
        labels[i, :nl] = g.labels[glists[i]]
        for w, loc in stub_maps[i].items():
            gids[i, loc] = w
            labels[i, loc] = g.labels[w]
        # sources: in-nodes owned by this fragment
        mine = bnodes[part[bnodes] == i]
        src_local[i, : len(mine)] = g2l[mine]
        src_row[i, : len(mine)] = b_index[mine]
        # targets: stubs for boundary nodes of other fragments
        for w, loc in stub_maps[i].items():
            tgt_local[i, b_index[w]] = loc

    frag_sizes = np.array(
        [len(glists[i]) + len(frag_src[i]) for i in range(k)], dtype=np.int64)
    arrays = dict(esrc=esrc, edst=edst, gids=gids, labels=labels,
                  src_local=src_local, src_row=src_row, tgt_local=tgt_local,
                  n_local=np.array(n_locals, dtype=np.int32))
    reserve = dict(pad_multiple=pad_multiple,
                   reserve_boundary=reserve_boundary,
                   reserve_edges=reserve_edges, reserve_stubs=reserve_stubs,
                   reserve_sources=reserve_sources)
    return Fragmentation(g=g, part=part, k=k, bnodes=bnodes, b_index=b_index,
                         n_max=n_max, e_max=e_max, s_max=s_maxr,
                         arrays=arrays, frag_sizes=frag_sizes,
                         owner_local=g2l, nb_cap=nb_cap,
                         n_edges=np.array([len(frag_src[i])
                                           for i in range(k)], np.int64),
                         src_fill=np.array(in_counts[:k] or [0], np.int64),
                         stubs=stub_maps, reserve=reserve)


# ---------------------------------------------------------------------------
# fragment -> rank placement (k >> d packing for the sharded backend)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Placement:
    """Fragment-to-rank assignment for the sharded backend.

    The paper has one *site* per fragment; a process group is usually
    smaller than a fragmentation, so the sharded engines pack several
    fragments onto each rank (``d <= k``).  Each rank runs its owned
    fragments' local stages, merges their boundary rows on the rank, and
    still ships exactly ONE collective per fused batch: the wire size is
    unchanged, and the response-time bound becomes the largest per-rank
    workload ``max_d sum_{i on d} |F_i|`` instead of the largest fragment.

    ``device_of[i]`` is the rank owning fragment ``i``.  Ranks hold at most
    :attr:`fpd` fragments; short ranks are padded with inert fragments
    (pad-only edge lists, no owned boundary rows) that contribute nothing.

    Construct with :meth:`balanced` (greedy workload balancing, the
    session's default) or :meth:`round_robin`, or pass an explicit
    ``device_of``.  Instances are frozen and hashable; :meth:`cache_key`
    keys the device-upload memo.
    """

    k: int                    # fragments
    d: int                    # ranks
    device_of: tuple          # [k] owning rank per fragment

    def __post_init__(self):
        object.__setattr__(self, "device_of",
                           tuple(int(x) for x in self.device_of))
        if self.d < 1:
            raise ValueError(f"placement needs >= 1 device, got d={self.d}")
        if self.d > self.k:
            raise ValueError(
                f"placement maps {self.k} fragments onto {self.d} devices: "
                "d > k is invalid — the sharded backend packs whole "
                "fragments onto ranks and cannot split one fragment across "
                "several; use a process group with at most k ranks")
        if len(self.device_of) != self.k:
            raise ValueError(f"device_of has {len(self.device_of)} entries "
                             f"for {self.k} fragments")
        bad = [x for x in self.device_of if not (0 <= x < self.d)]
        if bad:
            raise ValueError(f"device_of entries out of range [0, {self.d}): "
                             f"{bad[:4]}")

    @classmethod
    def round_robin(cls, k: int, d: int) -> "Placement":
        """Baseline policy: fragment ``i`` lives on rank ``i % d``."""
        return cls(k=k, d=d, device_of=tuple(i % d for i in range(k)))

    @staticmethod
    def fragment_weights(fr: Fragmentation) -> np.ndarray:
        """Per-fragment workload estimate used by :meth:`balanced`:
        ``|F_i| * (1 + b_i)`` with ``b_i`` the boundary rows fragment ``i``
        owns (each is one source of its all-sources fixpoint)."""
        b_owned = np.bincount(fr.part[fr.bnodes],
                              minlength=fr.k).astype(np.int64)
        return fr.frag_sizes.astype(np.int64) * (1 + b_owned)

    @classmethod
    def balanced(cls, fr: Fragmentation, d: int) -> "Placement":
        """Greedy boundary-size balancing (LPT list scheduling).

        Fragments go in decreasing :meth:`fragment_weights` order, each
        onto the least-loaded rank that still has a free slot (ranks hold
        at most ``ceil(k/d)`` fragments, the round-robin layout's
        :attr:`fpd`).  Guarantees ``max_load <= total/d + max_weight`` and
        is deterministic (ties go to the lowest rank)."""
        k = fr.k
        if d > k:       # same validation as __post_init__, but earlier
            return cls(k=k, d=d, device_of=())
        w = cls.fragment_weights(fr)
        cap = -(-k // d)
        loads = np.zeros(d, dtype=np.int64)
        counts = np.zeros(d, dtype=np.int64)
        device_of = np.zeros(k, dtype=np.int64)
        for i in np.argsort(-w, kind="stable"):
            cand = np.where(counts < cap, loads, np.iinfo(np.int64).max)
            dev = int(np.argmin(cand))
            device_of[i] = dev
            loads[dev] += w[i]
            counts[dev] += 1
        return cls(k=k, d=d, device_of=tuple(device_of))

    @property
    def fpd(self) -> int:
        """Owned-fragments axis length per rank (max over ranks)."""
        return int(max(np.bincount(np.asarray(self.device_of, np.int64),
                                   minlength=self.d).max(initial=0), 1))

    def perm(self) -> np.ndarray:
        """[d * fpd] int64 rank-major packing order: entry ``r*fpd + j`` is
        the fragment in slot ``j`` of rank ``r``, or ``-1`` for an inert
        pad slot."""
        fpd = self.fpd
        out = np.full(self.d * fpd, -1, dtype=np.int64)
        fill = np.zeros(self.d, dtype=np.int64)
        for i, dev in enumerate(self.device_of):
            out[dev * fpd + fill[dev]] = i
            fill[dev] += 1
        return out

    def loads(self, weights: np.ndarray) -> np.ndarray:
        """[d] summed ``weights`` per rank (``weights``: [k])."""
        return np.bincount(np.asarray(self.device_of, np.int64),
                           weights=np.asarray(weights, np.float64),
                           minlength=self.d).astype(np.int64)

    def max_load(self, fr: Fragmentation) -> int:
        """Largest per-rank workload, what the response-time bound scales
        with once fragments are packed."""
        return int(self.loads(self.fragment_weights(fr)).max(initial=0))

    def cache_key(self) -> tuple:
        """Hashable identity for the device-upload memo."""
        return (self.k, self.d, self.device_of)


def query_slots(fr: Fragmentation, s: int, t: int) -> Dict[str, np.ndarray]:
    """Per-query inputs: where s and t live.  Returns stacked [k]-arrays
    ``s_local``/``t_local`` (local index of s / t inside the owning
    fragment, pad ``n_max`` elsewhere) and the global ids."""
    k, n_max = fr.k, fr.n_max
    s_local = np.full(k, n_max, dtype=np.int32)
    t_local = np.full(k, n_max, dtype=np.int32)
    s_local[fr.part[s]] = fr.owner_local[s]
    t_local[fr.part[t]] = fr.owner_local[t]
    return dict(s_local=s_local, t_local=t_local,
                s_gid=np.int32(s), t_gid=np.int32(t))
