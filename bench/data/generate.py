"""The benchmark's inputs, made from ``--seed``: the graph, its partition,
the read requests, their arrival times and the graph deltas.

Each piece is found by the name the configuration or the traffic mix
gives it, in a file of its own (:func:`bench.spec.component`): the graph
generator in ``bench/data/graphs/``, the partitioner in
``bench/data/partitions/``, the sampler of read pairs in
``bench/traffic/pairs/``, the arrival process in
``bench/traffic/arrivals/`` and each delta shape in
``bench/traffic/deltas/``.  They are frozen copies of the generators the
program ships and of ``chip_smoke.py``'s delta streams, so that a later
change to the program's generators does not change what the benchmark
measures.  Every stream draws from its own ``numpy`` generator seeded with
``[seed, stream]``: one seed gives the same inputs, and a change to one
stream's length leaves the others as they were.

Work is fixed and only its order and names come from the seed: every seed
has the same graph up to a relabelling (:func:`make_graph`), the same
number of reads of each kind, the same number of deltas of each shape, and
arrivals from a process that draws the same set of gaps.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from bench.spec import BENCH, component

(GRAPH, PARTITION, QUERIES, ARRIVALS, DELTAS, WARMUP, WARMUP_DELTAS,
 DELTA_ARRIVALS) = range(8)

#: the read kinds a traffic mix may name, in the order of its shares (a
#: kind added at the end, with no share, leaves every older mix's draws as
#: they were)
KINDS = ("reach", "dist", "bounded", "rpq")

#: what a traffic mix that names no sampler or arrival process gets
DEFAULT_PAIRS = {"sampler": "uniform"}
DEFAULT_ARRIVALS = {"process": "poisson_quantiles"}


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


@dataclasses.dataclass
class GraphData:
    """A node-labelled directed graph in COO form and its partition."""

    n: int
    src: np.ndarray      # [m] int64
    dst: np.ndarray      # [m] int64
    labels: np.ndarray   # [n] int32
    part: np.ndarray     # [n] int32 fragment of each node
    k: int


def make_graph(config: dict, seed: int, bench_dir: Path = BENCH
               ) -> GraphData:
    """The configuration's graph and partition, named for ``seed``.

    The configuration's ``generator`` and ``partitioner`` draw one graph,
    from its ``graph_seed``; ``seed`` permutes its node ids, its fragment
    ids and the order of its edges.  So every seed runs the same
    fragmented graph up to isomorphism (the same fragment sizes, boundary,
    closures and fixpoint depths: the same work) under other names, and a
    change of seed changes the inputs, not the amount of work."""
    base = config["graph_seed"]
    src, dst, labels = component("data/graphs", config["generator"],
                                 bench_dir).make(config, rng(base, GRAPH))
    part = component("data/partitions", config["partitioner"],
                     bench_dir).make(config, src, dst, rng(base, PARTITION))
    n, k = len(labels), int(config["n_fragments"])
    gen = rng(seed, GRAPH)
    node = gen.permutation(n)            # the new id of node i
    frag = gen.permutation(k)            # the new id of fragment f
    order = gen.permutation(len(src))
    new_labels = np.empty_like(labels)
    new_labels[node] = labels
    new_part = np.empty_like(part)
    new_part[node] = frag[part]
    return GraphData(n, node[src][order], node[dst][order], new_labels,
                     new_part.astype(np.int32), k)


@dataclasses.dataclass
class Read:
    """One read request: ``kind`` in :data:`KINDS`, endpoints, the hop
    bound of a bounded read and the regular expression of an rpq read."""

    kind: str
    s: int
    t: int
    bound: int = 0
    regex: str = ""


def _balanced(count: int, shares, gen: np.random.Generator) -> np.ndarray:
    """``count`` indices into ``shares``, each appearing its share of the
    count (largest remainders get the rest), in an order from ``gen``."""
    shares = np.asarray(shares, dtype=np.float64)
    exact = count * shares / shares.sum()
    whole = np.floor(exact).astype(np.int64)
    rest = count - int(whole.sum())
    whole[np.argsort(-(exact - whole), kind="stable")[:rest]] += 1
    out = np.repeat(np.arange(len(shares)), whole)
    gen.shuffle(out)
    return out


def make_reads(n: int, count: int, traffic: dict, seed: int,
               bench_dir: Path = BENCH) -> List[Read]:
    """``count`` reads, the kinds in the mix's shares (``{"reach": 1,
    "dist": 1, "bounded": 1}``), bounded reads at ``mix["bound"]`` hops,
    rpq reads with the regular expression ``mix["regex"]``, the pairs from
    the traffic's ``pairs`` sampler."""
    mix = traffic["mix"]
    gen = rng(seed, QUERIES)
    kinds = _balanced(count, [mix["shares"].get(k, 0) for k in KINDS], gen)
    pspec = traffic.get("pairs", DEFAULT_PAIRS)
    pairs = component("traffic/pairs", pspec["sampler"],
                      bench_dir).make(n, count, pspec, gen)
    return [read_of(KINDS[kd], int(s), int(t), mix)
            for kd, (s, t) in zip(kinds, pairs)]


def read_of(kind: str, s: int, t: int, mix: dict) -> Read:
    """A read of ``kind`` from ``s`` to ``t`` with what the mix gives that
    kind: a bounded read its ``bound``, an rpq read its ``regex``."""
    return Read(kind, s, t, mix.get("bound", 0) if kind == "bounded" else 0,
                mix["regex"] if kind == "rpq" else "")


def make_arrivals(count: int, seconds: float, spec: Optional[dict],
                  seed: int, stream: int, bench_dir: Path = BENCH
                  ) -> np.ndarray:
    """``count`` arrival offsets in ``[0, seconds)`` from the arrival
    process ``spec`` names (``{"process": "poisson_quantiles"}``)."""
    spec = spec or DEFAULT_ARRIVALS
    return component("traffic/arrivals", spec["process"], bench_dir).make(
        count, seconds, spec, rng(seed, stream))


@dataclasses.dataclass
class Delta:
    """One graph delta: edges inserted and edges deleted (one occurrence
    each), ``shape`` the name of the file that drew it."""

    shape: str
    inserts: List[Tuple[int, int]]
    deletes: List[Tuple[int, int]] = dataclasses.field(default_factory=list)


class DeltaContext:
    """What a delta shape may draw from: the graph, each fragment's nodes,
    and the edges as the deltas drawn so far have left them."""

    def __init__(self, g: GraphData):
        self.graph = g
        order = np.argsort(g.part, kind="stable")
        cuts = np.searchsorted(g.part[order], np.arange(1, g.k))
        self.members = np.split(order, cuts)
        self._drawn: List[Delta] = []
        self._edges: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(src, dst)`` of the graph with every delta drawn so far
        applied."""
        if self._edges is None:
            self._edges = (self.graph.src, self.graph.dst)
        for d in self._drawn:
            self._edges = apply(self._edges, d)
        self._drawn = []
        return self._edges

    def add(self, d: Delta) -> None:
        self._drawn.append(d)


def apply(edges: Tuple[np.ndarray, np.ndarray], d: Delta
          ) -> Tuple[np.ndarray, np.ndarray]:
    """The edge lists after ``d``: its deletions take one occurrence each,
    then its insertions are appended."""
    src, dst = edges
    if d.deletes:
        keep = np.ones(len(src), dtype=bool)
        for u, v in d.deletes:
            hit = np.nonzero(keep & (src == u) & (dst == v))[0]
            if not len(hit):
                raise ValueError(f"delta {d.shape} deletes a missing edge "
                                 f"{u}->{v}")
            keep[hit[0]] = False
        src, dst = src[keep], dst[keep]
    if d.inserts:
        e = np.asarray(d.inserts, dtype=np.int64).reshape(-1, 2)
        src, dst = np.concatenate([src, e[:, 0]]), np.concatenate([dst,
                                                                   e[:, 1]])
    return src, dst


def make_deltas(g: GraphData, count: int, spec: dict, seed: int,
                stream: int = DELTAS, bench_dir: Path = BENCH,
                ctx: Optional[DeltaContext] = None) -> List[Delta]:
    """``count`` deltas, each drawn by a shape of ``spec["shapes"]`` (the
    name of a file in ``bench/traffic/deltas/`` and its share of the
    count), each shape's ``make(ctx, spec, gen)`` given the spec.  Pass
    the ``ctx`` of the deltas drawn before these to draw after them."""
    gen = rng(seed, stream)
    names = sorted(spec["shapes"])
    which = _balanced(count, [spec["shapes"][s] for s in names], gen)
    shapes = [component("traffic/deltas", s, bench_dir) for s in names]
    ctx = ctx if ctx is not None else DeltaContext(g)
    out = []
    for w in which:
        d = shapes[w].make(ctx, spec, gen)
        ctx.add(d)
        out.append(d)
    return out
