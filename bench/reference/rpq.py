"""The plain reference of a regular path query: a breadth-first search of
the product of the graph with the regular expression's automaton, in plain
PyTorch, over the graph the benchmark made and the deltas it sent.

A read ``rpq(s, t, R)`` is True when some path ``s = v0 -> v1 -> ... -> vk
= t`` has inner labels ``label(v1) ... label(v(k-1))`` that spell a word of
``L(R)``; a path of one edge spells the empty word, and ``s == t`` is True
exactly when ``L(R)`` holds the empty word.  The search gives each read the
length, in edges, of its shortest such path (-1: none), as
:func:`bench.reference.bfs.distances` gives a hop distance, so that the
depth control cuts both alike.

The automaton is this module's own: a Thompson construction (states joined
by empty moves and by moves on one label) from its own parser, with the
empty moves closed over, so that it shares nothing with the program's
position automaton.  The grammar: labels are non-negative integers, ``.``
matches any label, ``eps`` is the empty word, and ``|``, concatenation
(juxtaposition), ``*``, ``+``, ``?`` and parentheses bind as usual.

A level of the search is one product of the frontier, a ``[states x
sources, n]`` 0/1 matrix, with the graph's dense matrix of edge counts from
:mod:`bench.reference.bfs` (a delta applied there as there), followed by
the automaton's label moves and empty closures on the host's small tables.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import bfs

#: sources searched at once
BLOCK = 1024

ANY = -1            # the label of ``.``
_TOKEN = re.compile(r"\s*(\d+|eps|[.()|*+?])")


@dataclasses.dataclass
class Nfa:
    """The automaton as the search uses it: ``k`` states, each a state
    of the Thompson automaton that a label leaves, or its accepting one.
    ``start``: the states reached on the empty word, ``moves``: ``(p,
    label, targets)`` for each label move, its targets closed over empty
    moves, ``accept``: the accepting state's index, ``nullable``: whether
    the empty word is in the language."""

    k: int
    start: List[int]
    moves: List[Tuple[int, int, List[int]]]
    accept: int
    nullable: bool


class _Thompson:
    """Thompson's construction: each fragment is ``(entry, exit)``."""

    def __init__(self):
        self.eps: List[List[int]] = []
        self.sym: List[Optional[Tuple[int, int]]] = []   # (label, target)

    def state(self) -> int:
        self.eps.append([])
        self.sym.append(None)
        return len(self.eps) - 1

    def label(self, a: int) -> Tuple[int, int]:
        i, o = self.state(), self.state()
        self.sym[i] = (a, o)
        return i, o

    def empty(self) -> Tuple[int, int]:
        i, o = self.state(), self.state()
        self.eps[i].append(o)
        return i, o

    def cat(self, x, y):
        self.eps[x[1]].append(y[0])
        return x[0], y[1]

    def alt(self, x, y):
        i, o = self.state(), self.state()
        self.eps[i] += [x[0], y[0]]
        self.eps[x[1]].append(o)
        self.eps[y[1]].append(o)
        return i, o

    def repeat(self, x, op: str):
        i, o = self.state(), self.state()
        self.eps[i].append(x[0])
        self.eps[x[1]].append(o)
        if op in "*+":
            self.eps[x[1]].append(x[0])
        if op in "*?":
            self.eps[i].append(o)
        return i, o


def _tokens(regex: str) -> List[str]:
    out, at = [], 0
    rest = regex.rstrip()
    while at < len(rest):
        m = _TOKEN.match(rest, at)
        if m is None:
            raise ValueError(f"cannot read {regex!r} at {at}")
        out.append(m.group(1))
        at = m.end()
    return out


def _parse(regex: str, b: _Thompson):
    toks = _tokens(regex)
    at = [0]

    def peek():
        return toks[at[0]] if at[0] < len(toks) else None

    def alt():
        x = cat()
        while peek() == "|":
            at[0] += 1
            x = b.alt(x, cat())
        return x

    def cat():
        x = None
        while peek() not in (None, "|", ")"):
            y = rep()
            x = y if x is None else b.cat(x, y)
        return b.empty() if x is None else x

    def rep():
        x = atom()
        while peek() in ("*", "+", "?"):
            x = b.repeat(x, toks[at[0]])
            at[0] += 1
        return x

    def atom():
        tok = peek()
        if tok is None or tok in ")|*+?":
            raise ValueError(f"{regex!r}: a label or '(' expected")
        at[0] += 1
        if tok == "(":
            x = alt()
            if peek() != ")":
                raise ValueError(f"{regex!r}: unbalanced parentheses")
            at[0] += 1
            return x
        if tok == "eps":
            return b.empty()
        return b.label(ANY if tok == "." else int(tok))

    x = alt()
    if at[0] != len(toks):
        raise ValueError(f"{regex!r}: trailing {toks[at[0]:]}")
    return x


def automaton(regex: str) -> Nfa:
    """The automaton of ``regex`` with its empty moves closed over."""
    b = _Thompson()
    entry, final = _parse(regex, b)

    def closure(p: int) -> set:
        seen, todo = {p}, [p]
        while todo:
            for q in b.eps[todo.pop()]:
                if q not in seen:
                    seen.add(q)
                    todo.append(q)
        return seen

    keep = [p for p in range(len(b.sym)) if b.sym[p] is not None] + [final]
    index = {p: i for i, p in enumerate(keep)}

    def kept(states) -> List[int]:
        return sorted(index[p] for p in states if p in index)

    start = closure(entry)
    moves = [(index[p], b.sym[p][0], kept(closure(b.sym[p][1])))
             for p in keep[:-1]]
    return Nfa(len(keep), kept(start), moves, index[final], final in start)


def accepts(nfa: Nfa, word: Sequence[int]) -> bool:
    """Whether ``word`` is in the language (for the tests)."""
    cur = set(nfa.start)
    for a in word:
        cur = {q for p, lab, to in nfa.moves if p in cur
               and lab in (a, ANY) for q in to}
    return nfa.accept in cur


def path_lengths(a: torch.Tensor, labels: torch.Tensor, nfa: Nfa,
                 pairs: Sequence[Tuple[int, int]],
                 max_depth: Optional[int] = None) -> List[int]:
    """The length of the shortest accepted path of each ``(s, t)`` pair
    over the dense edge counts ``a`` [n, n] and node labels ``labels``
    [n], -1 where there is none.  ``max_depth`` searches paths of at most
    that many edges (the control: a fixpoint cut short)."""
    out = [-1] * len(pairs)
    for i, (s, t) in enumerate(pairs):
        if s == t:
            out[i] = 0 if nfa.nullable else -1
    todo = [i for i, (s, t) in enumerate(pairs) if s != t]
    srcs = sorted({pairs[i][0] for i in todo})
    for lo in range(0, len(srcs), BLOCK):
        block = srcs[lo:lo + BLOCK]
        row = {s: j for j, s in enumerate(block)}
        mine = [i for i in todo if pairs[i][0] in row]
        d = _search(a, labels, nfa, block,
                    [(row[pairs[i][0]], pairs[i][1]) for i in mine],
                    max_depth)
        for i, x in zip(mine, d):
            out[i] = x
    return out


def _search(a, labels, nfa: Nfa, sources, asks, max_depth) -> List[int]:
    """The search from ``sources``: ``asks`` are ``(source row, t)``."""
    n, dev, r = a.shape[0], a.device, len(sources)
    rows = torch.as_tensor([j for j, _ in asks], dtype=torch.long,
                           device=dev)
    cols = torch.as_tensor([t for _, t in asks], dtype=torch.long,
                           device=dev)
    found = torch.full((len(asks),), -1, dtype=torch.int32, device=dev)
    frontier = torch.zeros((nfa.k, r, n), dtype=torch.bool, device=dev)
    src = torch.as_tensor(list(sources), dtype=torch.long, device=dev)
    for q in nfa.start:
        frontier[q, torch.arange(r, device=dev), src] = True
    seen = frontier.clone()
    masks: Dict[int, torch.Tensor] = {}
    level = 0
    while max_depth is None or level < max_depth:
        level += 1
        # the nodes one edge on, in each state: t is reached there when
        # the state accepts; any node, t too, may go on as an inner node
        step = (frontier.reshape(nfa.k * r, n).to(a.dtype) @ a) > 0
        step = step.reshape(nfa.k, r, n)
        hit = step[nfa.accept][rows, cols] & (found < 0)
        found[hit] = level
        if bool((found >= 0).all()):
            break
        new = torch.zeros_like(frontier)
        for p, lab, to in nfa.moves:
            if lab not in masks:
                masks[lab] = (torch.ones(n, dtype=torch.bool, device=dev)
                              if lab == ANY else labels == lab)
            moved = step[p] & masks[lab]
            for q in to:
                new[q] |= moved
        new &= ~seen
        if not bool(new.any()):
            break
        seen |= new
        frontier = new
    return [int(x) for x in found.cpu().tolist()]


def lengths(n: int, src, dst, labels, deltas: List[Tuple[bfs.Edges,
                                                          bfs.Edges]],
            reads, versions: Sequence[int], device,
            max_depth: Optional[int] = None) -> List[Optional[int]]:
    """The shortest accepted path length of each rpq read at its version
    (-1: none), as :func:`bench.reference.bfs.distances` gives hop
    distances: version ``j`` is the graph after the first ``j`` of
    ``deltas``.  ``reads`` have ``s``, ``t`` and ``regex``.  A version
    outside ``[0, len(deltas)]`` gives None."""
    out: List[Optional[int]] = [None] * len(reads)
    by_version: Dict[int, List[int]] = {}
    for i, v in enumerate(versions):
        if v is not None and 0 <= v <= len(deltas):
            by_version.setdefault(v, []).append(i)
    if not by_version:
        return out
    a = bfs.adjacency(n, src, dst, device)
    lab = torch.as_tensor(np.asarray(labels, dtype=np.int64), device=device)
    nfas: Dict[str, Nfa] = {}
    applied = 0
    for v in sorted(by_version):
        while applied < v:
            bfs.apply_delta(a, *deltas[applied])
            applied += 1
        by_regex: Dict[str, List[int]] = {}
        for i in by_version[v]:
            by_regex.setdefault(reads[i].regex, []).append(i)
        for regex, idx in by_regex.items():
            if regex not in nfas:
                nfas[regex] = automaton(regex)
            got = path_lengths(a, lab, nfas[regex],
                               [(reads[i].s, reads[i].t) for i in idx],
                               max_depth)
            for i, x in zip(idx, got):
                out[i] = x
    del a
    return out
