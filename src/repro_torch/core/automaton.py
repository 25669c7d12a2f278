"""Query automata for regular reachability queries (paper Section 5.1).

``R ::= eps | a | RR | R|R | R*`` over node labels.  We build the Glushkov
(position) automaton — each state is an occurrence of a symbol in R and is
*labeled by that symbol*, exactly the paper's query-automaton semantics
("transitions are made by matching the labels of its states with the labels
on the paths").  Construction is the classical first/last/follow computation:
linear states in |R| (paper cites [15] for the O(|R| log |R|) variant; the
Glushkov automaton has the same state count, which is what the complexity
bounds use).

State layout:  0 = u_s (matches only the query's source node s),
1..m = symbol positions, m+1 = u_t (matches only the target node t).
State labels use sentinels:  >=0 symbol id, -1 s-only, -2 t-only,
-3 wildcard (matches any real node).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Set, Tuple

import numpy as np

L_S, L_T, L_WILD = -1, -2, -3


@dataclasses.dataclass
class QueryAutomaton:
    n_states: int
    state_labels: np.ndarray    # [Q] int32 (sentinel scheme above)
    trans: np.ndarray           # [Q, Q] bool adjacency
    nullable: bool              # eps in L(R): len-<=1 s..t paths accepted
    start: int = 0

    @property
    def final(self) -> int:
        return self.n_states - 1

    def size(self) -> int:
        """|R| proxy used in the complexity bounds: states + transitions."""
        return self.n_states + int(self.trans.sum())

    def cache_key(self) -> tuple:
        """Hashable identity used to key per-automaton cached artifacts
        (product closures in core.cache, execution groups in core.plan):
        two automata with equal keys are behaviourally identical —
        ``nullable`` is included because it decides s == t answers."""
        return (self.n_states, self.start, self.nullable,
                self.state_labels.tobytes(), self.trans.tobytes())


# --- regex AST -------------------------------------------------------------

class _Node:
    pass


@dataclasses.dataclass
class _Sym(_Node):
    label: int      # symbol id or L_WILD
    pos: int = -1


@dataclasses.dataclass
class _Cat(_Node):
    a: _Node
    b: _Node


@dataclasses.dataclass
class _Alt(_Node):
    a: _Node
    b: _Node


@dataclasses.dataclass
class _Star(_Node):
    a: _Node


@dataclasses.dataclass
class _Plus(_Node):
    a: _Node


@dataclasses.dataclass
class _Opt(_Node):
    a: _Node


@dataclasses.dataclass
class _Eps(_Node):
    pass


def _tokenize(rx: str) -> List[str]:
    toks, i = [], 0
    while i < len(rx):
        c = rx[i]
        if c.isspace():
            i += 1
        elif c in "()|*+?.":
            toks.append(c)
            i += 1
        else:
            j = i
            while j < len(rx) and (rx[j].isalnum() or rx[j] in "_-"):
                j += 1
            if j == i:
                raise ValueError(f"bad regex char {c!r} in {rx!r}")
            toks.append(rx[i:j])
            i = j
    return toks


def _parse(toks: List[str], label_of: Callable[[str], int]) -> _Node:
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else None

    def eat():
        t = toks[pos[0]]
        pos[0] += 1
        return t

    def parse_alt() -> _Node:
        n = parse_cat()
        while peek() == "|":
            eat()
            n = _Alt(n, parse_cat())
        return n

    def parse_cat() -> _Node:
        items = []
        while peek() is not None and peek() not in ")|":
            items.append(parse_rep())
        if not items:
            return _Eps()
        n = items[0]
        for x in items[1:]:
            n = _Cat(n, x)
        return n

    def parse_rep() -> _Node:
        n = parse_atom()
        while peek() in ("*", "+", "?"):
            op = eat()
            n = {"*": _Star, "+": _Plus, "?": _Opt}[op](n)
        return n

    def parse_atom() -> _Node:
        t = eat()
        if t == "(":
            n = parse_alt()
            if peek() != ")":
                raise ValueError(f"unbalanced parens in {toks!r}")
            eat()
            return n
        if t == ".":
            return _Sym(L_WILD)
        if t in ("eps", "epsilon"):
            return _Eps()
        return _Sym(label_of(t))

    n = parse_alt()
    if pos[0] != len(toks):
        raise ValueError(f"trailing tokens: {toks[pos[0]:]}")
    return n


# --- Glushkov construction --------------------------------------------------

def _glushkov(n: _Node) -> Tuple[List[int], bool, Set[int], Set[int],
                                 Set[Tuple[int, int]]]:
    syms: List[int] = []

    def number(node: _Node):
        if isinstance(node, _Sym):
            node.pos = len(syms) + 1
            syms.append(node.label)
        elif isinstance(node, (_Cat, _Alt)):
            number(node.a)
            number(node.b)
        elif isinstance(node, (_Star, _Plus, _Opt)):
            number(node.a)

    number(n)
    follow: Set[Tuple[int, int]] = set()

    def visit(node: _Node) -> Tuple[bool, Set[int], Set[int]]:
        if isinstance(node, _Eps):
            return True, set(), set()
        if isinstance(node, _Sym):
            return False, {node.pos}, {node.pos}
        if isinstance(node, _Cat):
            na, fa, la = visit(node.a)
            nb, fb, lb = visit(node.b)
            for p in la:
                for q in fb:
                    follow.add((p, q))
            return (na and nb,
                    fa | (fb if na else set()),
                    lb | (la if nb else set()))
        if isinstance(node, _Alt):
            na, fa, la = visit(node.a)
            nb, fb, lb = visit(node.b)
            return na or nb, fa | fb, la | lb
        if isinstance(node, (_Star, _Plus)):
            _, fa, la = visit(node.a)
            for p in la:
                for q in fa:
                    follow.add((p, q))
            nullable = isinstance(node, _Star) or visit(node.a)[0]
            return nullable, fa, la
        if isinstance(node, _Opt):
            na, fa, la = visit(node.a)
            return True, fa, la
        raise TypeError(node)

    nullable, first, last = visit(n)
    return syms, nullable, first, last, follow


def build_query_automaton(regex: str,
                          label_of: Callable[[str], int]) -> QueryAutomaton:
    """Compile a regular expression into the paper's query automaton G_q(R)."""
    ast = _parse(_tokenize(regex), label_of)
    syms, nullable, first, last, follow = _glushkov(ast)
    m = len(syms)
    Q = m + 2
    labels = np.full(Q, 0, dtype=np.int32)
    labels[0] = L_S
    labels[Q - 1] = L_T
    for i, lab in enumerate(syms):
        labels[i + 1] = lab
    trans = np.zeros((Q, Q), dtype=bool)
    for p in first:
        trans[0, p] = True
    for (p, q) in follow:
        trans[p, q] = True
    for p in last:
        trans[p, Q - 1] = True
    if nullable:
        trans[0, Q - 1] = True
    return QueryAutomaton(n_states=Q, state_labels=labels, trans=trans,
                          nullable=nullable)


def accepts(qa: QueryAutomaton, word: List[int]) -> bool:
    """Host oracle: does the interior label word drive u_s to u_t?"""
    cur = {0}
    for a in word:
        nxt = set()
        for p in cur:
            for q in range(qa.n_states):
                if qa.trans[p, q]:
                    lq = qa.state_labels[q]
                    if lq == a or lq == L_WILD:
                        nxt.add(q)
        cur = nxt
        if not cur:
            return False
    return any(qa.trans[p, qa.final] for p in cur) or (not word and qa.nullable)
