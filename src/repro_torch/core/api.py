"""The paper's one-shot query functions, as thin shims over
per-fragmentation default sessions.

``dis_reach`` / ``dis_dist`` / ``dis_rpq`` / ``dis_rpq_regex`` run the
one-shot algorithms of the paper (Figs. 3-7: localEval on every fragment,
one assembly, evalDG) on the uncached default session of the
fragmentation (:func:`repro_torch.core.session.default_session` with
``cache="none"``), one query per call, leaving no state behind.  Like
:func:`repro_torch.connect` they run on the CUDA device unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

from .automaton import QueryAutomaton, build_query_automaton
from .fragments import Fragmentation
from .plan import Dist, QueryResult, Reach, Rpq
from .session import default_session

__all__ = ["dis_reach", "dis_dist", "dis_rpq", "dis_rpq_regex"]


def dis_reach(fr: Fragmentation, s: int, t: int,
              return_matrix: bool = False, device=None) -> QueryResult:
    """q_r(s, t): is there a path from s to t?"""
    q = Reach(int(s), int(t), return_matrix=return_matrix)
    return default_session(fr, cache="none", device=device).run([q])[0]


def dis_dist(fr: Fragmentation, s: int, t: int,
             bound: Optional[int] = None, device=None) -> QueryResult:
    """Bounded reachability q_br(s, t, l); with bound=None the exact
    dist(s, t) (unreachable: distance None)."""
    q = Dist(int(s), int(t), bound=bound)
    return default_session(fr, cache="none", device=device).run([q])[0]


def dis_rpq(fr: Fragmentation, s: int, t: int, qa: QueryAutomaton,
            return_matrix: bool = False, device=None) -> QueryResult:
    """q_rr(s, t, R) for a prebuilt query automaton."""
    q = Rpq(int(s), int(t), automaton=qa, return_matrix=return_matrix)
    return default_session(fr, cache="none", device=device).run([q])[0]


def dis_rpq_regex(fr: Fragmentation, s: int, t: int, regex: str,
                  **kw) -> QueryResult:
    """q_rr(s, t, R) for a regex over the graph's label names (or label
    ids when the graph has no names)."""
    g = fr.g
    label_of = (g.label_of if g.label_names is not None
                else (lambda name: int(name)))
    return dis_rpq(fr, s, t, build_query_automaton(regex, label_of), **kw)
