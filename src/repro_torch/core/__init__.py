"""The paper's query engine in PyTorch: fragmentation, local fixpoints,
closures, the amortized rvset cache, incremental repair under graph
deltas, MVCC versions, the query session and the one-shot query
functions."""
from .api import dis_dist, dis_reach, dis_rpq, dis_rpq_regex
from .automaton import QueryAutomaton, accepts, build_query_automaton
from .cache import (RvsetCache, get_rvset_cache, load_rvset_state,
                    prepare_rvset_cache)
from .engine import INF, QueryStats
from .fragments import (DeltaReport, Fragmentation, GraphDelta, Placement,
                        fragment_graph, query_slots)
from .incremental import UpdateStats, apply_delta
from .plan import (Dist, ExecutionGroup, Query, QueryPlan, QueryResult,
                   Reach, Rpq)
from .session import QuerySession, SessionStats, connect, default_session

__all__ = [
    "QueryAutomaton", "accepts", "build_query_automaton",
    "RvsetCache", "get_rvset_cache", "load_rvset_state",
    "prepare_rvset_cache", "INF", "QueryStats", "Fragmentation",
    "Placement", "fragment_graph", "query_slots", "Dist", "ExecutionGroup",
    "Query", "QueryPlan", "QueryResult", "Reach", "Rpq", "QuerySession",
    "SessionStats", "connect", "default_session", "GraphDelta",
    "DeltaReport", "UpdateStats", "apply_delta", "dis_reach", "dis_dist",
    "dis_rpq", "dis_rpq_regex",
]
