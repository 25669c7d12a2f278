"""The paper's query engine in PyTorch: fragmentation, local fixpoints,
closures, the amortized rvset cache and the query session."""
from .automaton import QueryAutomaton, accepts, build_query_automaton
from .cache import (RvsetCache, get_rvset_cache, load_rvset_state,
                    prepare_rvset_cache)
from .engine import INF, QueryStats
from .fragments import (Fragmentation, Placement, fragment_graph,
                        query_slots)
from .plan import (Dist, ExecutionGroup, Query, QueryPlan, QueryResult,
                   Reach, Rpq)
from .session import QuerySession, SessionStats, connect

__all__ = [
    "QueryAutomaton", "accepts", "build_query_automaton",
    "RvsetCache", "get_rvset_cache", "load_rvset_state",
    "prepare_rvset_cache", "INF", "QueryStats", "Fragmentation",
    "Placement", "fragment_graph", "query_slots", "Dist", "ExecutionGroup",
    "Query", "QueryPlan", "QueryResult", "Reach", "Rpq", "QuerySession",
    "SessionStats", "connect",
]
