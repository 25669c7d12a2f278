"""The paper's query engine in PyTorch: fragmentation, local fixpoints,
closures, the amortized rvset cache, incremental repair under graph
deltas (on the host or sharded), MVCC versions, the query session, the
one-shot query functions and the paper's baselines (disReach_n,
disReach_m, MRdRPQ)."""
from .api import dis_dist, dis_reach, dis_rpq, dis_rpq_regex
from .automaton import QueryAutomaton, accepts, build_query_automaton
from .baselines import BaselineResult, dis_reach_m, dis_reach_n
from .cache import (RvsetCache, get_rvset_cache, load_rvset_state,
                    prepare_rvset_cache)
from .distributed import apply_delta_sharded
from .engine import INF, QueryStats
from .fragments import (DeltaReport, Fragmentation, GraphDelta, Placement,
                        fragment_graph, query_slots)
from .incremental import UpdateStats, apply_delta
from .mapreduce import MRResult, mr_drpq
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
    "dis_rpq", "dis_rpq_regex", "BaselineResult", "dis_reach_n",
    "dis_reach_m", "MRResult", "mr_drpq", "apply_delta_sharded",
]
