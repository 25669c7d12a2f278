"""Distributed reachability queries with performance guarantees, in
PyTorch with hand-written CUDA kernels for the H100.

The front door is :func:`repro_torch.connect`::

    import repro_torch
    from repro_torch import Reach, Dist, Rpq

    session = repro_torch.connect(fr)          # fr: a Fragmentation
    results = session.run([
        Reach(s, t),
        Dist(s, t, bound=6),
        Rpq(s, t, regex="(0|1)* 2"),
    ])

The session runs on the CUDA device; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels on the CPU instead.
"""
from .core.fragments import Placement
from .core.plan import Dist, Query, QueryResult, Reach, Rpq
from .core.session import QuerySession, connect
from .errors import NoCudaDevice, Status

__all__ = ["connect", "QuerySession", "QueryResult", "Status", "Reach",
           "Dist", "Rpq", "Query", "NoCudaDevice", "Placement"]
