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
``connect(fr, cache="none")`` answers with the paper's one-shot
algorithms, as do the shims ``dis_reach`` / ``dis_dist`` / ``dis_rpq`` /
``dis_rpq_regex``; ``session.apply(GraphDelta.insert([(u, v)]))`` changes
the graph and repairs the caches, or rolls back and raises
:class:`DeltaApplyFailed`.

:class:`QueryServer` serves a stream of requests and deltas over a
session: admission lanes, deadlines, retries, dead letters, MVCC versions
(``mvcc=True``) and seeded fault injection (:mod:`repro_torch.serve`)::

    with repro_torch.QueryServer(fr, with_dist=True) as server:
        fut = server.submit(s, t, kind="dist")
        server.submit_delta(GraphDelta.insert([(u, v)]))
        print(fut.result(timeout=10))

Beside the query engine sits the LM family of the substrate, in plain
PyTorch: :mod:`repro_torch.models.transformer`, the configurations of
:mod:`repro_torch.configs`, :class:`repro_torch.serve.ServeEngine`, and
the training pieces (:mod:`repro_torch.optim`, :mod:`repro_torch.train`,
:mod:`repro_torch.ckpt`, :mod:`repro_torch.data`).
"""
from .core.api import dis_dist, dis_reach, dis_rpq, dis_rpq_regex
from .core.fragments import GraphDelta, Placement
from .core.incremental import apply_delta
from .core.plan import Dist, Query, QueryResult, Reach, Rpq
from .core.session import QuerySession, connect
from .errors import DeltaApplyFailed, NoCudaDevice, Status
from .serve import QueryServer

__all__ = ["connect", "QuerySession", "QueryResult", "Status", "Reach",
           "Dist", "Rpq", "Query", "NoCudaDevice", "Placement", "GraphDelta",
           "DeltaApplyFailed", "apply_delta", "dis_reach", "dis_dist",
           "dis_rpq", "dis_rpq_regex", "QueryServer"]
