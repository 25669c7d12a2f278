"""What the loops that drive a ``QueryServer`` share: sending a read or a
delta as the program takes it, and copying out what its future says."""
from __future__ import annotations

from bench.record import DeltaRec, ReadRec


def program_delta(d):
    """The benchmark's delta as the program's ``GraphDelta``."""
    import numpy as np
    from repro_torch import GraphDelta
    add = np.asarray(d.inserts, dtype=np.int64).reshape(-1, 2)
    rem = np.asarray(d.deletes, dtype=np.int64).reshape(-1, 2)
    return GraphDelta(add_src=add[:, 0], add_dst=add[:, 1],
                      del_src=rem[:, 0], del_dst=rem[:, 1])


def submit_read(server, r):
    if r.kind == "bounded":
        return server.submit(r.s, r.t, kind="bounded", bound=r.bound)
    return server.submit(r.s, r.t, kind=r.kind)


def take_read(rec: ReadRec, fut, v_base: int) -> None:
    """Copy out an answered read; its version is the number of deltas its
    graph holds (the cache version past ``v_base``, the version before any
    delta)."""
    rec.done = fut.resolved_at
    rec.ok = fut.status == "done"
    if rec.ok:
        rec.value = fut.value
        rec.version = (None if fut.cache_version is None
                       else fut.cache_version - v_base)
    else:
        rec.error = repr(fut.error)


def take_delta(rec: DeltaRec, fut) -> None:
    rec.done = fut.resolved_at
    rec.ok = fut.status == "applied"
    if rec.ok:
        rec.mode = fut.value.mode
    else:
        rec.error = repr(fut.error)


def window_deltas(system, traffic: dict, seed: int, seconds: float):
    """The window's deltas, drawn after the warm-up's, their offsets in
    the window and the program's form of each: ``rate_per_s`` x
    ``seconds`` of them, at offsets from the stream's ``arrivals``."""
    from bench.data import generate as gen
    dspec = traffic.get("deltas")
    if not dspec:
        return [], [], []
    count = round(dspec["rate_per_s"] * seconds)
    bench_dir = system.cell.bench_dir
    deltas = gen.make_deltas(system.graph, count, dspec, seed,
                             bench_dir=bench_dir, ctx=system.delta_ctx)
    times = gen.make_arrivals(count, seconds, dspec.get("arrivals"), seed,
                              gen.DELTA_ARRIVALS, bench_dir)
    return deltas, [float(t) for t in times], [program_delta(d)
                                               for d in deltas]
