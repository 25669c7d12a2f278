#!/usr/bin/env python3
"""Time the one-shot query paths whose evalDG runs as a fixpoint, with the
package of one or more source trees, each in a child process, in the order
given:

    git archive <commit> src | tar -x -C build/parent
    python3 tools/evaldg_ab.py build/parent . . build/parent

(``build/`` is ignored by git; one CUDA device.)  Each child imports
``repro_torch`` from ``<tree>/src``, builds its kernels there, and prints
one JSON line with the card's name and power limit and, on the graph of
``chip_smoke.py``'s main phase (``erdos_renyi(16384, 65536, 8)`` in 16
random fragments):

- ``run_ms``: the host-clock time of ``connect(fr, cache="none").run``
  over the one-shot phase's 32 queries (16 Reach, 16 Dist, every second
  Dist bounded at 6), after a warm-up run; the median of 3 runs;
- ``dis_reach_ms``: the median over 16 seeded pairs of one ``dis_reach``
  call each (CUDA events around the call, which ends in a host read);
- ``chain_ms``: ``dis_reach`` from one end of a 1024-node chain dealt
  round-robin over 16 fragments to the other; the median of 3 calls;
- ``evaldg_reach_ms`` / ``evaldg_dist_ms``: ``engine.evaldg_reach`` /
  ``evaldg_dist`` alone on the D / W of the run's first Reach / Dist,
  CUDA events around 5 calls after a warm-up;
- ``cell``: on the graph of the benchmark's one-shot cell
  (``erdos_renyi(32768, 131072, 8)`` in 16 random fragments, nb ~ 32k),
  for 48 seeded pairs, W of a dist query and of a bounded (6) one written
  by localEval, then ``min_plus_settle`` alone on that W, CUDA events
  around 3 calls after a warm-up; grouped by the unbounded answer d(s, t)
  (``inf``: unreachable), the median ms, rows read and levels.

Each child also prints its answers, which must be equal across trees.
"""
import hashlib
import statistics
import sys
import time
from pathlib import Path

import _ab

N, M, LABELS, FRAGS, SEED = 16384, 65536, 8, 16, 0
N_ONESHOT, N_PAIRS, CHAIN = 32, 16, 1024
CELL_N, CELL_M, CELL_PAIRS, CELL_BOUND = 32768, 131072, 48, 6


def cell(answers: list) -> dict:
    """The settle kernel on the one-shot cell's graph (see the module
    docstring); its answers go into ``answers``."""
    import numpy as np
    import torch
    from repro_torch.core import engine, session
    from repro_torch.core.fragments import fragment_graph
    from repro_torch.graph import erdos_renyi, random_partition
    from repro_torch.kernels.tropical_matmul import ops as tops
    INF = engine.INF
    g = erdos_renyi(CELL_N, CELL_M, n_labels=LABELS, seed=SEED)
    fr = fragment_graph(g, random_partition(g, FRAGS, seed=SEED), FRAGS)
    dev = torch.device("cuda")
    W = tops.padded_i32(fr.B, fr.B, dev)
    rng = np.random.default_rng(SEED + 9)
    rows = []
    for s, t in rng.integers(0, g.n, size=(CELL_PAIRS, 2)).tolist():
        if s == t:
            continue
        arrs, s_local, t_local = session._query_inputs(fr, s, t, dev)
        src, tgt = session._src_rows(fr, dev), session._tgt_cols(fr, t, dev)
        d0 = torch.full((fr.B,), INF, dtype=torch.int32, device=dev)
        d0.masked_fill_(src, 0)
        dist = None
        for kind, bound in (("dist", None), ("bounded", CELL_BOUND)):
            engine.local_eval_dist(
                arrs["esrc"], arrs["edst"], arrs["src_local"],
                arrs["src_row"], arrs["tgt_local"], s_local, t_local,
                INF if bound is None else bound, n_max=fr.n_max, B=fr.B,
                out=W)
            tops.min_plus_settle(d0, W, tgt, bound)
            settle_ms, state = _ab.events_ms(
                lambda: tops.min_plus_settle(d0, W, tgt, bound), 3)
            got, levels, read = state.tolist()
            dist = got if kind == "dist" else dist
            rows.append({"kind": kind, "d": dist, "settle_ms": settle_ms,
                         "levels": levels, "rows": read})
            answers.append((s, t, kind, got))
    del W
    torch.cuda.empty_cache()
    out = {}
    for row in rows:
        key = f"{row['kind']} d={'inf' if row['d'] >= INF else row['d']}"
        out.setdefault(key, []).append(row)
    return {key: {name: statistics.median(r[name] for r in group)
                  for name in group[0] if name not in ("kind", "d")}
            | {"n": len(group)} for key, group in sorted(out.items())}


def child(tree: Path) -> dict:
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import Dist, Reach, dis_reach
    from repro_torch.core import engine
    from repro_torch.core.fragments import fragment_graph
    from repro_torch.graph import erdos_renyi, random_partition
    from repro_torch.graph.graph import Graph
    _ab.from_tree(engine, tree)
    events = _ab.events_ms

    g = erdos_renyi(N, M, n_labels=LABELS, seed=SEED)
    fr = fragment_graph(g, random_partition(g, FRAGS, seed=SEED), FRAGS)
    rng = np.random.default_rng(SEED + 2)
    pairs = rng.integers(0, g.n, size=(N_ONESHOT, 2))
    half = N_ONESHOT // 2
    queries = [Reach(int(s), int(t)) for s, t in pairs[:half]]
    queries += [Dist(int(s), int(t), bound=6 if i % 2 else None)
                for i, (s, t) in enumerate(pairs[half:])]
    sess = repro_torch.connect(fr, cache="none")
    kept = {}
    orig = (engine.evaldg_reach, engine.evaldg_dist)

    def keep(kind, fn):
        def wrapped(*args, **kw):
            kept.setdefault(kind, args)
            return fn(*args, **kw)
        return wrapped

    engine.evaldg_reach = keep("reach", orig[0])
    engine.evaldg_dist = keep("dist", orig[1])
    try:
        sess.run(queries)                       # warm-up, and D / W kept
    finally:
        engine.evaldg_reach, engine.evaldg_dist = orig
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = sess.run(queries)
        runs.append((time.perf_counter() - t0) * 1e3)
    answers = [(r.answer, r.distance) for r in results]

    evaldg = {}
    for kind, fn in (("reach", engine.evaldg_reach),
                     ("dist", engine.evaldg_dist)):
        args = kept[kind]
        fn(*args)
        torch.cuda.synchronize()
        evaldg[kind], _ = events(lambda: fn(*args), 5)
    del kept

    rng = np.random.default_rng(SEED + 6)
    single = []
    for s, t in rng.integers(0, g.n, size=(N_PAIRS, 2)).tolist():
        ms, res = events(lambda: dis_reach(fr, s, t), 1)
        single.append(ms)
        answers.append(res.answer)

    chain = Graph(CHAIN, np.arange(CHAIN - 1), np.arange(1, CHAIN),
                  np.zeros(CHAIN, np.int32))
    cfr = fragment_graph(chain, (np.arange(CHAIN) % FRAGS).astype(np.int32),
                         FRAGS)
    dis_reach(cfr, 0, CHAIN - 1)
    chain_ms = []
    for _ in range(3):
        ms, res = events(lambda: dis_reach(cfr, 0, CHAIN - 1), 1)
        chain_ms.append(ms)
        answers.append(res.answer)

    by_distance = cell(answers)
    return {"run_ms": statistics.median(runs), "runs_ms": runs,
            "dis_reach_ms": statistics.median(single),
            "dis_reach_max_ms": max(single),
            "chain_ms": statistics.median(chain_ms),
            "evaldg_reach_ms": evaldg["reach"],
            "evaldg_dist_ms": evaldg["dist"],
            "cell": by_distance,
            "answers": hashlib.sha256(repr(answers).encode()).hexdigest()[:16]}


if __name__ == "__main__":
    sys.exit(_ab.main(sys.argv[1:], __file__, __doc__, child,
                      agree="answers"))
