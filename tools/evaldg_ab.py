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
  CUDA events around 5 calls after a warm-up.

Each child also prints its answers, which must be equal across trees.
"""
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, M, LABELS, FRAGS, SEED = 16384, 65536, 8, 16, 0
N_ONESHOT, N_PAIRS, CHAIN = 32, 16, 1024


def child(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import Dist, Reach, dis_reach
    from repro_torch.core import engine
    from repro_torch.core.fragments import fragment_graph
    from repro_torch.graph import erdos_renyi, random_partition
    from repro_torch.graph.graph import Graph
    if not Path(engine.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {engine.__file__}, not from {tree}")

    def events(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, out

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
        def wrapped(*args):
            kept.setdefault(kind, args)
            return fn(*args)
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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    return {"tree": str(tree), "card": card,
            "run_ms": statistics.median(runs), "runs_ms": runs,
            "dis_reach_ms": statistics.median(single),
            "dis_reach_max_ms": max(single),
            "chain_ms": statistics.median(chain_ms),
            "evaldg_reach_ms": evaldg["reach"],
            "evaldg_dist_ms": evaldg["dist"],
            "answers": hashlib.sha256(repr(answers).encode()).hexdigest()[:16]}


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        print(json.dumps(child(Path(argv[1]))), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rows = []
    for tree in argv:
        out = subprocess.run([sys.executable, __file__, "--child", tree],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"child {tree} exited {out.returncode}:\n"
                               f"{out.stderr[-3000:]}")
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    if len({r["answers"] for r in rows}) != 1:
        raise AssertionError("the trees' answers differ")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
