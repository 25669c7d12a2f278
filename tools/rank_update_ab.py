#!/usr/bin/env python3
"""Time the closure repairs of graph deltas with the package of one or more
source trees, each in a child process, in the order given:

    git archive <commit> src | tar -x -C build/parent
    python3 tools/rank_update_ab.py build/parent . . build/parent

(``build/`` is ignored by git; one CUDA device.)  Each child imports
``repro_torch`` from ``<tree>/src``, builds its kernels there, and prints
one JSON line with the card's name and power limit and, on the graph of
``chip_smoke.py``'s dynamic phase (``erdos_renyi(16384, 65536, 8)`` in 16
random fragments, reserves 64 / 256 / 64), for the two insert-only deltas
of that phase's stream (``intra``: 32 inserts in one fragment; ``cross``:
8 inserts onto nodes that become boundary nodes):

- ``repair_ms``: ``incremental.apply_delta`` on a warm reach + dist cache,
  each call on a fresh copy-on-write clone of the warm fragmentation
  (``versions.cow_clone``), one untimed call and then ``REPS`` timed
  calls a delta, host clock around a call that ends in a synchronize;
  the median a delta (``*_min_ms``: the least);
- ``sharded_ms``: the same deltas through
  ``distributed.apply_delta_sharded`` on a warm reach-only cache over a
  one-rank NCCL group (its rank update takes every in-node row of the
  dirty fragments);
- ``*_peak_mb``: the device memory peak of those calls above what was
  allocated before each (``reset_peak_memory_stats``,
  ``max_memory_allocated``); the largest over the calls.

Each child also prints a digest of every repaired cache tensor, which must
be equal across trees.
"""
import gc
import hashlib
import statistics
import sys
import time
from pathlib import Path

import _ab

N, M, LABELS, FRAGS, SEED = 16384, 65536, 8, 16, 0
RESERVE = dict(reserve_boundary=64, reserve_edges=256, reserve_stubs=64)
REPS = 15
DELTAS = ("intra", "cross")


def deltas(fr, rng):
    """The insert-only deltas of ``chip_smoke.py``'s dynamic stream, by
    label (``chip_smoke._dynamic_stream`` with the same seed)."""
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import _dynamic_stream
    stream = _dynamic_stream(fr, rng)
    return {label: delta for label, delta in
            (next(stream) for _ in DELTAS)}


def measure(tree: Path, device: str = "cuda", n: int = N, m: int = M,
            frags: int = FRAGS, reserve=None, reps: int = REPS) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.core import incremental
    from repro_torch.core.cache import prepare_rvset_cache
    from repro_torch.core.fragments import fragment_graph
    from repro_torch.core.versions import cow_clone
    from repro_torch.graph import erdos_renyi, random_partition
    _ab.from_tree(incremental, tree)
    reserve = RESERVE if reserve is None else reserve
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    digests = {}

    def digest(label, cache):
        h = hashlib.sha256()
        for name in ("bl_frontier", "closure", "closure_t", "bl_dist",
                     "dist_closure"):
            t = getattr(cache, name)
            if t is not None:
                h.update(t.cpu().numpy().tobytes())
        digests[label] = h.hexdigest()[:16]

    def timed(label, base, delta, repair):
        """``repair`` on fresh clones of ``base``, one untimed and then
        ``reps`` timed: ms each and the largest peak above what each call
        found allocated (MB)."""
        repair(cow_clone(base, delta), delta)
        times, peaks = [], []
        for _ in range(reps):
            clone = cow_clone(base, delta)
            gc.collect()
            sync()
            before = torch.cuda.memory_allocated() if cuda else 0
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            stats = repair(clone, delta)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            peaks.append(((torch.cuda.max_memory_allocated() - before)
                          if cuda else 0) / 2 ** 20)
        digest(label, clone.rvset_cache)
        return {"mode": stats.mode, "changed_rows": stats.changed_rows,
                "ms": statistics.median(times), "min_ms": min(times),
                "runs_ms": times, "peak_mb": max(peaks)}

    g = erdos_renyi(n, m, n_labels=LABELS, seed=SEED)
    part = random_partition(g, frags, seed=SEED)
    fr = fragment_graph(g, part, frags, **reserve)
    prepare_rvset_cache(fr, device, with_dist=True)
    sync()
    todo = deltas(fr, np.random.default_rng(SEED + 3))
    repair = {label: timed(f"repair {label}", fr, delta,
                           incremental.apply_delta)
              for label, delta in todo.items()}
    del fr
    if cuda:
        torch.cuda.empty_cache()

    fr = fragment_graph(g, part, frags, **reserve)
    prepare_rvset_cache(fr, device)
    sync()
    todo = deltas(fr, np.random.default_rng(SEED + 3))
    group = dist.group.WORLD if dist.is_initialized() else None
    sharded = {label: timed(f"sharded {label}", fr, delta,
                            lambda c, d: D.apply_delta_sharded(c, d, group))
               for label, delta in todo.items()}

    return {"repair_ms": {k: v["ms"] for k, v in repair.items()},
            "repair_min_ms": {k: v["min_ms"] for k, v in repair.items()},
            "sharded_min_ms": {k: v["min_ms"] for k, v in sharded.items()},
            "repair_peak_mb": {k: v["peak_mb"] for k, v in repair.items()},
            "sharded_ms": {k: v["ms"] for k, v in sharded.items()},
            "sharded_peak_mb": {k: v["peak_mb"] for k, v in sharded.items()},
            "repair": repair, "sharded": sharded, "digests": digests}


def child(tree: Path) -> dict:
    """:func:`measure` on the card, with a one-rank NCCL group for the
    sharded repair (its store file in the tree's build directory)."""
    import torch
    import torch.distributed as dist
    store = tree.resolve() / "build" / "ab_nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        return measure(tree)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(_ab.main(sys.argv[1:], __file__, __doc__, child,
                      agree="digests"))
