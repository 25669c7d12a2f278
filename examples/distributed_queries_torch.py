"""Distributed-engine demo on the PyTorch/CUDA package (the counterpart of
``examples/distributed_queries.py``): the sharded partial evaluation
against the message-passing and centralized baselines, a
``repro_torch.connect`` session answering a mixed reach+dist+RPQ batch
with one fused execution per (kind, automaton) group, the ``shard_map``
backend over a process group, and 32 fragments packed onto its ranks.

The reference runs on 8 fake XLA host devices.  Here the ranks are real
processes of a ``torch.distributed`` group: on the card (the default) a
one-rank NCCL group; with ``--device cpu`` 8 gloo ranks, each its own
process running the same program (rank 0 prints).

    PYTHONPATH=src python examples/distributed_queries_torch.py     # H100
    PYTHONPATH=src python examples/distributed_queries_torch.py --device cpu
"""
import argparse
import multiprocessing
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np                                        # noqa: E402
import torch                                              # noqa: E402
import torch.distributed as dist                          # noqa: E402

import repro_torch                                        # noqa: E402
from repro_torch.core import (Dist, Reach, Rpq, dis_reach,  # noqa: E402
                              fragment_graph)
from repro_torch.core.baselines import dis_reach_m, dis_reach_n  # noqa: E402
from repro_torch.core.distributed import dis_reach_sharded  # noqa: E402
from repro_torch.graph import bfs_partition, erdos_renyi  # noqa: E402
from repro_torch.graph.graph import Graph                 # noqa: E402

CPU_RANKS = 8


def main(device: str = "cuda"):
    """The demo on this rank of the initialized default process group;
    every rank runs it and gets the same answers, rank 0 prints."""
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    # demo-sized, as the reference's
    k = 8
    g = erdos_renyi(600, 2400, n_labels=8, seed=42)
    # locality-aware partition: the paper notes |V_f| is small in practice;
    # random partitioning of an ER graph makes nearly every node boundary
    part = bfs_partition(g, k, seed=1)
    fr = fragment_graph(g, part, k)
    say(f"graph |V|={g.n} |E|={g.m}; {k} fragments; "
        f"|V_f|={fr.B - 2}; |F_m|={fr.largest_fragment()}")

    rng = np.random.default_rng(0)
    for _ in range(5):
        s, t = int(rng.integers(g.n)), int(rng.integers(g.n))
        if s == t:
            continue
        ans_sharded, _ = dis_reach_sharded(fr, s, t, device=device)
        res_vmap = dis_reach(fr, s, t, device=device)
        res_n = dis_reach_n(fr, s, t, device=device)
        res_m = dis_reach_m(fr, s, t, device=device)
        assert ans_sharded == res_vmap.answer == res_n.answer == res_m.answer
        say(f"q_r({s:4d},{t:4d}) = {str(ans_sharded):5s} | "
            f"partial-eval: 1 round, {res_vmap.stats.payload_bits}b | "
            f"message-passing: {res_m.rounds} rounds, "
            f"{res_m.site_visits} site visits | "
            f"ship-all: {res_n.traffic_bits}b")

    # session path: one handle owns the amortized caches and fuses a mixed
    # reach+dist+RPQ batch into one execution per (kind, automaton)
    session = repro_torch.connect(fr, backend="vmap", device=device)
    t0 = time.perf_counter()
    session.warm(with_dist=True)
    build = time.perf_counter() - t0
    queries = []
    for i in range(36):
        s, t = int(rng.integers(g.n)), int(rng.integers(g.n))
        queries.append(Reach(s, t) if i % 3 == 0 else
                       Dist(s, t) if i % 3 == 1 else
                       Rpq(s, t, regex="(0|1|2|3)* (4|5)*"))
    session.run(queries)                          # builds the RPQ cache
    t0 = time.perf_counter()
    results = session.run(queries)
    per_q = (time.perf_counter() - t0) / len(queries) * 1e6
    for q, r in zip(queries, results):
        if isinstance(q, Reach):
            assert r.answer == dis_reach(fr, q.s, q.t, device=device).answer
    say(session.last_plan.explain())
    say(f"warm mixed batch of {len(queries)}: {per_q:.0f}us/query "
        f"(caches built once in {build * 1e3:.0f}ms)")

    # shard_map backend: the fragments over the group's ranks, and EVERY
    # kind in the mixed batch keeps the paper's one-collective-per-fused-
    # group guarantee.  Small locality graph so the replicated
    # (|V_f| |Q|)^2 RPQ closure stays demo-sized.
    per = 20
    blocks = np.arange(8 * per) // per
    src = rng.integers(0, per, 600) + per * rng.integers(8, size=600)
    dst = rng.integers(0, per, 600) + per * rng.integers(8, size=600)
    gs = Graph(8 * per, src, dst, rng.integers(0, 8, 8 * per).astype(np.int32))
    frs = fragment_graph(gs, blocks.astype(np.int32), 8)
    sharded = repro_torch.connect(frs, backend="shard_map", device=device)
    mixed = [Reach(0, 5), Dist(3, 150), Dist(9, 90, bound=4),
             Rpq(1, 140, regex="(0|1)* 2"), Reach(100, 17)]
    res = sharded.run(mixed)
    host = repro_torch.connect(frs, backend="vmap", device=device).run(mixed)
    assert [(r.answer, r.distance) for r in res] == \
        [(r.answer, r.distance) for r in host]
    say(f"shard_map mixed batch over {dist.get_world_size()} ranks: "
        f"{sharded.last_plan.n_groups} fused groups, one collective each")
    for grp in sharded.last_plan.groups:
        states = 1 if grp.automaton is None else grp.automaton.n_states
        bits = frs.traffic_bits(grp.kind, states=states,
                                batch=grp.padded_size)
        assert sum(res[i].stats.payload_bits for i in grp.indices) == bits
        say(f"  {grp.kind}: {grp.n} queries -> {bits}b on the wire")

    # k >> d scale-out: refragment the same graph into 32 fragments and
    # pack them onto the SAME ranks (balanced placement).  Answers and
    # the wire are identical to vmap: packing is free.
    fr32 = fragment_graph(gs, (np.arange(8 * per) // (per // 4))
                          .astype(np.int32), 32)
    packed = repro_torch.connect(fr32, backend="shard_map", device=device)
    pl = packed.placement
    res32 = packed.run(mixed)
    host32 = repro_torch.connect(fr32, backend="vmap",
                                 device=device).run(mixed)
    assert [(r.answer, r.distance) for r in res32] == \
        [(r.answer, r.distance) for r in host32]
    w = pl.loads(pl.fragment_weights(fr32))
    say(f"packed scale-out: {fr32.k} fragments on {pl.d} ranks "
        f"({pl.fpd}/rank), per-rank workload "
        f"{int(w.min())}..{int(w.max())} (balanced placement)")


def _rank(rank: int, world: int, store: str, device: str) -> None:
    """One rank: join the group, run the demo, leave."""
    if device == "cuda":
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                device_id=torch.device("cuda", 0))
    else:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
    try:
        main(device)
    finally:
        dist.destroy_process_group()


def run(device: str = "cuda") -> None:
    """The demo over its process group: one NCCL rank in this process on
    the card, or CPU_RANKS gloo ranks, each a spawned process."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        if device == "cuda":
            _rank(0, 1, store, device)
            return
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, CPU_RANKS, store, device))
                 for r in range(CPU_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        for p in procs:
            p.kill()
        if failed:
            raise SystemExit(f"ranks {failed} failed")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the card and one NCCL rank (default), or "
                         f"{CPU_RANKS} gloo ranks on the CPU")
    run(ap.parse_args().device)
