"""CLI: ``python -m repro_torch.analysis --all`` — run every pass and exit
non-zero on any violation.

The wire pass runs the real sharded programs on a gloo group of 8 CPU
processes, so it needs no card: each rank
is a ``python -c`` process started here, which builds the same
fragmentations, opens a ``backend="shard_map"`` session with a warm reach
cache, commits one delta through an MVCC store (a sharded repair, so two
versions are live) and verifies every live version; rank 0 reports.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

RANKS = 8
TIMEOUT_S = 600

_RANK = r"""
import json, sys
sys.path.insert(0, __SRC__)
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + __STORE__,
                        rank=rank, world_size=__RANKS__)
import repro_torch
from repro_torch import GraphDelta
from repro_torch.analysis.wire_check import verify_store
from repro_torch.core.fragments import fragment_graph
from repro_torch.core.versions import VersionedCacheStore
from repro_torch.graph import erdos_renyi, random_partition

reserve = dict(reserve_boundary=16, reserve_edges=32, reserve_stubs=16)
configs = [
    # exact fit: k = d, one fragment per rank
    ("k8d8", erdos_renyi(48, 140, n_labels=4, seed=5), 8),
    # packed: k = 4d fragments, fpd = 4
    ("k32d8", erdos_renyi(96, 300, n_labels=4, seed=9), 32),
]
violations, covered = [], []
for name, g, k in configs:
    fr = fragment_graph(g, random_partition(g, k, 1), k, **reserve)
    sess = repro_torch.connect(fr, backend="shard_map", device="cpu").warm()
    store = VersionedCacheStore(sess, capacity=4)
    _, stats = store.commit_delta(GraphDelta.insert([(0, 1)]))
    live = list(store.live())
    assert len(live) >= 2, f"{name}: expected >= 2 live versions"
    for v in verify_store(store, batch=__BATCH__):
        v.where = f"{name}:{v.where}"
        violations.append(v.to_dict())
    covered.append(f"{name}: {len(live)} versions x 5 programs "
                   f"(d={sess.placement.d}, fpd={sess.placement.fpd}, "
                   f"delta {stats.mode})")
every = [None] * dist.get_world_size()
dist.all_gather_object(every, violations)
if rank == 0:
    print(json.dumps({"violations": violations, "covered": covered,
                      "same_on_every_rank": all(v == violations
                                                for v in every)}))
dist.destroy_process_group()
"""


def _wire_section(batch: int):
    """Spawn the gloo ranks and return (violations, extra)."""
    from .report import Violation

    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        code = (_RANK.replace("__SRC__", repr(src))
                .replace("__STORE__", repr(os.path.join(tmp, "store")))
                .replace("__RANKS__", str(RANKS))
                .replace("__BATCH__", str(batch)))
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=TIMEOUT_S))
        finally:
            for p in procs:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"wire pass: rank {r} exited "
                               f"{p.returncode}:\n{err[-3000:]}")
    rep = json.loads(outs[0][0].strip().splitlines()[-1])
    vs = [Violation(**v) for v in rep["violations"]]
    if not rep["same_on_every_rank"]:
        vs.append(Violation("HLO001", "the ranks found different "
                            "violations", where="wire"))
    return vs, {"covered": rep["covered"], "ranks": RANKS}


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="wire guarantee verifier + concurrency lint of the port")
    p.add_argument("--all", action="store_true",
                   help="run every pass (default if none selected)")
    p.add_argument("--wire", action="store_true",
                   help="run + verify the sharded programs on gloo CPU "
                        "ranks (HLO001-004)")
    p.add_argument("--lint", action="store_true",
                   help="AST lint over src/repro_torch (RPR000-005)")
    p.add_argument("--locks", action="store_true",
                   help="static lock-order check (LCK001-003)")
    p.add_argument("--root", default=os.getcwd(),
                   help="repo root (default: cwd)")
    p.add_argument("--batch", type=int, default=2,
                   help="fused batch size of the wire pass")
    p.add_argument("--out", default=None, help="write the JSON report here")
    args = p.parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.all or not (args.wire or args.lint or args.locks):
        args.wire = args.lint = args.locks = True

    from .report import dump_report, make_report

    sections, extra = {}, {}
    if args.wire:
        sections["wire"], extra["wire"] = _wire_section(args.batch)
    if args.lint:
        from .lint import lint_paths
        src = os.path.join(args.root, "src", "repro_torch")
        sections["lint"] = lint_paths([src if os.path.isdir(src)
                                       else args.root])
    if args.locks:
        from .locks import LOCK_ORDER, check_lock_order
        vs, edges = check_lock_order(args.root)
        sections["locks"] = vs
        extra["locks"] = {"order": list(LOCK_ORDER),
                          "edges": sorted(f"{a} -> {b}" for a, b in edges)}

    report = make_report(sections, extra=extra)
    if args.out:
        dump_report(report, args.out)
    json.dump(report, sys.stdout, indent=2)
    print()
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
