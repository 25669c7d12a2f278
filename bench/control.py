"""Read the controls of ``correct`` on the card: for each seed, one run of
the cell at its own size and load, judged as a benchmark run is, and then
each control put in the program's place on the same reads and judged by
the same comparison.

    python3 bench/control.py --workload cached.reads --seconds 20 \\
        --seeds 11,12,13 --graph-seeds 0,1,2

A control is the plain reference with one guarantee broken
(:func:`bench.correctness.controlled`): ``depth_cap`` answers from a
search stopped one level short of the deepest level the window's reads
need, and, in a cell with deltas, ``stale`` answers each read from the
version before the one it names.  Each line gives the program's numbers
and each control's, and whether each came out correct; the command exits
with 1 when a control came out correct or the program did not.
``--graph-seeds`` draws the run with the i-th seed on another graph of the
configuration (its ``graph_seed``), so that the check is shown on more
than the benchmark's one graph.  The benchmark's own runs do not run
this.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def controls(cell) -> list:
    return ["depth_cap"] + (["stale"] if cell.traffic.get("deltas") else [])


def read_controls(cell, seed: int, seconds: float, device) -> dict:
    """One run of ``cell`` and every control on its reads, judged."""
    from bench import correctness, harness
    system = harness.set_up(cell, seed, device)
    run = harness.window(system, seconds, False)
    harness.tear_down(system)
    checks = correctness.judge(run, device)
    row = {"workload": cell.name, "seed": seed,
           "graph_seed": cell.config["graph_seed"], "reads": len(run.reads),
           "program": {"correct": correctness.correct(checks),
                       **{k: v["value"] for k, v in checks.items()}}}
    for which in controls(cell):
        got = correctness.judge(correctness.controlled(run, device, which),
                                device)
        row[which] = {"correct": correctness.correct(got),
                      **{k: v["value"] for k, v in got.items()}}
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--graph-seeds", default="")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import spec
    cell = spec.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    seeds = [int(s) for s in args.seeds.split(",")]
    graphs = [int(s) for s in args.graph_seeds.split(",") if s]
    ok = True
    for i, seed in enumerate(seeds):
        c = cell
        if i < len(graphs):
            c = dataclasses.replace(cell, config=dict(cell.config,
                                                      graph_seed=graphs[i]))
        row = read_controls(c, seed, args.seconds, "cuda")
        ok = ok and row["program"]["correct"] and not any(
            row[w]["correct"] for w in controls(cell))
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
