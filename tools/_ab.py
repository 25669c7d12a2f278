"""The turn-taking runner behind the A/B scripts in this directory.

Each script supplies a workload, ``child(tree) -> dict``, and calls
:func:`main`.  ``python3 tools/<script>.py TREE [TREE ...]`` then runs the
workload once for each tree, in the order given (parent, change, change,
parent is the usual order), each in a child process
(``<script> --child TREE``) that imports ``repro_torch`` from
``TREE/src`` and so builds that tree's kernels.  The runner prints each
child's JSON line with the card's name and power limit added, and, when
the script names an ``agree`` key, raises unless that key's value (a
digest of the answers) is the same for every tree.
"""
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Optional


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def from_tree(module, tree: Path) -> None:
    """Raise unless ``module`` was imported from ``tree``."""
    if not Path(module.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {module.__file__}, not from {tree}")


def events_ms(fn: Callable, reps: int):
    """(ms a call, the last result) of ``reps`` calls of ``fn`` between two
    CUDA events; no warm-up."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def main(argv, script: str, doc: str, child: Callable[[Path], dict],
         agree: Optional[str] = None) -> int:
    """Run ``child`` in a child process for each tree of ``argv`` (or, with
    ``--child TREE``, be that child)."""
    if len(argv) >= 2 and argv[0] == "--child":
        tree = Path(argv[1])
        sys.path.insert(0, str(tree / "src"))
        row = {"tree": str(tree), "card": card()}
        row.update(child(tree))
        print(json.dumps(row), flush=True)
        return 0
    if not argv:
        print(doc, file=sys.stderr)
        return 2
    rows = []
    for tree in argv:
        out = subprocess.run([sys.executable, script, "--child", tree],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"child {tree} exited {out.returncode}:\n"
                               f"{out.stderr[-3000:]}")
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    if agree and len({json.dumps(r[agree], sort_keys=True)
                      for r in rows}) != 1:
        raise AssertionError(f"the trees' {agree} differ")
    return 0
