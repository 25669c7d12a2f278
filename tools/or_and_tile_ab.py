#!/usr/bin/env python3
"""Time the or-and kernel's tile route at the rank update's T shape,
[64, 16103] x [16103, 16103] through C^T, with the package of one or
more source trees, each in a child process, in the order given:

    git archive <commit> src | tar -x -C build/parent
    python3 tools/or_and_tile_ab.py build/parent . . build/parent

(``build/`` is ignored by git; one CUDA device.)  Each child imports
``repro_torch`` from ``<tree>/src``, builds its kernels there, and
prints one JSON line with the card's name and power limit: the median
of 5 runs of 20 calls (CUDA events after a warm-up) of
``or_and_matmul_nt(rows, C^T)`` with ``rows`` as the repair hands it
(not K-major, so each call copies it) and with ``rows`` copied K-major
once.  The operands are seeded random matrices, C at density 0.3 and
rows at 0.01; the product is checked against the plain version.
"""
import json
import statistics
import subprocess
import sys
from pathlib import Path

NB, R = 16103, 64


def child(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels.bool_matmul import ops as bops
    from repro_torch.kernels.bool_matmul import (kmajor, kmajor_copy,
                                                 or_and_matmul_nt,
                                                 or_and_matmul_ref)
    if not Path(bops.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {bops.__file__}, not from {tree}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    C = torch.rand((NB, NB), device=dev, generator=g) < 0.3
    Ct = kmajor_copy(C.T)
    rows = torch.rand((R, NB), device=dev, generator=g) < 0.01
    rows_k = kmajor(rows)
    if not torch.equal(or_and_matmul_nt(rows, Ct), or_and_matmul_ref(rows, C)):
        raise AssertionError("the tile route disagrees with its plain version")

    def timed(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    return {"tree": str(tree), "card": card,
            "T_ms": statistics.median(
                timed(lambda: or_and_matmul_nt(rows, Ct)) for _ in range(5)),
            "T_kmajor_rows_ms": statistics.median(
                timed(lambda: or_and_matmul_nt(rows_k, Ct))
                for _ in range(5))}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve())))
        return 0
    for tree in sys.argv[1:] or ["."]:
        subprocess.run([sys.executable, __file__, "--child", tree],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
