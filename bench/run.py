"""Run one cell of the port's benchmark once, on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``<cell>`` is a ``workloads`` name of
``BENCHMARK.json``.  With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
layer probes and a device trace over the same window.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers the comparison with the reference
compared, each beside its limit, which the result also carries last, under
``checks``.  Exits with 2 and prints no result when the card, or as many
cards as the cell asks for, is missing, and with 3 when a forbidden module
(``jax``, ``jaxlib``, ``flax``, ``repro``) was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """The program builds its kernels into ``build/repro_torch/`` of the
    checkout, a path it fixes; nothing else here builds or caches.  No
    library may load JAX on its own (``transformers`` would, unless
    told)."""
    os.environ["USE_FLAX"] = "0"


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness, roofline, spec
    started = harness.process_start()
    cell = spec.load_cell(ROOT, args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA device(s); "
                    f"found {have}: no result")
        return 2
    harness.log(f"card: {_power_limit()}; peaks: {roofline.PEAKS}")
    harness.log(f"{args.workload} seed {args.seed} seconds {args.seconds} "
                f"trace {args.trace}")
    run, result = harness.run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), "cuda", started)
    harness.log(f"host after the run: {harness.host_probe()}")
    harness.describe(run)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"forbidden modules loaded: {bad}: no result")
        return 3
    print(f"setup split: {json.dumps(run.setup_split)}", flush=True)
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
