"""Dry run of every (architecture x input shape) cell on the two
production meshes: the port's counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's step with its shardings
over 512 placeholder host devices (an XLA flag it sets at import) and
reads XLA's memory and cost analyses.  Nothing in PyTorch compiles a
256- or 512-way SPMD program from placements, so this dry run replaces
that lowering with what the program's abstract arguments and placements
determine.  It builds each cell at full size on the ``meta`` device,
which allocates nothing and needs no process group and no GPU, and
records:

  * status (``ok`` / ``skipped`` with the reason) and ``kind``;
  * ``arg_bytes`` (the arguments whole) and ``arg_bytes_per_dev``: each
    argument's shard under its ``P`` on the mesh, a sharded dim split by
    ceiling division, as XLA pads it;
  * ``args_fit_one_card``: whether the arguments alone fit one 80 GB card;
  * ``model_flops``, ``model_bytes`` and ``cost_scale`` of the program.

It does NOT measure the temporaries' bytes, HLO FLOPs or bytes, or the
collectives' bytes and schedule of the sharded program: no compiler
produces that program.  Collectives are recorded where a step really
runs on a mesh (``launch.collective_stats``).  Importing this module
sets nothing and starts nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k --multi-pod both --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

from ..configs import ARCHS, get_arch
from ..tree import flatten
from .mesh import PRODUCTION, MeshShape

CARD_BYTES = 80e9          # one H100 80GB


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def shard_shape(shape, spec, mesh: MeshShape):
    """A leaf's shape on one device of ``mesh`` under ``spec``."""
    size = dict(zip(mesh.names, mesh.shape))
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        out[dim] = -(-out[dim] // math.prod(size[n] for n in names))
    return tuple(out)


def arg_bytes(prog, mesh: MeshShape):
    """(bytes of the arguments whole, bytes of one device's shards)."""
    _, args = flatten(prog.abstract_args)
    _, specs = flatten(prog.arg_specs)
    if len(args) != len(specs):
        raise ValueError(f"{prog.arch_id} x {prog.shape_id}: {len(args)} "
                         f"arguments, {len(specs)} specs")
    whole = sum(_nbytes(a.shape, a.dtype) for a in args)
    per_dev = sum(_nbytes(shard_shape(a.shape, s, mesh), a.dtype)
                  for a, s in zip(args, specs))
    return whole, per_dev


def run_cell(arch_id: str, shape_id: str, multi_pod: bool,
             optimized: bool = False, verbose: bool = True) -> dict:
    """Build one cell at full size on the meta device; its record."""
    arch = get_arch(arch_id)
    mesh = PRODUCTION[multi_pod]
    rec = dict(arch=arch_id, shape=shape_id, mesh=mesh.label(),
               variant="optimized" if optimized else "baseline")
    skip = arch.skip_reason(shape_id)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    t0 = time.perf_counter()
    prog = arch.build(shape_id, multipod=multi_pod, reduced=False,
                      optimized=optimized)
    whole, per_dev = arg_bytes(prog, mesh)
    rec.update(status="ok", kind=prog.kind, n_devices=mesh.size,
               seconds=round(time.perf_counter() - t0, 3),
               arg_bytes=int(whole), arg_bytes_per_dev=int(per_dev),
               args_fit_one_card=bool(whole <= CARD_BYTES),
               model_flops=float(prog.model_flops),
               model_bytes=float(prog.model_bytes),
               cost_scale=float(prog.cost_scale))
    if verbose:
        print(f"[{arch_id} x {shape_id} x {rec['mesh']}] {prog.kind}: args "
              f"{whole / 1e9:.3f} GB whole, {per_dev / 2**30:.3f} GiB/device; "
              f"model flops {prog.model_flops:.3e}, bytes "
              f"{prog.model_bytes:.3e}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all)")
    ap.add_argument("--multi-pod", choices=("no", "yes", "both"),
                    default="both")
    ap.add_argument("--optimized", action="store_true",
                    help="build with the mesh hints and fused paths on")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    arch_ids = [args.arch] if args.arch else list(ARCHS)
    pods = {"no": [False], "yes": [True], "both": [False, True]}[args.multi_pod]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    records, failures = [], 0
    for aid in arch_ids:
        shape_ids = [args.shape] if args.shape else get_arch(aid).shape_ids()
        for sid in shape_ids:
            for mp in pods:
                try:
                    records.append(run_cell(aid, sid, mp,
                                            optimized=args.optimized))
                except Exception as e:  # noqa: BLE001 — reported, exit 1
                    failures += 1
                    traceback.print_exc()
                    records.append(dict(arch=aid, shape=sid,
                                        mesh=PRODUCTION[mp].label(),
                                        status="error", error=str(e)[:500]))
                with open(args.out, "w") as f:
                    json.dump(records, f, indent=1)
    ok = sum(1 for r in records if r["status"] == "ok")
    sk = sum(1 for r in records if r["status"] == "skipped")
    print(f"\n== dry-run: {ok} ok / {sk} skipped / {failures} failed "
          f"-> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
