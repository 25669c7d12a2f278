"""Dry run of every (architecture x input shape) cell on the two
production meshes: the port's counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's step with its shardings
over 512 placeholder host devices (an XLA flag it sets at import) and
reads XLA's memory and cost analyses.  Nothing in PyTorch compiles a
256- or 512-way SPMD program from placements, so this dry run has two
halves, both run on the CPU with nothing allocated and no GPU:

  * from the program alone: each cell built at full size on the
    ``meta`` device; ``arg_bytes`` (the arguments whole) and
    ``arg_bytes_per_dev`` (each argument's shard under its ``P``, a
    sharded dim split by ceiling division, as XLA pads it),
    ``args_fit_one_card``, ``model_flops``, ``model_bytes`` and
    ``cost_scale``;
  * from one run of the step (:mod:`.step_costs`): the step run once by
    rank 0 of a fake process group of 256 or 512 ranks on the production
    ``DeviceMesh``, its arguments DTensors with meta shards.  It records
    the reference's fields under the reference's names, so that records
    of the two packages line up: ``hlo_flops`` and ``hlo_bytes``,
    ``temp_bytes_per_dev`` (MemTracker's peak less the arguments),
    ``out_bytes_per_dev``, ``peak_bytes_per_dev`` (arguments plus
    temporaries; the results are among the temporaries, since an eager
    step allocates them), ``fits_one_card`` (that sum within one 80 GB
    card), ``collective_bytes``, ``collective_count``,
    ``collective_breakdown``, ``collective_schedule`` and the cost
    probes ``probe_flops``, ``probe_bytes``, ``probe_collective_bytes``
    and ``probe_method`` (:func:`probe_costs`).

The ``hlo_`` names are kept for that parity only: these are eager
DTensor counts of rank 0's local ops (``"counter": "dtensor-eager"``,
with the ``torch`` version that made them), not XLA's.  The collectives
of the departures from GSPMD, the redistributions by which the model
code steps around DTensor's gaps (``segment_max`` gathered whole, the
vocab dim gathered, ``batch_sharded`` views, MoE routing on every rank,
the KV-cache write), are left out of the ``collective_*`` fields, which
hold what the reference's program has too, and counted by name in
``departure_collectives``.  A cell that fails is recorded with
``status: "error"``, its message and traceback, and the CLI exits 1.
Importing this module sets nothing and starts nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k --multi-pod both --out build/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCHS, get_arch
from ..tree import flatten
from .collective_stats import (collective_bytes, collective_schedule,
                               split_departures)
from .mesh import PRODUCTION, MeshShape, shard_shape
from .step_costs import StepCosts, cell_costs

CARD_BYTES = 80e9          # one H100 80GB
COUNTER = "dtensor-eager"  # what counted hlo_flops, hlo_bytes, collectives


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


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


def _costs(costs: StepCosts, scale: float = 1.0) -> dict:
    kept, _ = split_departures(costs.collectives)
    return dict(flops=costs.flops * scale, bytes=costs.bytes * scale,
                coll=collective_bytes(kept)["total"] * scale)


def probe_costs(arch, shape_id: str, multi_pod: bool,
                optimized: bool = False) -> dict:
    """The reference's loop-free cost probes, for parity of the record
    (XLA counts a loop body once; an eager step runs every iteration, so
    here the probes restate the direct count).  LM: 2- and 4-layer
    unrolled probes, extrapolated linearly in n_layers (slope clamped
    non-negative), x grad-accum for train.  recsys serve_bulk: one chunk
    x n_chunks.  Everything else: ``{}`` (the direct counts stand)."""
    fam = getattr(arch, "family", "")
    if fam == "lm":
        p2, p4 = (arch.build(shape_id, multipod=multi_pod, probe_layers=n,
                             optimized=optimized) for n in (2, 4))
        c2, c4 = (_costs(cell_costs(p, multi_pod)) for p in (p2, p4))
        L = arch.base_cfg.n_layers
        scale = p2.cost_scale
        out = {k: scale * (c2[k] + max((c4[k] - c2[k]) / 2.0, 0.0) * (L - 2))
               for k in ("flops", "bytes", "coll")}
        out["method"] = f"lm-2pt-extrapolation(L={L}, scale={scale})"
        return out
    if fam == "recsys" and shape_id == "serve_bulk":
        p = arch.build(shape_id, multipod=multi_pod, probe=True,
                       optimized=optimized)
        c = _costs(cell_costs(p, multi_pod), scale=p.cost_scale)
        return dict(c, method=f"chunk-probe(x{p.cost_scale})")
    return {}


def compiled_fields(costs: StepCosts, arg_bytes_per_dev: int) -> dict:
    """The reference's compiled fields of a record from one run of the
    step; the collectives of the departures from GSPMD apart."""
    kept, apart = split_departures(costs.collectives)
    coll = collective_bytes(kept)
    return dict(
        counter=COUNTER,
        hlo_flops=float(costs.flops),
        hlo_bytes=float(costs.bytes),
        temp_bytes_per_dev=int(costs.temp_bytes),
        out_bytes_per_dev=int(costs.out_bytes),
        peak_bytes_per_dev=int(arg_bytes_per_dev + costs.temp_bytes),
        fits_one_card=bool(arg_bytes_per_dev + costs.temp_bytes
                           <= CARD_BYTES),
        collective_bytes=int(coll["total"]),
        collective_count=int(coll["count"]),
        collective_breakdown={k: int(v) for k, v in coll.items()
                              if k not in ("total", "count")},
        collective_schedule=collective_schedule(kept),
        departure_collectives={
            name: dict(bytes=int(sum(c.nbytes for c in cs)), count=len(cs),
                       breakdown={k: int(v) for k, v in
                                  collective_bytes(cs).items()
                                  if k not in ("total", "count")})
            for name, cs in apart.items()})


def run_cell(arch_id: str, shape_id: str, multi_pod: bool,
             optimized: bool = False, verbose: bool = True,
             compiled: bool = True, probes: bool = True) -> dict:
    """One cell's record: built at full size on the meta device and, with
    ``compiled``, its step run once on the production mesh of a fake
    process group (with ``probes``, the cost probes too)."""
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
               arg_bytes=int(whole), arg_bytes_per_dev=int(per_dev),
               args_fit_one_card=bool(whole <= CARD_BYTES),
               model_flops=float(prog.model_flops),
               model_bytes=float(prog.model_bytes),
               cost_scale=float(prog.cost_scale))
    if compiled:
        rec.update(compiled_fields(cell_costs(prog, multi_pod), per_dev),
                   torch=torch.__version__)
    del prog
    rec["seconds"] = round(time.perf_counter() - t0, 3)
    if compiled and probes:
        pc = probe_costs(arch, shape_id, multi_pod, optimized=optimized)
        if pc:
            rec.update(probe_flops=pc["flops"], probe_bytes=pc["bytes"],
                       probe_collective_bytes=pc["coll"],
                       probe_method=pc["method"])
        else:   # nothing to probe: the direct counts stand
            rec.update(probe_flops=rec["hlo_flops"],
                       probe_bytes=rec["hlo_bytes"],
                       probe_collective_bytes=float(rec["collective_bytes"]),
                       probe_method="loop-free-direct")
    if verbose:
        print(f"[{arch_id} x {shape_id} x {rec['mesh']}] {rec['kind']}: args "
              f"{whole / 1e9:.3f} GB whole, {per_dev / 2**30:.3f} GiB/device; "
              f"model flops {rec['model_flops']:.3e} ({rec['seconds']} s)")
        if compiled:
            departed = sum(d["bytes"]
                           for d in rec["departure_collectives"].values())
            print(f"  memory/device: args={per_dev / 2**30:.2f}GiB "
                  f"temp={rec['temp_bytes_per_dev'] / 2**30:.2f}GiB "
                  f"out={rec['out_bytes_per_dev'] / 2**30:.2f}GiB")
            print(f"  eager flops={rec['hlo_flops']:.3e} "
                  f"bytes={rec['hlo_bytes']:.3e} "
                  f"collective={rec['collective_bytes'] / 2**20:.1f}MiB "
                  f"({rec['collective_count']} ops), departures "
                  f"{departed / 2**20:.1f}MiB")
            print(f"  schedule: {rec['collective_schedule'][:4]}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all)")
    ap.add_argument("--multi-pod", choices=("no", "yes", "both"),
                    default="both")
    ap.add_argument("--optimized", action="store_true",
                    help="build with the mesh hints and fused paths on")
    ap.add_argument("--out", default="build/dryrun_torch.json")
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
                    # cost probes only on the single-pod mesh, as the
                    # reference's (its roofline table is single-pod)
                    records.append(run_cell(aid, sid, mp, probes=not mp,
                                            optimized=args.optimized))
                except Exception as e:  # noqa: BLE001 — reported, exit 1
                    failures += 1
                    traceback.print_exc()
                    records.append(dict(arch=aid, shape=sid,
                                        mesh=PRODUCTION[mp].label(),
                                        status="error", error=str(e)[:500],
                                        traceback=traceback.format_exc()))
                with open(args.out, "w") as f:
                    json.dump(records, f, indent=1)
    ok = sum(1 for r in records if r["status"] == "ok")
    sk = sum(1 for r in records if r["status"] == "skipped")
    print(f"\n== dry-run: {ok} ok / {sk} skipped / {failures} failed "
          f"-> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
