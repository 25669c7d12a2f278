"""Merge the dry run's record files and print its table: the port's
counterpart of ``benchmarks/summarize_dryrun.py``, over the records of
``python -m repro_torch.launch.dryrun``, with the reference's columns and
one more, ``fits one card``: the arguments' and temporaries' bytes on one
device (``arg_bytes_per_dev + temp_bytes_per_dev``) within one 80 GB card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.summarize_dryrun
  PYTHONPATH=src python -m repro_torch.launch.summarize_dryrun \\
      'build/dr_*.json' --out build/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import glob
import json

from .dryrun import CARD_BYTES


def merge(pattern: str = "build/dryrun_torch.json", out: str = None):
    """Every record of the files ``pattern`` matches, one per (arch,
    shape, mesh); an ok record is preferred to an error one (a retry of
    a failed cell).  Written to ``out`` when given."""
    by_key = {}
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            for r in json.load(f):
                key = (r["arch"], r["shape"], r["mesh"])
                prev = by_key.get(key)
                if prev is None or (prev["status"] == "error"
                                    and r["status"] != "error"):
                    by_key[key] = r
    records = list(by_key.values())
    if out:
        with open(out, "w") as f:
            json.dump(records, f, indent=1)
    return records


def fits_one_card(r) -> bool:
    return r["arg_bytes_per_dev"] + r["temp_bytes_per_dev"] <= CARD_BYTES


def dryrun_table(records, mesh=None):
    rows = []
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if mesh and r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"SKIP | {r['reason'][:60]}... |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"ERROR | {r.get('error', '')[:60]} |")
            continue
        gib = r["peak_bytes_per_dev"] / 2**30
        coll_mib = r["collective_bytes"] / 2**20
        sched = "; ".join(r["collective_schedule"][:2])
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {gib:.2f} | "
            f"{r.get('probe_flops', r['hlo_flops']):.2e} | "
            f"{coll_mib:.0f} | {r['collective_count']} | {sched[:80]} | "
            f"{'yes' if fits_one_card(r) else 'no'} |")
    hdr = ("| arch | shape | mesh | GiB/dev | HLO FLOPs/dev | coll MiB/dev "
           "| #coll | schedule (head) | fits one card |")
    sep = "|---" * 9 + "|"
    return "\n".join([hdr, sep] + rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pattern", nargs="?", default="build/dryrun_torch.json",
                    help="record files (a glob)")
    ap.add_argument("--out", default=None, help="write the merged records")
    args = ap.parse_args(argv)
    recs = merge(args.pattern, args.out)
    ok = sum(1 for r in recs if r["status"] == "ok")
    sk = sum(1 for r in recs if r["status"] == "skipped")
    er = sum(1 for r in recs if r["status"] == "error")
    print(f"merged: {len(recs)} records ({ok} ok / {sk} skipped / {er} err)\n")
    print(dryrun_table(recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
