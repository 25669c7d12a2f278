"""One benchmark cell with the port's own spans and counters on.

    python3 tools/trace_cell.py --workload cached.reads --seed 7 --seconds 20

runs the cell as ``bench/run.py --trace 1`` does (set-up, the measured
window with the harness's probes and the device trace, the comparison with
the reference), with :mod:`repro_torch.tracing` enabled over the window.
The last line of standard output is the run's result line with a
``program`` block beside its metrics:

* ``readings``: the per-layer numbers the program's records give (see
  :func:`readings`);
* ``idle_gaps``: the card's idle time by the innermost span, program or
  harness, open over each gap's middle on any thread;
* ``spans``: each span name's count, median and total wall time, and CPU
  share;
* ``record_ns``: what one span, count and wait cost this host, on and off.

The program's spans and waits and the device's events go into one Chrome
trace on the host's monotonic clock, gzipped, at ``--trace-out`` (by
default ``build/trace_<cell>_<seed>.json.gz``; its path on standard
error).  ``bench/run.py`` itself never enables the recorder.
"""
from __future__ import annotations

import argparse
import gzip
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _median(xs):
    return statistics.median(xs) if xs else None


def _per_batch(spans, batches, name, kind=None):
    """Wall ms of the ``name`` spans (of attribute ``kind``, where given)
    under each batch or commit, summed a batch."""
    ms = {b.id: 0.0 for b in batches}
    for s in spans:
        if (s.name == name and s.serves in ms
                and (kind is None or s.attrs.get("kind") == kind)):
            ms[s.serves] += s.wall_ns / 1e6
    return list(ms.values()) if batches else []


#: a commit's phases, in order: reading name, span name, kind
REPAIR_PHASES = (
    ("repair.clone_ms_p50", "mvcc.clone", None),
    ("repair.apply_ms_p50", "repair.apply", None),
    ("repair.frontiers_ms_p50", "repair.frontiers", None),
    ("repair.diff_ms_p50", "repair.diff", None),
    ("repair.rank_bool_ms_p50", "repair.rank_update", "bool"),
    ("repair.rank_tropical_ms_p50", "repair.rank_update", "tropical"),
    ("repair.recompute_ms_p50", "repair.recompute", None),
    ("repair.refresh_ms_p50", "repair.refresh", None),
    ("repair.publish_ms_p50", "mvcc.publish", None),
)


def repair_readings(records) -> dict:
    """The repair lane's numbers, None where the window committed no
    delta:

    * ``serve.delta_wait_ms_p50``: median ``serve.delta_wait`` (a delta's
      submit to the repair worker's pickup), ms;
    * ``repair.commit_ms_p50``: median ``serve.commit`` (the whole commit:
      clone, repair, publish, the future resolved), ms, and
      ``repair.commit_cpu_share``, its median thread CPU over wall, %;
    * each phase of :data:`REPAIR_PHASES`: median, a commit, of its spans
      summed, ms (``repair.apply`` holds the frontiers, the diff, the rank
      updates or the recompute, and the refresh);
    * ``repair.rows_p50``: median ``repair.rows`` of each
      ``repair.apply``; ``repair.launches_p50``: median of its
      ``repair.launches`` and ``closure.squarings`` summed (the products
      of a repair, on the card one launch each);
    * ``repair.host_syncs_p50``, ``repair.upload_kib_p50``: median
      ``host.syncs`` and ``h2d.pageable_bytes`` (KiB) of each commit;
    * ``mvcc.live_versions_max``: the most versions the store held, the
      clone being repaired counted in (the ``n`` of ``mvcc.clone`` and
      ``mvcc.publish``); ``mvcc.resident_versions_max``: the most whose
      caches were resident (their ``size``: with the session's own
      version once the store let it go);
    * ``mvcc.clone_kib_p50``: median ``mvcc.clone_bytes`` of a clone, KiB;
      ``mvcc.version_gib_p50``: median ``mvcc.version_bytes`` of a
      publish, GiB (what a version holds that its base does not).
    """
    spans = [r for r in records if r.kind == "span"]
    commits = [s for s in spans if s.name == "serve.commit"
               and s.wall_ns > 0]
    applies = [s for s in spans if s.name == "repair.apply"]
    sized = [s for s in spans if s.name in ("mvcc.clone", "mvcc.publish")
             and "n" in s.attrs]
    out = {
        "serve.delta_wait_ms_p50": _median(
            [r.wall_ns / 1e6 for r in records
             if r.kind == "wait" and r.name == "serve.delta_wait"]),
        "repair.commit_ms_p50": _median([s.wall_ns / 1e6 for s in commits]),
        "repair.commit_cpu_share": _median(
            [100.0 * s.cpu_ns / s.wall_ns for s in commits]),
    }
    for name, span, kind in REPAIR_PHASES:
        out[name] = _median(_per_batch(spans, commits, span, kind))
    out.update({
        "repair.rows_p50": _median(
            [s.counts.get("repair.rows", 0) for s in applies]),
        "repair.launches_p50": _median(
            [s.counts.get("repair.launches", 0)
             + s.counts.get("closure.squarings", 0) for s in applies]),
        "repair.host_syncs_p50": _median(
            [s.counts.get("host.syncs", 0) for s in commits]),
        "repair.upload_kib_p50": _median(
            [s.counts.get("h2d.pageable_bytes", 0) / 2 ** 10
             for s in commits]),
        "mvcc.live_versions_max": max(
            (s.attrs["n"] for s in sized), default=None),
        "mvcc.resident_versions_max": max(
            (s.attrs["size"] for s in sized), default=None),
        "mvcc.clone_kib_p50": _median(
            [s.counts.get("mvcc.clone_bytes", 0) / 2 ** 10 for s in spans
             if s.name == "mvcc.clone"]),
        "mvcc.version_gib_p50": _median(
            [s.counts.get("mvcc.version_bytes", 0) / 2 ** 30 for s in spans
             if s.name == "mvcc.publish"]),
    })
    return out


def idle_gaps(records, trace, harness_spans=()):
    """The trace's idle gaps labelled by the shortest program span (and
    harness span, where given) covering each gap's middle."""
    spans = [(r.name, r.start_ns / 1e9, r.end_ns / 1e9) for r in records
             if r.kind == "span"]
    return trace.idle_gaps(list(harness_spans) + spans)


def readings(records, trace=None) -> dict:
    """The per-layer numbers of a window's records, None where they hold
    nothing to read:

    * ``serve.queue_wait_ms_p50``: median ``serve.queue_wait``, ms;
    * ``session.cpu_share``: median, over ``session.run`` spans, of thread
      CPU time over wall time, %;
    * ``session.inputs_ms_p50``, ``session.per_query_ms_p50``: median, a
      batch, of its ``cache.inputs`` (``cache.per_query``) spans summed, ms;
    * ``session.host_syncs_per_batch``, ``session.upload_mib_per_batch``:
      median ``host.syncs`` and ``h2d.pageable_bytes`` (MiB) of each
      ``serve.batch``;
    * ``device.idle_unlabelled_share.reads``: % of the idle-gap time that
      no program span covers (needs the device trace);
    * ``oneshot.local_steps_p50``: median ``fixpoint.steps`` of each
      ``oneshot.local_eval``;
    * ``oneshot.evaldg_rows_p50``, ``oneshot.evaldg_levels_p50``: median
      ``evaldg.rows`` (rows of W read) and ``evaldg.levels`` (distance
      levels settled) of each ``oneshot.evaldg`` of a dist or bounded query;
    * ``oneshot.w_entries_p50``: median ``oneshot.w_entries`` (the pairs
      W's row lists hold) of each ``oneshot.evaldg`` on row lists;
      ``oneshot.dense_fallbacks``: the queries answered again on the dense
      W, summed over the ``oneshot.query`` spans (0 where the row lists
      held every W; None where the program has no row lists);
    * the repair lane's, where deltas committed (:func:`repair_readings`).
    """
    spans = [r for r in records if r.kind == "span"]
    batches = [s for s in spans if s.name == "serve.batch"]
    runs = [s for s in spans if s.name == "session.run" and s.wall_ns > 0]
    out = {
        "serve.queue_wait_ms_p50": _median(
            [r.wall_ns / 1e6 for r in records
             if r.kind == "wait" and r.name == "serve.queue_wait"]),
        "session.cpu_share": _median(
            [100.0 * s.cpu_ns / s.wall_ns for s in runs]),
        "session.inputs_ms_p50": _median(
            _per_batch(spans, batches, "cache.inputs")),
        "session.per_query_ms_p50": _median(
            _per_batch(spans, batches, "cache.per_query")),
        "session.host_syncs_per_batch": _median(
            [b.counts.get("host.syncs", 0) for b in batches]),
        "session.upload_mib_per_batch": _median(
            [b.counts.get("h2d.pageable_bytes", 0) / 2 ** 20
             for b in batches]),
        "device.idle_unlabelled_share.reads": None,
        "oneshot.local_steps_p50": _median(
            [s.counts.get("fixpoint.steps", 0) for s in spans
             if s.name == "oneshot.local_eval"]),
    }
    settled = [s.counts for s in spans if s.name == "oneshot.evaldg"
               and s.counts and "evaldg.rows" in s.counts]
    for name in ("rows", "levels"):
        out[f"oneshot.evaldg_{name}_p50"] = _median(
            [c[f"evaldg.{name}"] for c in settled])
    listed = [s.counts["oneshot.w_entries"] for s in spans
              if s.name == "oneshot.evaldg" and s.counts
              and "oneshot.w_entries" in s.counts]
    out["oneshot.w_entries_p50"] = _median(listed)
    out["oneshot.dense_fallbacks"] = sum(
        s.counts.get("oneshot.dense_fallbacks", 0) for s in spans
        if s.name == "oneshot.query") if listed else None
    out.update(repair_readings(records))
    if trace is not None:
        gaps = idle_gaps(records, trace)
        idle = sum(sec for _, _, sec in gaps)
        if idle > 0:
            out["device.idle_unlabelled_share.reads"] = 100.0 * sum(
                sec for label, _, sec in gaps if label == "no span") / idle
    return out


def span_table(records) -> dict:
    """Each span name: count, median and total wall, CPU over wall."""
    by = {}
    for r in records:
        if r.kind == "span":
            by.setdefault(r.name, []).append(r)
    return {name: {"n": len(rs),
                   "ms_p50": statistics.median(r.wall_ns for r in rs) / 1e6,
                   "total_s": sum(r.wall_ns for r in rs) / 1e9,
                   "cpu_share": 100.0 * sum(r.cpu_ns for r in rs)
                   / max(1, sum(r.wall_ns for r in rs))}
            for name, rs in sorted(by.items())}


def chrome(records, trace=None) -> dict:
    """A Chrome trace (``chrome://tracing``, Perfetto) of the records and
    the device's events, microseconds on ``time.monotonic``: program spans
    on process 1, a thread each; waits as async slices; device events on
    process 2."""
    ev = []
    for r in records:
        if r.kind == "span":
            ev.append({"ph": "X", "name": r.name, "pid": 1, "tid": r.thread,
                       "ts": r.start_ns / 1e3, "dur": r.wall_ns / 1e3,
                       "args": dict(r.attrs, id=r.id, parent=r.parent,
                                    serves=r.serves, cpu_us=r.cpu_ns / 1e3,
                                    **r.counts)})
        elif r.kind == "wait":
            for ph, ts in (("b", r.start_ns), ("e", r.end_ns)):
                ev.append({"ph": ph, "name": r.name, "cat": "wait",
                           "id": r.id, "pid": 1, "ts": ts / 1e3,
                           "args": {"serves": r.serves}})
    if trace is not None:
        for name, a, b in trace.events:
            ev.append({"ph": "X", "name": name, "pid": 2, "tid": 0,
                       "ts": (a - trace.offset_ns) / 1e3,
                       "dur": (b - a) / 1e3})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def record_ns(reps: int = 1000, rounds: int = 50) -> dict:
    """Nanoseconds per span, count and wait on this host, on and off: the
    median of ``rounds`` rounds of ``reps`` each, drained between rounds
    (a batch of the served cell makes some tens of records)."""
    from repro_torch import tracing

    def span():
        with tracing.span("x"):
            pass
    sites = {"span": span, "count": lambda: tracing.count("x"),
             "wait": lambda: tracing.wait("x", 0, 1, 0)}
    out = {}
    for state in ("off", "on"):
        if state == "on":
            tracing.enable()
        for name, site in sites.items():
            per = []
            for _ in range(rounds):
                with tracing.span("outer"):
                    t = time.perf_counter_ns()
                    for _ in range(reps):
                        site()
                    per.append((time.perf_counter_ns() - t) / reps)
                tracing.drain()
            out[f"{name}_{state}"] = statistics.median(per)
    tracing.disable()
    tracing.drain()
    return out


def traced_run(cell, seed: int, seconds: float, device, started=None):
    """``bench/run.py --trace 1``'s run with the recorder on over the
    window: ``(run, result, records)``."""
    from bench import harness
    from repro_torch import tracing
    system = harness.set_up(cell, seed, device, started)
    tracing.enable()
    try:
        run = harness.window(system, seconds, True)
    finally:
        tracing.disable()
    records = tracing.drain()
    harness.tear_down(system)
    return run, harness.finish(cell, run, True, system.device), records


def program_block(run, records) -> dict:
    block = {"readings": readings(records, run.trace),
             "spans": span_table(records)}
    if run.trace is not None:
        from bench import trace as tracemod
        block["idle_gaps"] = tracemod.gap_summary(
            idle_gaps(records, run.trace, run.spans.items), count=16)
    return block


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace-out", type=Path, default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness, run as runmod, spec
    started = harness.process_start()
    runmod._environment()
    cell = spec.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA device: no result")
        return 2
    harness.log(f"card: {runmod._power_limit()}")
    cost = record_ns()
    run, result, records = traced_run(cell, args.seed, args.seconds, "cuda",
                                      started)
    harness.describe(run)
    block = program_block(run, records)
    block["record_ns"] = cost
    block["records"] = len(records)
    out = args.trace_out or (
        ROOT / "build" / f"trace_{args.workload}_{args.seed}.json.gz")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(gzip.compress(json.dumps(chrome(records,
                                                   run.trace)).encode()))
    harness.log(f"chrome trace: {out}")
    checks = result.pop("checks")
    result["program"] = block
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
