"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the metrics.

The program under test is the PyTorch and CUDA port, ``repro_torch``,
imported from ``src/`` of the checkout.  It gets the benchmark's inputs
(the graph and partition as its ``Graph`` and ``fragment_graph``, the
reads and deltas through its ``QueryServer`` or ``QuerySession``) and
nothing else; its spans and counters are read through wrappers the
harness puts around its calls (:mod:`bench.instrument`) and the device
trace (:mod:`bench.trace`).

Set-up, all of it counted in ``setup_s``, is split into: importing and
starting CUDA, loading the kernel libraries (built once into
``build/repro_torch/`` of the checkout, the first run of a checkout
compiles them), making the graph, cutting it into fragments, building the
caches, and warming up the shapes this cell's traffic uses.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import correctness, trace as tracemod
from .data import generate as gen
from .instrument import Probes
from .record import DeltaRec, Run
from .spec import Cell, driver, reader

#: top-level module names that may not be loaded in a measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: the kernel libraries the query paths launch
KERNELS = ("or_and_matmul", "or_and_skinny", "min_plus_matmul")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def process_start() -> Optional[float]:
    """When this process started, on ``time.monotonic`` (from
    ``/proc/self/stat``, in clock ticks), or None where that is not to be
    read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - (time.clock_gettime(time.CLOCK_BOOTTIME)
                                   - started)
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def host_probe() -> str:
    """How fast this host runs Python and a launch-and-sync round trip
    right now: a diagnostic line, no metric."""
    import torch
    t = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i
    py_ms = (time.perf_counter() - t) * 1e3
    out = f"python loop {py_ms:.2f} ms"
    if torch.cuda.is_available():
        a = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            a += 1
            torch.cuda.synchronize()
        out += f", launch+sync {(time.perf_counter() - t) / 200 * 1e6:.1f} us"
    return out + f", cpus {len(os.sched_getaffinity(0))}, load {os.getloadavg()[0]:.2f}"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, compared as
    a whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class _Timer:
    def __init__(self, split: Dict[str, float], sync: Callable[[], None]):
        self.split, self.sync = split, sync

    def __call__(self, name: str, start: float) -> float:
        self.sync()
        now = time.monotonic()
        self.split[name] = now - start
        return now


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------

def build_fragments(config: dict, g: gen.GraphData):
    from repro_torch.core.fragments import fragment_graph
    from repro_torch.graph import Graph
    graph = Graph(g.n, g.src, g.dst, g.labels)
    return fragment_graph(graph, g.part, g.k, **config.get("reserves", {}))


def build_system(config: dict, fr, device):
    """``(session, server)``: the session of the configuration's cache
    mode, its caches built; the server when the configuration has one."""
    from repro_torch import connect
    from repro_torch.serve import QueryServer
    session = connect(fr, cache=config["cache"], device=device)
    srv_cfg = config.get("server")
    if config["cache"] == "amortized":
        session.warm(with_dist=bool(srv_cfg and srv_cfg["with_dist"]))
    if not srv_cfg:
        return session, None
    server = QueryServer(fr, session=session, warm=False,
                         batch_size=srv_cfg["batch_size"],
                         with_dist=srv_cfg["with_dist"],
                         mvcc=srv_cfg["mvcc"], versions=srv_cfg["versions"],
                         batch_wait_ms=srv_cfg["batch_wait_ms"])
    return session, server


def _group_kinds(mix: dict) -> List[str]:
    """The execution groups the mix's kinds fall into: reach, and dist
    (which bounded reads share)."""
    shares = mix["shares"]
    out = []
    if shares.get("reach", 0):
        out.append("reach")
    if shares.get("dist", 0) or shares.get("bounded", 0):
        out.append("dist")
    return out


def warm_server(server, traffic: dict, g: gen.GraphData, seed: int,
                warm_deltas: List[gen.Delta]) -> List[DeltaRec]:
    """Every group size the traffic can form, each kind alone, batch sizes
    1, 2, 4, ... up to the server's; then the warm-up deltas, each to its
    commit."""
    from .traffic.serving import program_delta
    rng = gen.rng(seed, gen.WARMUP)
    b = 1
    while b <= server.batch_size:
        for kind in _group_kinds(traffic["mix"]):
            pairs = rng.integers(0, g.n, size=(b, 2))
            futs = [server.submit(int(s), int(t), kind=kind)
                    for s, t in pairs]
            for f in futs:
                f.result(timeout=120)
        b *= 2
    recs = []
    for d in warm_deltas:
        now = time.monotonic()
        rec = DeltaRec(d, now, now)
        fut = server.submit_delta(program_delta(d))
        try:
            rec.mode = fut.result(timeout=120).mode
            rec.ok = True
        except Exception as exc:          # recorded; the run goes on
            rec.error = f"{type(exc).__name__}: {exc}"
        rec.done = fut.resolved_at
        recs.append(rec)
    return recs


def warm_session(session, traffic: dict, g: gen.GraphData, seed: int) -> None:
    """One query of each kind the mix sends."""
    qmod = driver("closed")
    rng = gen.rng(seed, gen.WARMUP)
    for kind in gen.KINDS:
        if traffic["mix"]["shares"].get(kind, 0):
            s, t = (int(x) for x in rng.integers(0, g.n, size=2))
            session.run([qmod.query_of(gen.read_of(kind, s, t,
                                                   traffic["mix"]))])


class _GcPauses:
    """The collector's pauses while the window is open: ``(generation,
    seconds)`` each."""

    def __init__(self):
        self.pauses: List[Tuple[int, float]] = []
        self._t = 0.0
        gc.callbacks.append(self)

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t))

    def close(self) -> None:
        gc.callbacks.remove(self)


# ---------------------------------------------------------------------------
# one run: set-up, the window, the reference
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class System:
    """The system under test, built and warm, and what set-up recorded."""

    cell: Cell
    seed: int
    device: object
    sync: Callable[[], None]
    started: float
    split: Dict[str, float]
    graph: gen.GraphData
    fr: object
    session: object
    server: object
    v_base: Optional[int] = None       # cache version before any delta
    warm_deltas: List[DeltaRec] = dataclasses.field(default_factory=list)
    delta_ctx: Optional[gen.DeltaContext] = None   # deltas drawn so far


def set_up(cell: Cell, seed: int, device, started: Optional[float] = None,
           plant: Optional[Callable] = None) -> System:
    """Build and warm the cell's system, timing each part of set-up.
    ``plant(session, server)``, when given, is called once the system is
    built: the tests plant a fault in the timed path with it."""
    import torch
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if started is None:
        started = time.monotonic()
    split: Dict[str, float] = {}
    stamp = _Timer(split, sync)
    t = started
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
    t = stamp("import_and_cuda_init", t)
    if cuda:
        from repro_torch.kernels import _build
        _build.build(KERNELS)
        for name in KERNELS:
            _build.library(name)
    t = stamp("kernel_libraries", t)
    config, traffic = cell.config, cell.traffic
    g = gen.make_graph(config, seed, cell.bench_dir)
    t = stamp("graph", t)
    fr = build_fragments(config, g)
    t = stamp("fragments", t)
    session, server = build_system(config, fr, device)
    t = stamp("cache_build", t)
    if plant is not None:
        plant(session, server)
    system = System(cell, seed, device, sync, started, split, g, fr, session,
                    server, v_base=session.cache_version,
                    delta_ctx=gen.DeltaContext(g))
    if server is not None:
        warm = []
        dspec = traffic.get("deltas")
        if dspec:
            # each shape the stream sends, in equal shares, until the MVCC
            # store holds as many versions as it keeps (and the allocator
            # the blocks they take)
            shapes = {k: 1 for k, v in dspec["shapes"].items() if v}
            count = max(len(shapes), config["server"]["versions"] + 2)
            warm = gen.make_deltas(g, count, dict(dspec, shapes=shapes),
                                   seed, gen.WARMUP_DELTAS, cell.bench_dir,
                                   system.delta_ctx)
        system.warm_deltas = warm_server(server, traffic, g, seed, warm)
    else:
        warm_session(session, traffic, g, seed)
    stamp("warm_up", t)
    return system


def window(system: System, seconds: float, trace: bool,
           traffic: Optional[dict] = None, seed: Optional[int] = None) -> Run:
    """One measured window of ``traffic`` (the cell's own by default) with
    inputs from ``seed`` (the system's by default), probes and the device
    trace on when ``trace``."""
    cell, server, session = system.cell, system.server, system.session
    traffic = traffic or cell.traffic
    seed = system.seed if seed is None else seed
    run = Run(cell.name, seed, seconds, cell.config, traffic,
              graph=system.graph)
    run.warm_deltas = list(system.warm_deltas)
    qdriver = driver(traffic["loop"], cell.bench_dir)
    plan = qdriver.prepare(system, traffic, seed, seconds)

    probes = None
    if trace:
        probes = Probes(system.sync)
        probes.session(session)
        if server is not None and server.store is not None:
            probes.repair(session)
        if cell.config["cache"] == "none":
            probes.oneshot()
        run.layers, run.spans = probes.layers, probes.spans
        if system.fr.rvset_cache is not None:
            run.layers.nb = system.fr.rvset_cache.nb
    # everything built so far (the modules, the graph, the inputs) leaves
    # the collector's view, so that a full collection in the window scans
    # only what the window makes
    gc.collect()
    gc.freeze()
    dtrace = None
    if trace and system.device.type == "cuda":
        dtrace = tracemod.DeviceTrace()
        dtrace.start()
    pauses = _GcPauses()
    b0 = server.batches_run if server is not None else 0
    (run.t0, run.t_end, run.give_up, run.reads,
     run.deltas) = qdriver.drive(system, plan, seconds)
    if server is not None:
        run.batches_run = server.batches_run - b0
        run.batch_size = server.batch_size
    system.sync()
    pauses.close()
    run.gc_pauses = pauses.pauses
    gc.unfreeze()
    if dtrace is not None:
        dtrace.stop()
        run.trace = dtrace
    if probes is not None:
        probes.remove()
    run.setup_s = run.t0 - system.started
    run.setup_split = dict(system.split)
    if system.device.type == "cuda":
        import torch
        run.memory_peak_bytes = int(
            torch.cuda.max_memory_allocated(system.device))
    return run


def tear_down(system: System) -> None:
    """Stop the server and free the program's state, so that the
    reference runs beside nothing of it."""
    import torch
    if system.server is not None:
        system.server.close()
    system.server = system.session = system.fr = None
    gc.collect()
    if system.device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: Optional[float] = None,
             plant: Optional[Callable] = None) -> Tuple[Run, dict]:
    """Run ``cell`` once and judge it.  Returns the run record and the
    result line's object (``checks`` last)."""
    system = set_up(cell, seed, device, started, plant)
    run = window(system, seconds, trace)
    tear_down(system)
    return run, finish(cell, run, trace, system.device)


def finish(cell: Cell, run: Run, trace: bool, device) -> dict:
    """Judge the run, read its metrics and assemble the result line."""
    import torch
    t = time.monotonic()
    checks = correctness.judge(run, device)
    log(f"reference: {len(run.reads)} reads judged in "
        f"{time.monotonic() - t:.4f} s")
    values = {}
    for m in cell.metrics(trace):
        v = reader(m["name"], cell.bench_dir)(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": run.memory_peak_bytes}
    failed = (sum(1 for r in run.reads if not r.ok)
              + sum(1 for d in run.deltas if not d.ok))
    result = {"correct": correctness.correct(checks),
              "attempted": len(run.reads) + len(run.deltas),
              "failed": failed, "metrics": values, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s()
        gaps = run.trace.idle_gaps(run.spans.items)
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": tracemod.gap_summary(gaps)}
        for label, at, sec in sorted(gaps, key=lambda x: -x[2])[:10]:
            log(f"idle gap {sec * 1e3:.4f} ms at +{at - run.t0:.4f} s "
                f"during {label}")
    result["checks"] = checks
    return result


def describe(run: Run) -> None:
    """What the run did, on standard error (earlier lines)."""
    split = dict(run.setup_split)
    split["inputs_and_collect"] = run.setup_s - sum(split.values())
    log(f"setup_s {run.setup_s:.4f} s: "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    lat = np.array([r.latency_s(run.give_up) for r in run.reads]) * 1e3
    late = np.array([r.sent - r.due for r in run.reads]) * 1e3
    if len(lat):
        log(f"reads {len(run.reads)} in {run.window_s:.4f} s: latency p50 "
            f"{np.percentile(lat, 50):.4f} ms, p95 "
            f"{np.percentile(lat, 95):.4f}, p99 {np.percentile(lat, 99):.4f}"
            f", max {lat.max():.4f}; sender lateness p50 "
            f"{np.percentile(late, 50):.4f} ms, p99 "
            f"{np.percentile(late, 99):.4f}, max {late.max():.4f}")
    shares: Dict[str, List[int]] = {}
    for r in run.reads:
        if r.ok and isinstance(r.value, bool):
            k = shares.setdefault(r.read.kind, [0, 0])
            k[0] += r.value
            k[1] += 1
    if shares:
        log("answers True: " + ", ".join(f"{k} {t} of {n}"
                                         for k, (t, n) in shares.items()))
    if run.deltas:
        modes: Dict[str, int] = {}
        for d in run.deltas:
            modes[d.mode or "failed"] = modes.get(d.mode or "failed", 0) + 1
        vs = [r.version for r in run.reads if r.ok] or [None]
        com = np.array([d.latency_s(run.give_up) for d in run.deltas]) * 1e3
        log(f"deltas {len(run.deltas)} (+{len(run.warm_deltas)} in warm-up):"
            f" modes {modes}; versions read {min(vs)}..{max(vs)}; due to "
            f"commit p50 {np.percentile(com, 50):.4f} ms, p95 "
            f"{np.percentile(com, 95):.4f}, max {com.max():.4f}")
    if run.batch_size:
        log(f"batches {run.batches_run} of at most {run.batch_size}")
    if len(lat):
        due = np.array([r.due for r in run.reads]) - run.t0
        edges = np.arange(0.0, run.seconds + 2.0, 2.0)
        parts = []
        for a, b in zip(edges, edges[1:]):
            sel = (due >= a) & (due < b)
            if sel.any():
                parts.append(f"{a:.0f}s {np.percentile(lat[sel], 95):.2f}")
        log("p95 ms by 2 s of the window: " + ", ".join(parts))
    full = [sec for gen_, sec in run.gc_pauses if gen_ == 2]
    log(f"collector in the window: {len(run.gc_pauses)} pauses, "
        f"{sum(s for _, s in run.gc_pauses) * 1e3:.2f} ms; full "
        f"{len(full)}, longest {max(full, default=0.0) * 1e3:.2f} ms")
