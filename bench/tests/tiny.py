"""A benchmark cell cut to a size the CPU runs in a second or two: the
cell's own configuration and traffic with a small graph, batch and load.
The timed path, the reference and the comparison are the benchmark's."""
from __future__ import annotations

from pathlib import Path

from bench import spec

ROOT = Path(__file__).resolve().parents[2]

#: cells whose files are here but whose entry ``BENCHMARK.json`` does not
#: hold yet (PERF.md, Open questions): configuration and traffic by name
LATER = {"cached.reads_deltas": ("er32k_k16_cached", "reads_deltas_backlog")}


def shrink(c):
    """``c`` with a small graph, batch, load and delta stream."""
    c.config = dict(c.config, n_nodes=256, n_edges=1024, n_fragments=4)
    if c.config.get("server"):
        c.config["server"] = dict(c.config["server"], batch_size=8)
        c.config["reserves"] = {"reserve_boundary": 16, "reserve_edges": 64,
                                "reserve_stubs": 32}
    loop = c.traffic["loop"]
    if loop == "open":
        c.traffic = dict(c.traffic, read_rate_per_s=300)
    elif loop == "backlog":
        c.traffic = dict(c.traffic, in_flight=32, reads=512)
    else:
        c.traffic = dict(c.traffic, reads=96)
    if "deltas" in c.traffic:
        c.traffic = dict(c.traffic, deltas=dict(c.traffic["deltas"],
                                                rate_per_s=3))
    return c


def cell(name: str):
    if name in LATER:
        config, traffic = LATER[name]
        return shrink(spec.Cell(
            name, 1, spec.load_json(spec.BENCH / "configs" / f"{config}.json"),
            spec.load_json(spec.BENCH / "traffic" / f"{traffic}.json"), [], []))
    return shrink(spec.load_cell(ROOT, name))
