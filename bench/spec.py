"""The benchmark's specification, found by name.

``BENCHMARK.json`` at the root of the checkout names every configuration,
cell and metric; what belongs to each lives in a file of its own, found by
its name:

* a configuration: ``bench/configs/<config>.json``;
* a traffic mix: ``bench/traffic/<traffic>.json``, read by the driver its
  ``loop`` names (``bench/traffic/<loop>_loop.py``);
* a metric, end-to-end or per-layer: ``bench/metrics/<metric>.py``, whose
  ``read(run)`` returns the metric's value or None when the run holds
  nothing to read;
* the pieces a configuration or a traffic mix names, each a module with a
  ``make`` of its own (:func:`component`): a graph generator
  (``bench/data/graphs/<generator>.py``), a partitioner
  (``bench/data/partitions/<partitioner>.py``), a sampler of read pairs
  (``bench/traffic/pairs/<sampler>.py``), an arrival process
  (``bench/traffic/arrivals/<process>.py``) and a delta shape
  (``bench/traffic/deltas/<shape>.py``).

Adding a configuration, a cell or a metric therefore takes new files and
new entries in ``BENCHMARK.json``, and no edit of a file that is here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, List

BENCH = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads``, with its configuration, traffic and
    the metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path = BENCH

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(root: Path, name: str, bench_dir: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; its configuration and
    traffic from ``bench_dir``.  Raises ``KeyError`` for an unknown cell."""
    spec = load_benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    config = load_json(bench_dir / "configs" / f"{w['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in spec["end_to_end"] if _reported_in(m, name)],
                [m for m in spec["per_layer"] if _reported_in(m, name)],
                Path(bench_dir))


def _load_module(path: Path, name: str):
    """The module in the file ``path``, loaded once a process under
    ``name``."""
    name = name.replace(".", "_").replace("-", "_")
    mod = sys.modules.get(name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def component(kind: str, name: str, bench_dir: Path = BENCH):
    """The module ``bench_dir/<kind>/<name>.py``, such as
    ``component("data/graphs", "erdos_renyi")``.  Raises ``KeyError`` for
    a name that has no file."""
    path = Path(bench_dir) / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} named {name!r} (looked for {path})")
    return _load_module(path, f"bench_{kind.replace('/', '_')}_{name}")


def reader(metric: str, bench_dir: Path = BENCH) -> Callable:
    """The ``read(run)`` of metric ``metric``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    return _load_module(path, f"bench_metric_{metric}").read


def driver(loop: str, bench_dir: Path = BENCH):
    """The traffic driver module of loop ``loop`` (``open``, ``closed``,
    ``backlog``): its ``prepare(system, traffic, seed, seconds)`` makes the
    window's inputs before it opens, its ``drive(system, plan, seconds)``
    sends them."""
    return _load_module(bench_dir / "traffic" / f"{loop}_loop.py",
                        f"bench_loop_{loop}")
