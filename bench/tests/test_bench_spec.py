"""BENCHMARK.json and every file it names keep to the benchmark's
contract, and a new configuration, cell or metric is found by name."""
from __future__ import annotations

import json
import re
import shutil

import numpy as np

import pytest

from bench import harness, spec
from bench.tests.tiny import ROOT, shrink

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/")
    assert len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_end_to_end_bounds_and_sources(bench):
    names = [m["name"] for m in bench["end_to_end"]]
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_enough(bench):
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for cell in cells:
        c = spec.load_cell(ROOT, cell)
        got = {m["name"] for m in c.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in got, (cell, m["name"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(cells)


@pytest.mark.parametrize("cell,kinds", [
    ("oneshot.reach_dist", {"reach", "dist", "bounded"}),
    ("oneshot.rpq", {"rpq"})])
def test_one_shot_cells_load_with_their_metrics(cell, kinds):
    """Both one-shot cells report the caller's tail and rate, and read the
    one-shot engine's two stages and the card's idle share."""
    c = spec.load_cell(ROOT, cell)
    assert c.config["cache"] == "none" and c.traffic["loop"] == "closed"
    assert {k for k, v in c.traffic["mix"]["shares"].items() if v} == kinds
    assert {m["name"] for m in c.end_to_end} == {
        "query_p95_ms", "queries_per_s", "device_peak_gib", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "oneshot.local_ms_p50", "oneshot.evaldg_ms_p50",
        "device.idle_share.oneshot"}


def test_every_named_file_exists_and_parses(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("bench/")
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        for key in c["reduced"]:
            assert key in data and key in data["reduced"]
    for w in bench["workloads"]:
        json.loads((ROOT / "bench" / "traffic" / f"{w['traffic']}.json")
                   .read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path, bench):
    """Add a configuration, a traffic mix, a metric and a cell as files and
    entries only: the harness finds each by its name."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "bench"
    cfg = json.loads((b / "configs" / "er32k_k16_cached.json").read_text())
    cfg["name"] = "er4k_k8_cached"
    (b / "configs" / "er4k_k8_cached.json").write_text(json.dumps(cfg))
    (b / "traffic" / "reads_slow.json").write_text(json.dumps(
        {"loop": "open", "read_rate_per_s": 10,
         "mix": {"shares": {"reach": 1}, "bound": 0}}))
    (b / "metrics" / "read_count.py").write_text(
        "def read(run):\n    return len(run.reads)\n")
    new = dict(bench)
    new["configs"] = bench["configs"] + [dict(
        bench["configs"][0], name="er4k_k8_cached",
        file="bench/configs/er4k_k8_cached.json")]
    new["workloads"] = bench["workloads"] + [dict(
        name="cached.slow", config="er4k_k8_cached", traffic="reads_slow",
        chips=1, why="a later cell")]
    new["per_layer"] = bench["per_layer"] + [dict(
        name="read_count", unit="reads", better="higher",
        source="program_counter", layer="serve", moves="device_peak_gib",
        workloads=["cached.slow"])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = spec.load_cell(tmp_path, "cached.slow", bench_dir=b)
    assert cell.config["name"] == "er4k_k8_cached"
    assert cell.traffic["read_rate_per_s"] == 10
    assert [m["name"] for m in cell.per_layer] == ["read_count"]
    assert spec.reader("read_count", bench_dir=b)(
        type("R", (), {"reads": [1, 2, 3]})()) == 3
    assert spec.driver("open", bench_dir=b).drive


# a generator, a partitioner, a pair sampler, an arrival process and a
# delta shape that the benchmark does not have, each a file of its own
NEW_FILES = {
    "data/graphs/ring_and_chords.py": """
import numpy as np

def make(config, gen):
    n, m = config["n_nodes"], config["n_edges"]
    ring = np.arange(n, dtype=np.int64)
    src = np.concatenate([ring, gen.integers(0, n, m - n)])
    dst = np.concatenate([(ring + 1) % n, gen.integers(0, n, m - n)])
    return src, dst, gen.integers(0, config["n_labels"], n).astype(np.int32)
""",
    "data/partitions/blocks.py": """
import numpy as np

def make(config, src, dst, gen):
    n, k = config["n_nodes"], config["n_fragments"]
    return (np.arange(n) * k // n).astype(np.int32)
""",
    "traffic/pairs/hot_sources.py": """
import numpy as np

def make(n, count, spec, gen):
    s = gen.integers(0, spec["hot"], count)
    return np.stack([s, gen.integers(0, n, count)], axis=1)
""",
    "traffic/arrivals/even.py": """
import numpy as np

def make(count, seconds, spec, gen):
    return np.arange(count) * (seconds / max(count, 1))
""",
    "traffic/deltas/drop_one.py": """
from bench.data.generate import Delta

def make(ctx, spec, gen):
    src, dst = ctx.edges()
    i = int(gen.integers(len(src)))
    return Delta("drop_one", [], [(int(src[i]), int(dst[i]))])
""",
}


def test_new_generators_and_arrivals_are_found_as_files(tmp_path, bench):
    """A cell whose graph generator, partitioner, pair sampler, arrival
    process and delta shape are new files runs whole, on the CPU at a small
    size, with no edit of a file that is there, and proves correct."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "bench"
    for rel, text in NEW_FILES.items():
        (b / rel).write_text(text.lstrip())
    cfg = json.loads((b / "configs" / "er32k_k16_cached.json").read_text())
    cfg.update(name="ring_cached", generator="ring_and_chords",
               partitioner="blocks")
    (b / "configs" / "ring_cached.json").write_text(json.dumps(cfg))
    (b / "traffic" / "hot_even_drops.json").write_text(json.dumps(
        {"loop": "open", "read_rate_per_s": 100,
         "mix": {"shares": {"reach": 1, "dist": 1}, "bound": 0},
         "pairs": {"sampler": "hot_sources", "hot": 4},
         "arrivals": {"process": "even"},
         "deltas": {"rate_per_s": 2, "arrivals": {"process": "even"},
                    "shapes": {"drop_one": 1}}}))
    new = dict(bench)
    new["configs"] = bench["configs"] + [dict(
        bench["configs"][0], name="ring_cached",
        file="bench/configs/ring_cached.json")]
    new["workloads"] = bench["workloads"] + [dict(
        name="ring.drops", config="ring_cached", traffic="hot_even_drops",
        chips=1, why="a later cell")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = shrink(spec.load_cell(tmp_path, "ring.drops", bench_dir=b))
    run, result = harness.run_cell(cell, 5, 2.0, False, "cpu")
    assert result["correct"], result["checks"]
    assert {r.read.s for r in run.reads} <= set(range(4))
    assert [d.delta.shape for d in run.deltas] == ["drop_one"] * 6
    assert all(d.ok for d in run.deltas)
    gaps = np.diff([r.due for r in run.reads])
    np.testing.assert_allclose(gaps, gaps[0], rtol=1e-3, atol=1e-4)
    assert len(run.graph.src) == cell.config["n_edges"]
