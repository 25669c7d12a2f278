"""The live-graph cell, ``cached.reads_deltas``, cut to the CPU: the cell
as ``BENCHMARK.json`` holds it (its own configuration,
``er32k_k16_live``), a sound run that proves correct and gives the cell's
per-layer readings, and two faults planted on the repair lane that the
comparison must catch."""
from __future__ import annotations

import pytest

from bench import harness, spec
from bench.tests.tiny import ROOT, shrink

CELL = "cached.reads_deltas"
READERS = ("deltas.reads_per_s", "deltas.commit_ms_p50", "repair.ms_p50")


def _cell():
    return shrink(spec.load_cell(ROOT, CELL))


def _run(plant=None, trace=False, seed=2 ** 31 + 29):
    return harness.run_cell(_cell(), seed, 2.0, trace, "cpu", plant=plant)


@pytest.fixture(scope="module")
def sound():
    return _run(trace=True)


def test_the_cell_runs_its_own_configuration():
    c = spec.load_cell(ROOT, CELL)
    assert c.config["name"] == "er32k_k16_live" and c.chips == 1
    cached = spec.load_json(spec.BENCH / "configs" / "er32k_k16_cached.json")
    for key in ("generator", "n_nodes", "n_edges", "n_labels", "partitioner",
                "n_fragments", "graph_seed", "cache", "server", "reserves"):
        assert c.config[key] == cached[key], key
    assert c.traffic["deltas"]["rate_per_s"] == 10
    assert {m["name"] for m in c.per_layer} == set(READERS) | {
        "device.idle_share.deltas"}
    assert {m["name"] for m in c.end_to_end} == {"device_peak_gib",
                                                 "setup_s"}


def test_sound_run_is_correct_and_reads_every_layer(sound):
    run, result = sound
    assert result["correct"], result["checks"]
    assert run.deltas and all(d.ok and d.mode == "repair"
                              for d in run.warm_deltas + run.deltas)
    for name in READERS:
        assert result["metrics"][name]["value"] > 0, name
    # no device trace on the CPU: the idle share has nothing to read
    assert "device.idle_share.deltas" not in result["metrics"]
    assert spec.reader("device.idle_share.deltas")(run) is None
    # the probe times the window's repairs, not the warm-up's
    assert len(run.layers.repair_ms) == len(run.deltas)


def _repair_skipped(monkeypatch):
    """The repair returns without repairing the closures: the delta is
    applied to the fragments and the version moves on, the closures stay
    as they were."""
    from repro_torch.core import incremental

    def plant(session, server):
        monkeypatch.setattr(incremental, "_repair_insert",
                            lambda cache, dirty: 0)
    return plant


def _stamp_behind(session, server):
    """Every answer stamped with the version before the one that
    answered it."""
    run = session.run

    def behind(queries, *args, **kw):
        out = run(queries, *args, **kw)
        for r in out:
            if r.cache_version is not None:
                r.cache_version -= 1
        return out
    session.run = behind


def test_a_repair_that_does_not_repair_is_not_correct(monkeypatch):
    _, result = _run(_repair_skipped(monkeypatch))
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] > 0


def test_a_stamp_one_version_behind_is_not_correct():
    _, result = _run(_stamp_behind)
    assert not result["correct"]
    assert result["checks"]["stale_reads"]["value"] > 0
