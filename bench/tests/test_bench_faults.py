"""The comparison that decides ``correct`` catches each fault the cells
can have, planted in the timed path of a run at a small size on the CPU
(the run skips its look for a card and is otherwise whole), and each
control: the plain reference with a guarantee broken."""
from __future__ import annotations

import dataclasses

import pytest

from bench import correctness, harness
from bench.tests.tiny import cell

CELLS = ["cached.reads", "oneshot.reach_dist", "cached.reads_deltas",
         "oneshot.rpq"]

#: the cells whose caller sends one query a call
ONE_A_CALL = ("oneshot.reach_dist", "oneshot.rpq")


def _altered(session, server):
    """Every fifth answer of a batch altered where it is produced."""
    run = session.run

    def altered(queries, *args, **kw):
        out = run(queries, *args, **kw)
        for r in out[::5]:
            if r.distance is not None and not r.answer is False:
                r.distance += 1
            r.answer = not r.answer
        return out
    session.run = altered


def _half_left_out(session, server):
    """Only the first half of a batch computed; the rest handed the
    answers of the half that was."""
    run = session.run

    def half(queries, *args, **kw):
        qs = list(queries) if isinstance(queries, (list, tuple)) else [queries]
        k = max(1, len(qs) // 2)
        done = run(qs[:k], *args, **kw)
        return [done[i] if i < k else dataclasses.replace(done[i % k])
                for i in range(len(qs))]
    session.run = half


def _state_unchanged(monkeypatch):
    """A fixpoint step that returns its state unchanged (for a regular
    path query, the product localEval's step moves no state)."""
    import torch
    from repro_torch.core import engine

    def plant(session, server):
        monkeypatch.setattr(engine, "_advance",
                            lambda cur, trans_f: torch.zeros(
                                (*cur.shape[:-1], trans_f.shape[1]),
                                dtype=torch.bool, device=cur.device))
        monkeypatch.setattr(engine, "_propagate_bool",
                            lambda esrc, edst, frontier: frontier.clone())
        monkeypatch.setattr(engine, "_propagate_dist",
                            lambda esrc, edst, dist, cap=engine.INF:
                            dist.clone())
    return plant


def _run(name, plant=None, seed=11):
    return harness.run_cell(cell(name), seed, 2.0, False, "cpu",
                            plant=plant)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    _, result = _run(name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


# the faults each cell can have: a one-shot cell's caller sends one query
# a call, so it has no batch to leave half of out; one card has no
# exchange between cards to leave out
FAULTS = [(name, fault) for name in CELLS
          for fault in ("altered", "half_left_out", "state_unchanged")
          if not (name in ONE_A_CALL and fault == "half_left_out")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    plant = {"altered": _altered, "half_left_out": _half_left_out,
             "state_unchanged": _state_unchanged(monkeypatch)}[fault]
    _, result = _run(name, plant)
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_controls_are_not_correct(name, seed):
    """Each control, put in the program's place, is judged by the same
    comparison as the program and comes out not correct."""
    run, result = _run(name, seed=seed)
    assert result["correct"]
    for which in ["depth_cap"] + (["stale"] if run.deltas else []):
        checks = correctness.judge(correctness.controlled(run, "cpu", which),
                                   "cpu")
        assert not correctness.correct(checks), which
        assert checks["wrong_answers"]["value"] > 0, which
