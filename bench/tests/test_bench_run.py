"""``bench/run.py`` as the check runs it: no result without a card, none
in a checkout that holds only the benchmark, and on the card a whole run
that proves correct."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from bench.tests.tiny import ROOT

ARGS = ["--workload", "cached.reads", "--seed", str(2 ** 31 + 5),
        "--seconds", "2", "--trace", "0"]


def _has_card() -> bool:
    import torch
    return torch.cuda.is_available()


def _run(cwd, timeout=600):
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    if _has_card():
        pytest.skip("this machine has a card: the run would measure")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    if not _has_card():
        pytest.skip("needs a CUDA device")
    p = _run(ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"device_peak_gib",
                                      "setup_s"}
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
