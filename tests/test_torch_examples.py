"""The five examples of the PyTorch/CUDA package (``examples/*_torch.py``)
run as a user runs them, with ``--device cpu``, each in its own process.

Each must exit 0 (each asserts what its reference asserts).  Where the
reference example prints answers (the two query examples), the port's
are compared with the reference's on the same seeds, the reference run
under ``JAX_PLATFORMS=cpu`` (its 8 fake XLA devices in its own process,
as tests/test_guarantees.py's subprocesses run them; the port's sharded
example runs 8 gloo ranks).  The LM and GNN examples draw their weights
from a ``torch.Generator``, not ``jax.random``, so their printed numbers
differ from the reference's; their shape is checked.
"""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _run(script, *args, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        script), *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, (script, proc.stderr[-3000:])
    return proc.stdout


def test_quickstart_prints_the_reference_answers():
    port = _run("quickstart_torch.py", "--device", "cpu")
    ref = _run("quickstart.py")
    assert "q_rr(Ann, Mark, DB*)     -> False" in port
    assert port == ref


def _answers(text):
    """The lines that carry answers and wire sizes, timings dropped and
    the reference's "device" read as the port's "rank"."""
    keep = []
    for line in text.splitlines():
        if "us/query" in line:
            continue
        keep.append(line.replace("device", "rank"))
    return keep


def test_distributed_queries_print_the_reference_answers():
    port = _run("distributed_queries_torch.py", "--device", "cpu")
    ref = _run("distributed_queries.py")
    assert _answers(port) == _answers(ref)
    assert sum(line.startswith("q_r(") for line in port.splitlines()) == 5
    assert "over 8 ranks: 3 fused groups" in port
    assert "32 fragments on 8 ranks (4/rank)" in port


def test_gnn_forces_trains():
    out = _run("gnn_forces_torch.py", "--device", "cpu")
    lines = out.splitlines()
    assert [line.split()[0] for line in lines] == ["egnn", "mace"]
    for line in lines:
        before, after = map(float, re.search(
            r"held-out ([\d.]+) -> ([\d.]+)", line).groups())
        assert after < before


def test_serve_lm_decodes_every_request():
    out = _run("serve_lm_torch.py", "--device", "cpu")
    reqs = [line for line in out.splitlines() if line.startswith("req")]
    assert len(reqs) == 6
    for line in reqs:
        assert len(line.split("->")[1].strip(" []").split(",")) == 12
    assert "ring KV cache: 64 slots (window=64), int8" in out


def test_train_lm_recovers_from_a_crash(tmp_path):
    out = _run("train_lm_torch.py", "--device", "cpu", "--steps", "20",
               "--seq", "64", "--crash-at", "10",
               "--ckpt-dir", str(tmp_path / "ckpt"))
    assert "simulated node failure at step 10" in out
    done = re.search(r"done: steps=(\d+) final_loss=([\d.]+) restarts=(\d+)",
                     out)
    assert done and done.group(1) == "20" and done.group(3) == "1"
    first = float(re.search(r"step    0  eval_loss=([\d.]+)", out).group(1))
    assert float(done.group(2)) < first


@pytest.mark.parametrize("script", [
    "quickstart_torch.py", "distributed_queries_torch.py",
    "gnn_forces_torch.py", "serve_lm_torch.py", "train_lm_torch.py"])
def test_example_imports_no_jax(script):
    """An example is meant for the card, which has no JAX: it imports
    ``repro_torch`` and never ``jax`` or ``repro``."""
    src = open(os.path.join(ROOT, "examples", script)).read()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert "repro_torch" in {m.split(".")[0] for m in imports}
    assert not {m.split(".")[0] for m in imports} & {"jax", "repro"}
