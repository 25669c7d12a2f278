"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference takes nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from bench.harness import FORBIDDEN, forbidden_modules
from bench.tests.tiny import ROOT

BENCH = ROOT / "bench"


def _top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = _top_level_imports(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        got = _top_level_imports(path)
        assert "repro_torch" not in got and "benchmarks" not in got, path


def test_nothing_reads_the_older_benchmarks_folder():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        assert "benchmarks" not in _top_level_imports(path), path
        assert "benchmarks/" not in path.read_text(), path


def test_forbidden_names_are_compared_whole():
    code = ("import sys; sys.path[:0] = [{src!r}, {root!r}]; "
            "import repro_torch; from bench.harness import forbidden_modules;"
            " print(forbidden_modules())").format(src=str(ROOT / "src"),
                                                   root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"
    assert isinstance(forbidden_modules(), list)
