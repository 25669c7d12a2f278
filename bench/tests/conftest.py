"""The benchmark's own tests, on the CPU: ``python -m pytest bench/tests``
from the root of the checkout (the repository's test run does not collect
them)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
