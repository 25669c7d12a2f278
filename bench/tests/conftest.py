"""The benchmark's own tests, on the CPU: ``python -m pytest bench/tests``
from the root of the checkout (the repository's test run does not collect
them).  Under ``-n`` each worker takes its share of the cores, so that the
tiny cells' timed windows are not starved by the others' threads."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))
