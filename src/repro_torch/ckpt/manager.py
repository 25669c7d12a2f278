"""Checkpoint manager: atomic versioned saves, latest-pointer restore, GC.

Fault-tolerance contract (used by :class:`repro_torch.train.Trainer`):
  * ``save`` writes to a temp dir then renames it into place, so a crash
    mid-save never corrupts the latest checkpoint;
  * the ``LATEST`` pointer is written (atomically) only after the payload
    rename, so restore always sees a complete checkpoint;
  * ``restore`` rebuilds the tree from its key paths (``tree.json``) and
    leaves (``leaves.npz``); namedtuples come back as dicts;
  * ``gc`` keeps the newest ``keep`` checkpoints.
Async mode hands a host copy of the tree to a background thread, at most
one write in flight.  The host copy is complete before ``save`` returns,
so the caller may update its tensors in place at once.

Checkpoints live in ``step_%010d/`` directories; bf16 leaves are stored
as their 16-bit patterns.  They are not meant to be read by the JAX
package.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..core.session import _resolve_device
from ..tree import flatten, unflatten


def _to_host(x) -> np.ndarray:
    t = torch.as_tensor(x).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


class CheckpointManager:
    """Checkpoints under ``directory``; ``restore`` puts the tensors on
    ``device`` (``None``: the CUDA device, raising
    :class:`~repro_torch.errors.NoCudaDevice` without one)."""

    def __init__(self, directory: str, keep: int = 3, device=None):
        self.dir = directory
        self.keep = keep
        self.device = _resolve_device(device)
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _latest_file(self) -> str:
        return os.path.join(self.dir, "LATEST")

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        paths, leaves = flatten(tree)
        dtypes = [str(torch.as_tensor(x).dtype) for x in leaves]
        host = (paths, dtypes, [_to_host(x) for x in leaves])  # copied now
        if blocking:
            self._write(step, host)
        else:
            self.wait()                               # one in flight max
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host) -> None:
        paths, dtypes, arrays = host
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "leaves.npz"),
                 **{f"leaf_{i:05d}": a for i, a in enumerate(arrays)})
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump({"paths": [list(p) for p in paths],
                       "dtypes": dtypes}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # atomic latest-pointer update
        ptr_tmp = self._latest_file() + ".tmp"
        with open(ptr_tmp, "w") as f:
            f.write(str(step))
        os.replace(ptr_tmp, self._latest_file())
        self.gc()

    # -- restore ---------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        try:
            with open(self._latest_file()) as f:
                return int(f.read().strip())
        except FileNotFoundError:
            return None

    def restore(self, step: Optional[int] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "tree.json")) as f:
            spec = json.load(f)
        leaves = []
        with np.load(os.path.join(d, "leaves.npz")) as data:
            for i, dtype in enumerate(spec["dtypes"]):
                t = torch.from_numpy(data[f"leaf_{i:05d}"])
                if dtype == str(torch.bfloat16):
                    t = t.view(torch.bfloat16)
                leaves.append(t.to(self.device))
        return unflatten(spec["paths"], leaves)

    # -- gc ----------------------------------------------------------------------
    def gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
