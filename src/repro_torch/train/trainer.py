"""Fault-tolerant training loop.

  * checkpoint/restart: periodic (async) checkpoints via
    :class:`~repro_torch.ckpt.CheckpointManager`; ``run`` recovers from a
    step-level failure by restoring the last checkpoint and replaying the
    data stream (the loader is step-indexed, so recovery is bitwise, given
    deterministic kernels: on the card that takes
    ``torch.use_deterministic_algorithms(True)`` and
    ``CUBLAS_WORKSPACE_CONFIG``, which the caller sets);
  * gradient accumulation over microbatches;
  * optional int8 gradient compression with error feedback;
  * straggler watermark: steps slower than ``straggler_factor`` x EMA are
    counted and surfaced via metrics.

A step builds the new state from new tensors and swaps it in only when
it is complete, so a step that raises leaves the state as it was (the
reference's immutable arrays give this for free).  :func:`reshard`
places a tree onto a DeviceMesh (elastic re-meshing).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..ckpt import CheckpointManager
from ..core.session import _resolve_device
from ..optim import adamw
from torch.distributed.tensor import distribute_tensor

from ..launch.constraints import placements
from ..tree import flatten, keystr, tree_map, tree_map_with_path, unflatten
from . import compression


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_ckpt"))
    ckpt_every: int = 50
    ckpt_async: bool = True
    keep_ckpts: int = 3
    grad_accum: int = 1
    compress_grads: bool = False
    straggler_factor: float = 3.0
    max_restarts: int = 2


def _value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``; grads have ``params``'
    structure and dtypes."""
    paths, flat = flatten(params)
    flat = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = loss_fn(unflatten(paths, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(paths, grads)


class Trainer:
    def __init__(self, cfg: TrainerConfig, opt_cfg: adamw.AdamWConfig,
                 loss_fn: Callable, params: Any, device=None):
        """loss_fn(params, batch) -> scalar loss.  The state lives on
        ``device`` (``None``: the CUDA device, raising
        :class:`~repro_torch.errors.NoCudaDevice` without one); the
        parameters are moved there."""
        self.device = _resolve_device(device)
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.loss_fn = loss_fn
        params = tree_map(lambda x: x.to(self.device), params)
        self.state = dict(params=params, opt=adamw.init(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.device))
        if cfg.compress_grads:
            self.state["err"] = compression.init_error(params)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts,
                                      device=self.device)
        self._ema = None
        self.straggler_events = 0

    # -- one step ----------------------------------------------------------------
    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One training step on ``batch`` (with ``grad_accum > 1``, every
        leaf carries the microbatch axis first).  The new state is built
        from new tensors and replaces ``self.state`` only once complete.
        Returns the step's metrics (loss, grad_norm, lr) as tensors,
        without waiting for the device."""
        state = self.state
        params = state["params"]
        accum = self.cfg.grad_accum
        if accum > 1:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            grads = tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=x.device), params)
            for i in range(accum):
                mb = tree_map(lambda x: x[i], batch)
                l, g = _value_and_grad(self.loss_fn, params, mb)
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / accum
            grads = tree_map(lambda g: g / accum, grads)
        else:
            loss, grads = _value_and_grad(self.loss_fn, params, batch)
        new_state = dict(state)
        if self.cfg.compress_grads:
            grads, new_state["err"] = compression.compress_decompress(
                grads, state["err"])
        params, opt, metrics = adamw.update(self.opt_cfg, grads,
                                            state["opt"], params)
        new_state.update(params=params, opt=opt, step=state["step"] + 1)
        metrics["loss"] = loss
        self.state = new_state
        return metrics

    # -- fault-tolerant outer loop ----------------------------------------------
    def run(self, data_fn: Callable[[int], Any], n_steps: int,
            fail_hook: Optional[Callable[[int], None]] = None
            ) -> Dict[str, float]:
        """data_fn(step) -> batch (deterministic, replayable).
        fail_hook (tests): may raise at a given step to simulate a node
        failure; the loop restores and replays."""
        restarts = 0
        metrics: Dict[str, float] = {}
        while int(self.state["step"]) < n_steps:
            step = int(self.state["step"])
            try:
                if fail_hook is not None:
                    fail_hook(step)
                t0 = time.perf_counter()
                m = self.step(data_fn(step))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t0
                self._track_straggler(dt)
                metrics = {k: float(v) for k, v in m.items()}
                new_step = step + 1
                if new_step % self.cfg.ckpt_every == 0 or new_step == n_steps:
                    self.ckpt.save(new_step, self.state,
                                   blocking=not self.cfg.ckpt_async)
            except Exception:
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                self.restore()
        self.ckpt.wait()
        metrics["restarts"] = restarts
        metrics["straggler_events"] = self.straggler_events
        return metrics

    def restore(self) -> None:
        self.ckpt.wait()
        last = self.ckpt.latest_step()
        if last is not None:
            tree = self.ckpt.restore(last)
            tree["opt"] = adamw.AdamWState(**tree["opt"])
            self.state = tree

    def _track_straggler(self, dt: float) -> None:
        if self._ema is None:
            self._ema = dt
        else:
            if dt > self.cfg.straggler_factor * self._ema:
                self.straggler_events += 1
            self._ema = 0.9 * self._ema + 0.1 * dt


def reshard(tree: Any, mesh, pspec_fn: Callable[[str, Any], Any]) -> Any:
    """Elastic scaling: ``tree`` placed onto ``mesh`` (a DeviceMesh), each
    leaf as a DTensor with the placements of ``pspec_fn(path, leaf)``, a
    :class:`~repro_torch.launch.constraints.P` (``path`` as
    ``jax.tree_util.keystr`` renders it).  Every rank of the mesh calls
    it; rank 0's values are the ones placed."""
    def place(path, leaf):
        spec = pspec_fn(keystr(path), leaf)
        return distribute_tensor(leaf, mesh, placements(spec, mesh))

    return tree_map_with_path(place, tree)
