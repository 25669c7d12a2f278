"""AdamW + global-norm clipping + warmup-cosine schedule, on trees
(:mod:`repro_torch.tree`: dicts and lists) of tensors.

The arithmetic is the reference's (``repro.optim.adamw``): moments are
f32, the update is computed in f32 and cast back to the parameter's
dtype.  ``torch.optim.AdamW`` is not used: it rounds differently and, on
bf16 parameters, keeps the update in bf16.  :func:`update` is functional:
it returns new tensors and changes none of its arguments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..tree import flatten, leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree, max_norm):
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(n, 1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), n


def init(params) -> AdamWState:
    def zeros(t):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), t)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(params), v=zeros(params))


def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    def upd(g, m, v, p):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * \
            p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    paths, flat_g = flatten(grads)
    out = [upd(g, m, v, p) for g, m, v, p in
           zip(flat_g, leaves(state.m), leaves(state.v), leaves(params))]
    new_p = unflatten(paths, [o[0] for o in out])
    new_m = unflatten(paths, [o[1] for o in out])
    new_v = unflatten(paths, [o[2] for o in out])
    metrics = dict(grad_norm=gnorm, lr=lr)
    return new_p, AdamWState(step, new_m, new_v), metrics
