"""Cell programs: the unit the dry run reads and the card runs.

A *cell* is one (architecture x input shape) combination.  Each family's
``build`` gives a :class:`CellProgram`: a step function, abstract
arguments (tensors on the ``meta`` device: shapes and dtypes, no
storage) and trees of :class:`~repro_torch.launch.constraints.P` for the
production mesh.  With ``reduced=True`` the same code gives a tiny
configuration that the CPU tests run; :func:`zeros_from_abstract` makes
its arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ...core.session import _resolve_device
from ...optim import adamw
from ...train.trainer import _value_and_grad
from ...tree import flatten, keystr, leaves, tree_map, tree_map_with_path


@dataclasses.dataclass
class CellProgram:
    arch_id: str
    shape_id: str
    kind: str                      # train | prefill | decode | serve | retrieval
    step_fn: Callable              # positional-args step
    abstract_args: Tuple           # trees of meta tensors
    arg_specs: Tuple               # matching trees of P
    model_flops: float             # analytic useful FLOPs (6*N*D style)
    model_bytes: float             # analytic least HBM traffic (params+state)
    notes: str = ""
    # the reference's cost probes lower loop-free variants and multiply by
    # cost_scale (the grad-accumulation factor, the serve_bulk chunk count)
    cost_scale: float = 1.0
    # train cells: the loss that step_fn differentiates,
    # loss_fn(params, *batch) for one (micro)batch
    loss_fn: Optional[Callable] = None


def dp(multipod: bool):
    """Data-parallel mesh dims (pod composes with data across pods)."""
    return ("pod", "data") if multipod else ("data",)


def sds(shape, dtype) -> torch.Tensor:
    """An abstract argument: a meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def abstract_like(tree):
    return tree_map(lambda x: sds(x.shape, x.dtype), tree)


def spec_tree(tree, fn):
    """A tree of P made by ``fn(path_string, leaf)``, the path rendered as
    ``jax.tree_util.keystr`` renders it (``['layers'][3]['wq']``)."""
    return tree_map_with_path(lambda path, leaf: fn(keystr(path), leaf),
                              tree)


def spec_lookup(specs):
    """The ``pspec_fn`` of :func:`repro_torch.train.reshard` that places
    each leaf of a tree by the leaf at the same path of ``specs`` (e.g. a
    cell's ``arg_specs`` for its arguments)."""
    paths, parts = flatten(specs)
    table = {keystr(p): s for p, s in zip(paths, parts)}
    return lambda path, leaf: table[path]


OPT_CFG = adamw.AdamWConfig(lr=1e-4, warmup_steps=200, total_steps=50_000)


def make_train_step(loss_fn, accum: bool):
    """The production train step: ``(params, m, v, step, *batch) ->
    (params, m, v, step, loss)``.  With ``accum`` the leading batch axis
    holds microbatches: the loss and grads of each are summed in f32 and
    divided by their count (the reference's ``lax.scan``), eagerly."""

    def step(params, m, v, stepno, *batch):
        def value_and_grad(*b):
            return _value_and_grad(lambda p, bb: loss_fn(p, *bb), params, b)

        if accum:
            n = leaves(batch)[0].shape[0]
            loss, grads = None, None
            for i in range(n):
                l, g = value_and_grad(*(tree_map(lambda x: x[i], b)
                                        for b in batch))
                g = tree_map(lambda x: x.float(), g)
                loss = l.float() if loss is None else loss + l
                grads = g if grads is None else tree_map(torch.add, grads, g)
            loss = loss / n
            grads = tree_map(lambda x: x / n, grads)
        else:
            loss, grads = value_and_grad(*batch)
        state = adamw.AdamWState(step=stepno, m=m, v=v)
        params, state, _ = adamw.update(OPT_CFG, grads, state, params)
        return params, state.m, state.v, state.step, loss

    return step


def opt_state_like(params_abs):
    def f32(t):
        return tree_map(lambda s: sds(s.shape, torch.float32), t)
    return f32(params_abs), f32(params_abs), sds((), torch.int32)


def zeros_from_abstract(tree, seed: int = 0, device=None):
    """Concrete arguments for ``tree``'s abstract leaves on ``device`` (the
    card unless the caller asks for ``"cpu"``; ``NoCudaDevice`` without
    one): |normal| x 0.05 for floats (non-negative, so optimizer second
    moments stay valid), zeros for ints and bools (always-valid indices).
    The reference's rule, on a ``torch.Generator`` of its own: the values
    are not ``jax.random``'s."""
    device = _resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(s):
        if s.dtype.is_floating_point:
            x = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                            device=device)
            return (x.abs() * 0.05).to(s.dtype)
        return torch.zeros(s.shape, dtype=s.dtype, device=device)

    return tree_map(make, tree)
