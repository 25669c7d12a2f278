"""Gradient compression for the data-parallel all-reduce.

Int8 quantization with error feedback: each step the gradient is
quantized per leaf with a single f32 scale, and the quantization error
is added back into the next step's gradient, so the accumulated update
stays unbiased.  ``compress_decompress`` applies the arithmetic without a
process group, so one process exercises the error dynamics;
``compressed_all_reduce`` is the ``torch.distributed`` form.  Both are
bit-equal to the reference's (``repro.train.compression``) on identical
inputs (``torch.round`` rounds half to even, as ``jnp.round`` does).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from ..tree import flatten, leaves, tree_map, unflatten


def _quantize_leaf(g, err):
    g32 = g.float() + err
    scale = torch.clamp_min(g32.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    new_err = g32 - deq
    return q, scale, deq, new_err


def init_error(params) -> Any:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)


def compress_decompress(grads, err) -> Tuple[Any, Any]:
    """Returns (dequantized grads, new error feedback state)."""
    paths, flat_g = flatten(grads)
    outs = [_quantize_leaf(g, e) for g, e in zip(flat_g, leaves(err))]
    deq = unflatten(paths, [o[2] for o in outs])
    new_err = unflatten(paths, [o[3] for o in outs])
    return deq, new_err


def compressed_all_reduce(g, err, group=None):
    """Quantize ``g`` (plus the carried error ``err``) to int8 with one
    scale, and sum every rank's dequantized payload over ``group`` (the
    default group when ``None``), as the reference's ``compressed_psum``
    sums ``q * scale``.  Returns (the sum, the new error)."""
    _, _, local_deq, new_err = _quantize_leaf(g, err)
    total = local_deq.clone()
    dist.all_reduce(total, group=group)
    return total, new_err
