"""GNN substrate: padded COO graphs and segment-op message passing.

Message passing is an edge-index gather followed by a scatter onto the
receivers: ``index_add`` for sums, ``scatter_reduce(..., "amax")`` for
maxima.  The reference builds the same layer from ``jax.ops.segment_sum``
and ``segment_max``, and this module keeps their conventions: the
maximum of an empty segment is ``-inf``, and the mean of
:func:`segment_mp` divides by the count of *every* edge that points at a
node, pad edges included.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from ...core.session import _resolve_device
from ...launch.collective_stats import departure


@dataclasses.dataclass
class GraphData:
    """Static-shape padded (batched) graph.

    Padding convention: pad edges point at node slot n_node-1 with
    edge_mask False; pad nodes have node_mask False.  Index tensors are
    int64, the dtype ``scatter_reduce`` takes.
    """
    senders: Any      # [E] int64
    receivers: Any    # [E] int64
    node_mask: Any    # [N] bool
    edge_mask: Any    # [E] bool
    graph_ids: Any    # [N] int64 (disjoint-union batching; 0 if single)
    n_graphs: int = 1


def segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``x`` summed into ``n`` segments by ``ids``."""
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add(0, ids, x)


def segment_max(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``x`` maximised into ``n`` segments by ``ids``; an empty
    segment is ``-inf``, as ``jax.ops.segment_max`` gives.

    DTensor has no sharding rule for ``scatter_reduce``: DTensor operands
    are gathered whole (an explicit, counted all-gather), the maximum is
    taken on each rank's full copy, and the result is a replicated
    DTensor.  GSPMD would keep the operands sharded here: the gathers are
    a departure, labelled ``segment_max``."""
    if isinstance(x, DTensor) or isinstance(ids, DTensor):
        mesh = (x if isinstance(x, DTensor) else ids).device_mesh
        whole = [Replicate()] * mesh.ndim
        out = segment_max(*(departure("segment_max", lambda t=t: (
            t.redistribute(mesh, whole))).to_local()
            if isinstance(t, DTensor) else t for t in (x, ids)), n)
        return DTensor.from_local(out, mesh, whole, run_check=False)
    idx = ids.reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    out = x.new_full((n,) + tuple(x.shape[1:]), -math.inf)
    return out.scatter_reduce(0, idx, x, "amax", include_self=False)


def segment_mp(messages, receivers, n_nodes: int, reduce: str = "sum"):
    """Aggregate edge messages onto receiver nodes."""
    if reduce == "sum":
        return segment_sum(messages, receivers, n_nodes)
    if reduce == "max":
        return segment_max(messages, receivers, n_nodes)
    if reduce == "mean":
        s = segment_sum(messages, receivers, n_nodes)
        c = segment_sum(messages.new_ones(messages.shape[0],
                                          dtype=torch.float32),
                        receivers, n_nodes)
        return s / torch.clamp(c, min=1.0)[:, None]
    raise ValueError(reduce)


def edge_softmax(scores, receivers, edge_mask, n_nodes: int):
    """Numerically-stable softmax over incoming edges of each node.
    scores [E, H] -> alpha [E, H]."""
    scores = torch.where(edge_mask[:, None], scores, -math.inf)
    smax = segment_max(scores, receivers, n_nodes)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    ex = torch.exp(scores - smax[receivers]) * edge_mask[:, None]
    denom = segment_sum(ex, receivers, n_nodes)
    return ex / torch.clamp(denom[receivers], min=1e-9)


def mlp_init(generator: torch.Generator, sizes, dtype, device):
    """Dense layers ``sizes[i] -> sizes[i+1]``: normal weights scaled by
    1/sqrt(fan-in), zero biases, as the reference draws them."""
    return [dict(w=(torch.randn((a, b), generator=generator, device=device)
                    / np.sqrt(a)).to(dtype),
                 b=torch.zeros((b,), dtype=dtype, device=device))
            for a, b in zip(sizes[:-1], sizes[1:])]


def silu(x):
    return x * torch.sigmoid(x)          # jax.nn.silu's two roundings


def mlp_apply(layers, x, act=silu, final_act=False):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def graph_readout(node_vals, graph_ids, n_graphs: int, node_mask,
                  reduce: str = "sum"):
    """Pool node values per graph (molecule batching)."""
    vals = node_vals * node_mask[:, None]
    if reduce == "sum":
        return segment_sum(vals, graph_ids, n_graphs)
    if reduce == "mean":
        s = segment_sum(vals, graph_ids, n_graphs)
        c = segment_sum(node_mask.to(torch.float32), graph_ids, n_graphs)
        return s / torch.clamp(c, min=1.0)[:, None]
    raise ValueError(reduce)


def pad_graph(senders, receivers, n_nodes: int, e_max: int, n_max: int,
              graph_ids: Optional[np.ndarray] = None, n_graphs: int = 1,
              device=None) -> GraphData:
    """Host-side padding to static shapes, then one copy to ``device``
    (``None``: the CUDA device, raising
    :class:`~repro_torch.errors.NoCudaDevice` without one)."""
    dev = _resolve_device(device)
    E = len(senders)
    if E > e_max or n_nodes > n_max:
        raise ValueError(f"graph of {n_nodes} nodes and {E} edges does not "
                         f"fit the padding ({n_max}, {e_max})")
    s = np.full(e_max, n_max - 1, np.int64)
    r = np.full(e_max, n_max - 1, np.int64)
    s[:E], r[:E] = senders, receivers
    node_mask = np.zeros(n_max, bool)
    node_mask[:n_nodes] = True
    edge_mask = np.zeros(e_max, bool)
    edge_mask[:E] = True
    gi = np.zeros(n_max, np.int64)
    if graph_ids is not None:
        gi[:n_nodes] = graph_ids
    return GraphData(*(torch.from_numpy(a).to(dev)
                       for a in (s, r, node_mask, edge_mask, gi)), n_graphs)


def forces_of(energy_fn, coords):
    """(total energy, forces): ``energy_fn(coords)`` summed, and minus its
    gradient by ``coords``.  With grad mode on, the forces keep their graph
    (``create_graph``), so a loss on them differentiates again (to the
    parameters, or to ``coords`` where they require grad); with it off,
    both come back detached.  Not under ``torch.inference_mode``, whose
    tensors autograd cannot record."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        c = coords if create and coords.requires_grad else \
            coords.detach().requires_grad_(True)
        e = energy_fn(c).sum()
        (de,) = torch.autograd.grad(e, c, create_graph=create)
    if not create:
        e = e.detach()
    return e, -de
