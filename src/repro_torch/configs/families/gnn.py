"""GNN-family adapter: full-batch / sampled-minibatch / large-full-batch /
batched-molecule cell programs for the four GNN architectures.

Tasks per shape (the reference's):
  * full_graph_sm / ogb_products: node-level prediction (classification
    for GAT, scalar regression for the equivariant nets) on one big graph;
  * minibatch_lg: the same on a fanout-sampled block (15-10), loss on the
    seeds;
  * molecule: per-graph energy (+ forces for the equivariant nets) on a
    disjoint union of 128 small graphs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ...launch.constraints import P, replicated
from ...models.gnn import common, egnn, equivariant, gat
from ...tree import leaves, tree_map
from .base import (CellProgram, dp, make_train_step, opt_state_like, sds,
                   spec_tree)

GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def _pad(x: int, mult: int = 512) -> int:
    return ((x + mult - 1) // mult) * mult


# (n_nodes, n_edges, d_feat, loss-node count) per shape, full scale
FULL_DIMS = dict(
    full_graph_sm=dict(N=_pad(2_708), E=_pad(10_556), d=1_433, seeds=2_708,
                       n_graphs=1),
    minibatch_lg=dict(N=_pad(1_024 + 15_360 + 153_600), E=_pad(168_960),
                      d=602, seeds=1_024, n_graphs=1),
    ogb_products=dict(N=_pad(2_449_029), E=_pad(61_859_140), d=100,
                      seeds=2_449_029, n_graphs=1),
    molecule=dict(N=_pad(30 * 128), E=_pad(64 * 128), d=16,
                  seeds=30 * 128, n_graphs=128),
)
REDUCED_DIMS = dict(
    full_graph_sm=dict(N=64, E=128, d=12, seeds=48, n_graphs=1),
    minibatch_lg=dict(N=64, E=128, d=12, seeds=16, n_graphs=1),
    ogb_products=dict(N=128, E=256, d=12, seeds=96, n_graphs=1),
    molecule=dict(N=64, E=128, d=8, seeds=64, n_graphs=8),
)


def model_flops(kind: str, cfg, N: int, E: int, d_feat: int) -> float:
    """A GNN cell's analytic useful FLOPs (forward + backward) on a graph
    of ``N`` nodes and ``E`` edges with ``d_feat`` input features."""
    if kind == "gat":
        return 3.0 * (4.0 * E * cfg.d_hidden * cfg.n_heads
                      + 2.0 * N * d_feat * cfg.d_hidden * cfg.n_heads)
    C = cfg.d_hidden if kind == "egnn" else cfg.channels
    return 3.0 * 2.0 * E * C * C * 15        # paths x channels


def _n_params(tree) -> int:
    return sum(math.prod(x.shape) for x in leaves(tree))


@dataclasses.dataclass(frozen=True)
class GNNArch:
    arch_id: str
    kind: str                       # "gat" | "egnn" | "nequip" | "mace"
    full_cfg_fn: Callable           # (d_feat) -> model config
    smoke_cfg_fn: Callable
    family: str = "gnn"

    def shape_ids(self):
        return list(GNN_SHAPES)

    def skip_reason(self, shape_id: str) -> Optional[str]:
        return None

    # ------------------------------------------------------------------
    def build(self, shape_id: str, multipod: bool = False,
              reduced: bool = False, optimized: bool = False) -> CellProgram:
        """optimized: NequIP and MACE aggregate with ``fused_agg`` and the
        mesh hints of ``shard_axes``."""
        dims = (REDUCED_DIMS if reduced else FULL_DIMS)[shape_id]
        N, E, d_feat = dims["N"], dims["E"], dims["d"]
        n_graphs = dims["n_graphs"]
        cfg = (self.smoke_cfg_fn if reduced else self.full_cfg_fn)(d_feat)
        axes = dp(multipod) + ("model",)      # flat device grid for graphs
        if optimized and self.kind in ("nequip", "mace"):
            cfg = dataclasses.replace(cfg, fused_agg=True, shard_axes=axes)
        i32, f32 = torch.int32, torch.float32

        g_abs = dict(senders=sds((E,), i32), receivers=sds((E,), i32),
                     node_mask=sds((N,), torch.bool),
                     edge_mask=sds((E,), torch.bool),
                     graph_ids=sds((N,), i32))
        g_spec = dict(senders=P(axes), receivers=P(axes),
                      node_mask=P(axes), edge_mask=P(axes),
                      graph_ids=P(axes))

        def graph_of(g):
            # the port's GraphData holds int64 indices
            return common.GraphData(g["senders"].long(),
                                    g["receivers"].long(), g["node_mask"],
                                    g["edge_mask"], g["graph_ids"].long(),
                                    n_graphs)

        if self.kind == "gat":
            params_abs = gat.init_params(cfg, None, device="meta")

            if shape_id == "molecule":
                def loss(p, x, g, labels, mask):
                    gd = graph_of(g)
                    logits = gat.forward(cfg, p, x, gd)
                    glog = common.graph_readout(logits, gd.graph_ids,
                                                n_graphs, gd.node_mask,
                                                "mean").float()
                    logz = torch.logsumexp(glog, dim=-1)
                    gold = torch.take_along_dim(
                        glog, labels[:, None].long(), dim=-1)[:, 0]
                    return torch.mean(logz - gold)
                labels_abs = sds((n_graphs,), i32)
                mask_abs = sds((n_graphs,), f32)
                lspec, mspec = P(), P()
            else:
                def loss(p, x, g, labels, mask):
                    return gat.loss(cfg, p, x, graph_of(g), labels, mask)
                labels_abs = sds((N,), i32)
                mask_abs = sds((N,), f32)
                lspec, mspec = P(axes), P(axes)

            x_abs = sds((N, d_feat), f32)
            x_spec = P(axes, None)
        else:
            params_abs = _eq_init(self.kind, cfg, None, "meta")

            if self.kind == "egnn":
                def model_energy(p, x, coords, g):
                    e, _, _ = egnn.forward(cfg, p, x, coords, graph_of(g))
                    return e
                x_abs = sds((N, d_feat), f32)
                x_spec = P(axes, None)
            else:
                def model_energy(p, species, coords, g):
                    return equivariant.forward(cfg, p, species, coords,
                                               graph_of(g))
                x_abs = sds((N,), i32)                # species ids
                x_spec = P(axes)

            if shape_id == "molecule":
                def loss(p, x, coords, g, e_tgt, f_tgt):
                    # the forces keep their graph: the loss
                    # differentiates them again
                    _, f = common.forces_of(
                        lambda c: model_energy(p, x, c, g), coords)
                    e_all = model_energy(p, x, coords, g)
                    return torch.mean((e_all - e_tgt) ** 2) + \
                        0.1 * torch.mean((f - f_tgt) ** 2)
                extra_abs = (sds((n_graphs,), f32), sds((N, 3), f32))
                extra_spec = (P(), P(axes, None))
            else:
                def loss(p, x, coords, g, y_tgt, y_mask):
                    e = model_energy(p, x, coords, g)       # [n_graphs]
                    return torch.mean((e - y_tgt) ** 2)
                extra_abs = (sds((n_graphs,), f32), sds((n_graphs,), f32))
                extra_spec = (P(), P())

            coords_abs = sds((N, 3), f32)
            coords_spec = P(axes, None)

        n_params = _n_params(params_abs)
        loss = _whole_batch(loss)
        step = make_train_step(loss, accum=False)
        m, v, st = opt_state_like(params_abs)
        pspec = spec_tree(params_abs, lambda path, leaf: P())

        if self.kind == "gat":
            args = (params_abs, m, v, st, x_abs, g_abs, labels_abs, mask_abs)
            specs = (pspec, pspec, pspec, P(), x_spec, g_spec, lspec, mspec)
        else:
            args = (params_abs, m, v, st, x_abs, coords_abs, g_abs) + extra_abs
            specs = (pspec, pspec, pspec, P(), x_spec, coords_spec,
                     g_spec) + extra_spec
        return CellProgram(self.arch_id, shape_id, "train", step, args,
                           specs, model_flops(self.kind, cfg, N, E, d_feat),
                           4.0 * 10.0 * n_params + 8.0 * E,
                           loss_fn=loss)


def _whole_batch(loss):
    """``loss`` with every DTensor of its batch gathered whole on every
    rank (a departure from GSPMD, labelled ``graph_whole``): the graph
    then runs replicated.  DTensor's indexing rules do not hold a graph
    sharded over the device grid: torch 2.11 has none for a dim sharded
    over two mesh dims, and over one its scatter-adds meet index and
    source sharded unlike.  Plain tensors pass through."""
    def whole_batch(p, *batch):
        return loss(p, *tree_map(lambda x: replicated(x, "graph_whole"),
                                 batch))
    return whole_batch


def _eq_init(kind, cfg, generator, device):
    if kind == "egnn":
        return egnn.init_params(cfg, generator, device=device)
    return equivariant.init_params(cfg, generator, device=device)
