"""The GNN family's record: an architecture's kind and its full-size and
smoke configurations, and the four shapes with their padded sizes.  The
reference's cell programs (train steps with their losses, lowered for its
dry run) are not part of the port yet.

Shapes (the reference's tasks):
  * full_graph_sm / ogb_products: node-level prediction on one big graph;
  * minibatch_lg: the same on a fanout-sampled block (15-10), loss on the
    seeds;
  * molecule: per-graph energy (+ forces for the equivariant nets) on a
    disjoint union of 128 small graphs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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


@dataclasses.dataclass(frozen=True)
class GNNArch:
    arch_id: str
    kind: str                       # "gat" | "egnn" | "nequip" | "mace"
    full_cfg_fn: Callable           # (d_feat) -> model config
    smoke_cfg_fn: Callable
    family: str = "gnn"
