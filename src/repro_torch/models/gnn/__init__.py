"""The GNN family: padded graphs with segment-op message passing
(:mod:`.common`), GAT, EGNN, NequIP and MACE (:mod:`.equivariant`) on a
small E(3) library (:mod:`.e3`), and the neighbour samplers."""
from .common import GraphData, pad_graph, segment_mp, edge_softmax
from . import common, e3, egnn, equivariant, gat, sampler

__all__ = ["GraphData", "pad_graph", "segment_mp", "edge_softmax",
           "common", "e3", "egnn", "equivariant", "gat", "sampler"]
