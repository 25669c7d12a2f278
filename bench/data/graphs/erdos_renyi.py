"""erdos_renyi: ``n_edges`` directed edges with both ends uniform over
``n_nodes`` nodes, and a label drawn uniformly out of ``n_labels`` for
each node (the paper's Sec. 7 synthetic graphs; a frozen copy of
``repro_torch.graph.erdos_renyi``'s draws)."""
import numpy as np


def make(config: dict, gen: np.random.Generator):
    """``(src, dst, labels)``: int64 edge ends and int32 node labels."""
    n, m = config["n_nodes"], config["n_edges"]
    src = gen.integers(0, n, size=m, dtype=np.int64)
    dst = gen.integers(0, n, size=m, dtype=np.int64)
    labels = gen.integers(0, config["n_labels"], size=n).astype(np.int32)
    return src, dst, labels
