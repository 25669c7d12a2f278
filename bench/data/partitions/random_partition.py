"""random_partition: each node in a fragment drawn uniformly out of
``n_fragments`` (a frozen copy of ``repro_torch.graph.random_partition``'s
draw)."""
import numpy as np


def make(config: dict, src, dst, gen: np.random.Generator) -> np.ndarray:
    """The int32 fragment of each of the ``n_nodes`` nodes."""
    return gen.integers(0, config["n_fragments"],
                        size=config["n_nodes"]).astype(np.int32)
