"""uniform: a read's source and target each drawn uniformly over all
nodes (the paper's random query pairs)."""
import numpy as np


def make(n: int, count: int, spec: dict, gen: np.random.Generator):
    """``[count, 2]`` int64 ``(s, t)`` pairs."""
    return gen.integers(0, n, size=(count, 2))
