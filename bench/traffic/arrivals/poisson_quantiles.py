"""poisson_quantiles: Poisson-like arrivals in a fixed set of gaps, the
exponential distribution's quantiles at ``(i + 1/2) / count``, in an order
drawn from the seed and scaled so that they fill the window: every seed
sends the same gaps in another order."""
import numpy as np


def make(count: int, seconds: float, spec: dict,
         gen: np.random.Generator) -> np.ndarray:
    """``count`` increasing offsets in ``[0, seconds)``, the first at 0."""
    if count == 0:
        return np.zeros(0)
    q = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-q)
    gen.shuffle(gaps)
    starts = np.cumsum(gaps) - gaps
    return starts * (seconds / gaps.sum())
