"""Cost-based admission control for the query server.

Estimate a query's cost before running it, from fragmentation statistics
alone, route it to a lane, and reject pathological ones with a typed
:class:`~repro_torch.errors.QueryTooExpensive` that carries the estimate.

The estimate counts **semiring operations** of the cached per-query phase,
per query::

    side = n_boundary * states            # boundary-system side
    cost = w * (largest_fragment * states + side^2)
           [+ side^2 * log2(side)  if the product closure must be built]

* ``largest_fragment * states``: the local stage; the paper's
  response-time bound says evaluation is limited by the largest |F_i|
  (times the automaton for RPQs);
* ``side^2``: the per-query compose through the (product) closure;
* ``w = 2`` for dist/bounded: int32 min-plus arithmetic, no bit packing;
* the ``log2`` term charges an RPQ for the closure's repeated squaring
  when its automaton's product closure is not cached yet, the dominant
  first-query cost (so the same regex can be RED cold and GREEN warm).

Lanes: **GREEN** (cheap, low latency), **YELLOW** (expensive but admitted,
served after the green lane so cheap queries never queue behind heavy
ones), **RED** (rejected at submit).  The numbers are the reference
package's, so both route the same query to the same lane.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..core.fragments import Fragmentation
from ..errors import QueryTooExpensive

GREEN = "green"
YELLOW = "yellow"
RED = "red"
LANES = (GREEN, YELLOW, RED)


def estimate_cost(fr: Fragmentation, kind: str, states: int = 1,
                  closure_cached: bool = True) -> float:
    """Per-query cost estimate in semiring ops (see the module docstring).
    A pure function of fragmentation statistics: it touches no device."""
    states = max(int(states), 1)
    side = max(fr.n_boundary, 1) * states
    weight = 2.0 if kind in ("dist", "bounded") else 1.0
    cost = weight * (fr.largest_fragment() * states + side * side)
    if not closure_cached:
        cost += side * side * max(math.log2(side), 1.0)
    return cost


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Lane thresholds over :func:`estimate_cost` values.

    ``green_max``: costs above it route to the YELLOW lane (None: every
    admitted query is GREEN).  ``red_max``: costs above it are rejected
    with :class:`~repro_torch.errors.QueryTooExpensive` (None: never
    reject, the safe default)."""

    green_max: Optional[float] = None
    red_max: Optional[float] = None

    def __post_init__(self):
        if (self.green_max is not None and self.red_max is not None
                and self.red_max < self.green_max):
            raise ValueError(f"red_max ({self.red_max}) must be >= "
                             f"green_max ({self.green_max})")

    def lane(self, cost: float) -> str:
        if self.red_max is not None and cost > self.red_max:
            return RED
        if self.green_max is not None and cost > self.green_max:
            return YELLOW
        return GREEN

    def admit(self, kind: str, cost: float) -> str:
        """Lane for ``cost``; raises on RED."""
        lane = self.lane(cost)
        if lane == RED:
            raise QueryTooExpensive(kind, cost, self.red_max)
        return lane

    @classmethod
    def for_fragmentation(cls, fr: Fragmentation,
                          green_factor: float = 8.0,
                          red_max: Optional[float] = None,
                          ) -> "AdmissionPolicy":
        """Default policy: the green lane holds queries within
        ``green_factor`` x the cheapest (reach) cost, plain reach/dist and
        small cached RPQs, while big-automaton and cold-closure RPQs go
        YELLOW.  Rejection stays off unless ``red_max`` is given."""
        return cls(green_max=green_factor * estimate_cost(fr, "reach"),
                   red_max=red_max)
