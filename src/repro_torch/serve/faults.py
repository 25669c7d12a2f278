"""Deterministic fault injection for the serving stack.

A :class:`FaultInjector` is threaded through ``repro_torch.connect(fr,
chaos=...)`` / ``QueryServer(fr, chaos=...)`` and consulted at four
injection points, the *sites*, that bracket every external effect of the
engines:

=====================  =====================================================
site                   guards
=====================  =====================================================
``upload``             host-to-device transfer of the fragment arrays for a
                       sharded batch (``distributed._batch_sharded_program``)
``engine.shard_map``   a one-collective sharded batch, before it runs
``engine.vmap``        a one-device cached batch, before it runs; also the
                       degraded route of a failed sharded batch
``delta.repair``       the cache repair after ``fr.apply_delta`` mutated the
                       host arrays, so a failure there exercises a genuine
                       mid-update rollback (or the drop of an MVCC clone)
=====================  =====================================================

Failures are **deterministic and seedable**: each site draws from its own
numpy PCG64 stream seeded by ``(seed, site index)``, so a chaos schedule
replays draw for draw however the sites interleave, and the same seed
gives the reference package's schedule.  Per-site :class:`FaultSpec`\\ s
give a failure ``rate`` and an optional ``max_failures`` budget (after
which the site heals: the way to test that retries succeed).  ``poison``
pairs model a query that is broken in itself: any engine batch that holds
one raises a ``permanent`` :class:`~repro_torch.errors.InjectedFault`
every time, which drives the server's bisect-to-dead-letter path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np

from ..errors import InjectedFault

#: every injection point the package consults, in stream-seed order
SITES = ("delta.repair", "engine.shard_map", "engine.vmap", "upload")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Failure behaviour of one site: fail each draw with probability
    ``rate``; after ``max_failures`` injected failures the site heals
    (None: never heals)."""

    rate: float = 0.0
    max_failures: Optional[int] = None

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate}")


class FaultInjector:
    """Deterministic, seedable chaos schedule over the injection SITES.

    ``rates`` maps site name -> ``FaultSpec`` (or a bare float rate);
    ``poison`` is an iterable of (s, t) query pairs that permanently fail
    any engine batch holding them.  The counters ``draws`` / ``failures``
    (site -> int) let tests assert that the schedule fired.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, Union[float, FaultSpec]]] = None,
                 poison: Iterable[Tuple[int, int]] = ()):
        specs: Dict[str, FaultSpec] = {}
        for site, spec in (rates or {}).items():
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}; expected "
                                 f"one of {SITES}")
            if not isinstance(spec, FaultSpec):
                spec = FaultSpec(rate=float(spec))
            specs[site] = spec
        self.seed = int(seed)
        self.specs = specs
        self.poison = {(int(s), int(t)) for s, t in poison}
        # one independent PCG64 stream per site: the schedule at a site
        # never depends on how often the other sites were consulted
        self._rng = {site: np.random.default_rng([self.seed, i])
                     for i, site in enumerate(SITES)}
        self.draws: Dict[str, int] = {site: 0 for site in SITES}
        self.failures: Dict[str, int] = {site: 0 for site in SITES}

    def maybe_fail(self, site: str, pairs=None) -> None:
        """Consult the schedule at ``site``; raise
        :class:`~repro_torch.errors.InjectedFault` when it fires.

        ``pairs`` (engine sites only) is the [N, 2] (s, t) batch about to
        run: if it holds a poison pair the fault is ``permanent``, and
        retries keep failing until bisection isolates the poison request.
        """
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; expected one "
                             f"of {SITES}")
        self.draws[site] += 1
        if pairs is not None and self.poison:
            for s, t in np.asarray(pairs).reshape(-1, 2):
                if (int(s), int(t)) in self.poison:
                    self.failures[site] += 1
                    raise InjectedFault(site, permanent=True,
                                        detail=f"poison pair "
                                               f"({int(s)}, {int(t)})")
        spec = self.specs.get(site)
        if spec is None or spec.rate <= 0.0:
            return
        if (spec.max_failures is not None
                and self.failures[site] >= spec.max_failures):
            return                      # budget spent: the site has healed
        if self._rng[site].random() < spec.rate:
            self.failures[site] += 1
            raise InjectedFault(
                site, detail=f"transient #{self.failures[site]} "
                             f"(seed {self.seed})")
