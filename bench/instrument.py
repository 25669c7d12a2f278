"""The layer probes of a traced run: wrappers the harness puts around the
program's calls at each layer boundary, timing them on the host and
recording the host spans that label the device's idle gaps.

* ``session.run`` on the session a server or caller holds: the session +
  cache layer's time a batch, and each batch's reach and distance counts
  (the row counts ``M`` of its two compose products);
* ``session.repair_on`` on the server's session: a delta's repair on the
  MVCC path, with a synchronize at its end;
* ``engine.local_eval_*``, ``engine.regular_rvset`` and
  ``engine.evaldg_*``: the one-shot engine's two stages (a regular path
  query's local stage is ``regular_rvset``, its product localEval over
  every fragment), the first with a synchronize at its end (the second
  returns a host value).

Each wrapper is an attribute set on the session object or the engine
module, and :meth:`Probes.remove` takes it away again.
"""
from __future__ import annotations

import time
import types
from typing import Callable, List, Tuple

from .record import Layers
from .trace import Spans


class Probes:
    def __init__(self, sync: Callable[[], None], clock=time.monotonic):
        self.layers = Layers()
        self.spans = Spans()
        self._sync = sync
        self._clock = clock
        self._undo: List[Tuple[object, str, object]] = []

    def _set(self, obj, name: str, fn) -> None:
        """Shadow a session's method by an instance attribute, or replace a
        module's function; :meth:`remove` undoes either."""
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    def remove(self) -> None:
        for obj, name, old in reversed(self._undo):
            if isinstance(obj, types.ModuleType):
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo.clear()

    def session(self, session) -> None:
        """Time every ``run`` of ``session`` and count its kinds."""
        from repro_torch import Reach
        run, clock = session.run, self._clock
        layers, spans = self.layers, self.spans

        def timed_run(queries, *args, **kw):
            qs = queries if isinstance(queries, (list, tuple)) else [queries]
            reach = sum(isinstance(q, Reach) for q in qs)
            a = clock()
            out = run(queries, *args, **kw)
            b = clock()
            layers.session_ms.append((b - a) * 1e3)
            layers.batch_m.append({"reach": reach, "dist": len(qs) - reach})
            spans.add("session.run", a, b)
            return out
        self._set(session, "run", timed_run)

    def repair(self, session) -> None:
        """Time every ``repair_on`` of ``session`` to its last kernel."""
        repair_on, clock, sync = session.repair_on, self._clock, self._sync
        layers, spans = self.layers, self.spans

        def timed_repair(fr, delta):
            a = clock()
            out = repair_on(fr, delta)
            sync()
            b = clock()
            layers.repair_ms.append((b - a) * 1e3)
            spans.add("repair", a, b)
            return out
        self._set(session, "repair_on", timed_repair)

    def oneshot(self) -> None:
        """Time the one-shot engine's local stage (reach, dist and the
        product one of a regular path query) and evalDG."""
        from repro_torch.core import engine
        clock, sync, layers, spans = (self._clock, self._sync, self.layers,
                                      self.spans)

        def wrap(fn, into: List[float], label: str, synced: bool):
            def timed(*args, **kw):
                a = clock()
                out = fn(*args, **kw)
                if synced:
                    sync()
                b = clock()
                into.append((b - a) * 1e3)
                spans.add(label, a, b)
                return out
            return timed
        for name in ("local_eval_reach", "local_eval_dist", "regular_rvset"):
            self._set(engine, name, wrap(getattr(engine, name),
                                         layers.local_ms, "local_eval", True))
        for name in ("evaldg_reach", "evaldg_dist"):
            self._set(engine, name, wrap(getattr(engine, name),
                                         layers.evaldg_ms, "evaldg", False))
