"""repro_torch.analysis: the static guarantee verifier and the
concurrency lint of the port, retargeted from the reference package's
``repro.analysis`` to torch.distributed.

Three passes machine-check the paper's theorems and the repo's own
invariants:

* :mod:`.wire_check` — run the sharded programs (the three fused batch
  programs, the one-shot disReach, the cache update) under a record of
  their collectives and verify exactly one collective per program
  (Theorem 1's one visit per site), none inside a fixpoint loop, payload
  bits == ``Fragmentation.traffic_bits`` (``traffic_bits_update`` for the
  update) and no ``|V|``/``|E|``-sized dimension on the wire (Theorem 2),
  under the reference's rule ids HLO001-HLO004.
* :mod:`.lint` — AST lint for the bug classes the codebase hit, in their
  torch form (RPR001 host-buffer aliasing, RPR002 host syncs under a
  lock, RPR003 unseeded randomness / wall-clock on serving paths, RPR004
  unbounded serving containers, RPR005 mutable state in cached
  factories).
* :mod:`.locks` — static lock-acquisition-graph extraction checked
  against the declared partial order, plus a runtime-instrumented mode
  used by the serve and MVCC tests.

Run everything: ``python -m repro_torch.analysis --all [--out
report.json]``.
"""
from .lint import RULES, lint_paths, lint_source
from .locks import (LOCK_ORDER, InstrumentedLock, LockMonitor,
                    check_lock_order, extract_acquisition_graph, monitored)
from .report import Violation, dump_report, make_report
from .wire_check import (CollectiveOp, ProgramModel, TensorType,
                         check_program, model_of, verify_fragmentation,
                         verify_session, verify_store)

__all__ = [
    "CollectiveOp", "ProgramModel", "TensorType", "model_of",
    "check_program", "verify_fragmentation", "verify_session",
    "verify_store", "RULES", "lint_source", "lint_paths", "LOCK_ORDER",
    "check_lock_order", "extract_acquisition_graph", "LockMonitor",
    "InstrumentedLock", "monitored", "Violation", "make_report",
    "dump_report",
]
