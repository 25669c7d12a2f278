"""Lock-order checker for the port's threaded serving + MVCC stack,
retargeted from the reference package's ``repro.analysis.locks`` (same
rule ids).

The declared partial order (outer first: a thread holding lock *i* may
only acquire locks strictly later in the list) is the reference's six
serving locks, then the port's module-level locks:

    engine._serve_mutex  ->  engine._mutex  ->  store._repair_lock
        ->  session._lock  ->  store._lock  ->  telemetry._lock
        ->  _build._lock  ->  bool_matmul._count_lock
        ->  tropical_matmul._count_lock  ->  bitpack_ops._count_lock
        ->  distributed._count_lock

``engine._work`` and ``engine._repair_cond`` are Conditions built over
``engine._mutex`` and alias it.  ``session._lock``, ``engine._mutex`` and
``_build._lock`` are RLocks (reentrant acquisition of the same lock is
legal); everything else is a plain Lock, so a same-name edge on those is
a self-deadlock.

The module-level locks are leaves: ``kernels/_build.py``'s ``_lock``
(held while a kernel library is built and loaded, under whatever the
caller holds: a session runs kernels under its lock) and the counters'
``_count_lock`` of the three kernel wrappers (``kernels/*/ops.py``) and
of ``core/distributed.py`` (one read-modify-write each).  No lock is
taken while one of them is held, so they sit after every other lock, and
any acquisition under them is an inversion.

Two modes:

* **static** (:func:`check_lock_order`): extract the acquisition graph
  from the AST of the lock-bearing modules — ``with`` nesting plus one
  level of receiver-resolved cross-module calls
  (``self.session.run(...)``, ``self.telemetry.record(...)``) and calls
  between a module's own functions, with held-set propagation to a
  fixpoint — and reject any edge against the declared order
  (**LCK001**), a same-name edge on a non-reentrant lock (**LCK002**), or
  an undeclared lock (**LCK003**).
* **runtime** (:func:`monitored` / :class:`LockMonitor`): wrap the real
  locks with per-thread acquisition-stack recording, so that dynamic
  inversions static analysis cannot see are caught by the serve and MVCC
  tests.
"""
from __future__ import annotations

import ast
import contextlib
import os
import threading
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .report import Violation

LOCK_ORDER = (
    "engine._serve_mutex",
    "engine._mutex",
    "store._repair_lock",
    "session._lock",
    "store._lock",
    "telemetry._lock",
    # leaves: module-level locks under which no lock is taken
    "_build._lock",
    "bool_matmul._count_lock",
    "tropical_matmul._count_lock",
    "bitpack_ops._count_lock",
    "distributed._count_lock",
)
RANK = {name: i for i, name in enumerate(LOCK_ORDER)}
REENTRANT = frozenset({"session._lock", "engine._mutex", "_build._lock"})

# which module plays which role (path under src/repro_torch -> role prefix)
DEFAULT_ROLES = {
    os.path.join("serve", "engine.py"): "engine",
    os.path.join("core", "session.py"): "session",
    os.path.join("core", "versions.py"): "store",
    os.path.join("serve", "telemetry.py"): "telemetry",
    os.path.join("kernels", "_build.py"): "_build",
    os.path.join("kernels", "bool_matmul", "ops.py"): "bool_matmul",
    os.path.join("kernels", "tropical_matmul", "ops.py"): "tropical_matmul",
    os.path.join("kernels", "bitpack_ops", "ops.py"): "bitpack_ops",
    os.path.join("core", "distributed.py"): "distributed",
}
# the roles whose locks are module globals (``with _count_lock:``), and
# the module each lives in (what the runtime monitor patches)
MODULE_LOCKS = {
    "_build._lock": "repro_torch.kernels._build",
    "bool_matmul._count_lock": "repro_torch.kernels.bool_matmul.ops",
    "tropical_matmul._count_lock": "repro_torch.kernels.tropical_matmul.ops",
    "bitpack_ops._count_lock": "repro_torch.kernels.bitpack_ops.ops",
    "distributed._count_lock": "repro_torch.core.distributed",
}
# attribute names that resolve a cross-object call receiver to a role
_RECEIVERS = {"session": "session", "store": "store", "_store": "store",
              "telemetry": "telemetry", "engine": "engine",
              "_engine": "engine"}


def _chain(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _lock_name(chain: Optional[str], role: str) -> Optional[str]:
    if not chain:
        return None
    parts = chain.split(".")
    if len(parts) == 1 and parts[0].endswith(("_lock", "_mutex")):
        return f"{role}.{parts[0]}"          # a module-level lock
    if parts[0] != "self":
        return None
    if len(parts) == 3 and parts[1] in _RECEIVERS and parts[2] == "_lock":
        return f"{_RECEIVERS[parts[1]]}._lock"
    if len(parts) != 2:
        return None
    attr = parts[1]
    if role == "engine":
        if attr in ("_mutex", "_work", "_repair_cond"):
            return "engine._mutex"          # Conditions alias the mutex
        if attr == "_serve_mutex":
            return "engine._serve_mutex"
    elif role == "store":
        if attr == "_lock":
            return "store._lock"
        if attr == "_repair_lock":
            return "store._repair_lock"
    elif role in ("session", "telemetry") and attr == "_lock":
        return f"{role}._lock"
    if attr.endswith(("_lock", "_mutex")):
        return f"{role}.{attr}"             # undeclared -> LCK003
    return None


def _resolve_call(chain: Optional[str], role: str
                  ) -> Optional[Tuple[str, str]]:
    if not chain:
        return None
    parts = chain.split(".")
    if len(parts) == 1:
        return (role, parts[0])              # a function of the same module
    if parts[0] != "self":
        return None
    if len(parts) == 2:
        return (role, parts[1])
    if len(parts) == 3 and parts[1] in _RECEIVERS:
        return (_RECEIVERS[parts[1]], parts[2])
    if len(parts) == 4 and parts[1] in _RECEIVERS and parts[2] == "session":
        return ("session", parts[3])
    return None


class _MethodSummary:
    def __init__(self):
        # (locks already held within this method, lock acquired)
        self.acquires: List[Tuple[FrozenSet[str], str]] = []
        # (locks held within this method at the call site, callee)
        self.calls: List[Tuple[FrozenSet[str], Tuple[str, str]]] = []


def _summarize_method(fn: ast.AST, role: str) -> _MethodSummary:
    s = _MethodSummary()

    def walk(node: ast.AST, held: FrozenSet[str]):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                lock = _lock_name(_chain(item.context_expr), role)
                if lock is None and isinstance(item.context_expr, ast.Call):
                    lock = _lock_name(_chain(item.context_expr.func), role)
                    lock = lock if lock and _chain(
                        item.context_expr.func).endswith(".acquire") else None
                if lock:
                    s.acquires.append((inner, lock))
                    inner = inner | {lock}
            for sub in node.body:
                walk(sub, inner)
            return
        if isinstance(node, ast.Call):
            callee = _resolve_call(_chain(node.func), role)
            if callee:
                s.calls.append((held, callee))
        for sub in ast.iter_child_nodes(node):
            # nested defs run later, under unknown locks — skip them
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                continue
            walk(sub, held)

    for stmt in fn.body:
        walk(stmt, frozenset())
    return s


def extract_acquisition_graph(files: Dict[str, str]
                              ) -> Set[Tuple[str, str]]:
    """``files``: path -> role.  Returns the set of (held, acquired)
    edges reachable through one-level receiver-resolved calls, to a
    fixpoint over entry hold-sets."""
    methods: Dict[Tuple[str, str], _MethodSummary] = {}
    fns = (ast.FunctionDef, ast.AsyncFunctionDef)
    for path, role in files.items():
        with open(path) as f:
            tree = ast.parse(f.read())
        for fn in tree.body:                 # module-level functions
            if isinstance(fn, fns):
                methods[(role, fn.name)] = _summarize_method(fn, role)
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for fn in cls.body:
                if isinstance(fn, fns):
                    methods[(role, fn.name)] = _summarize_method(fn, role)

    entry: Dict[Tuple[str, str], Set[str]] = {m: set() for m in methods}
    changed = True
    while changed:
        changed = False
        for m, summ in methods.items():
            for held_local, callee in summ.calls:
                if callee not in entry:
                    continue
                add = set(held_local) | entry[m]
                if not add <= entry[callee]:
                    entry[callee] |= add
                    changed = True

    edges: Set[Tuple[str, str]] = set()
    for m, summ in methods.items():
        for held_local, lock in summ.acquires:
            for h in set(held_local) | entry[m]:
                edges.add((h, lock))
    return edges


def check_edges(edges: Set[Tuple[str, str]]) -> List[Violation]:
    vs: List[Violation] = []
    for a, b in sorted(edges):
        if a not in RANK or b not in RANK:
            missing = a if a not in RANK else b
            vs.append(Violation(
                "LCK003", f"undeclared lock {missing} in acquisition "
                f"edge {a} -> {b}; add it to LOCK_ORDER",
                where=f"{a} -> {b}"))
            continue
        if a == b:
            if a not in REENTRANT:
                vs.append(Violation(
                    "LCK002", f"{a} re-acquired while held but is not "
                    "reentrant — self-deadlock", where=f"{a} -> {b}"))
            continue
        if RANK[a] >= RANK[b]:
            vs.append(Violation(
                "LCK001", f"acquisition edge {a} -> {b} inverts the "
                f"declared order (rank {RANK[a]} -> {RANK[b]})",
                where=f"{a} -> {b}"))
    return vs


def default_files(root: str) -> Dict[str, str]:
    base = os.path.join(root, "src", "repro_torch") if os.path.isdir(
        os.path.join(root, "src", "repro_torch")) else root
    return {os.path.join(base, rel): role
            for rel, role in DEFAULT_ROLES.items()
            if os.path.exists(os.path.join(base, rel))}


def check_lock_order(root: str = ".", files: Optional[Dict[str, str]] = None
                     ) -> Tuple[List[Violation], Set[Tuple[str, str]]]:
    """Static pass: extract the acquisition graph and validate it."""
    files = files if files is not None else default_files(root)
    edges = extract_acquisition_graph(files)
    return check_edges(edges), edges


# --------------------------------------------------------------------------
# Runtime-instrumented mode


class LockMonitor:
    """Per-thread acquisition stacks + order validation at acquire time."""

    def __init__(self, order: Sequence[str] = LOCK_ORDER,
                 reentrant: FrozenSet[str] = REENTRANT):
        self._rank = {name: i for i, name in enumerate(order)}
        self._reentrant = frozenset(reentrant)
        self._tls = threading.local()
        self._mu = threading.Lock()
        self.violations: List[Violation] = []

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_acquire(self, name: str) -> None:
        st = self._stack()
        held = [h for h in st if h != name]
        if name in st and name not in self._reentrant:
            self._record(Violation(
                "LCK002", f"{name} re-acquired while held by the same "
                "thread but is not reentrant", where=" -> ".join(st + [name])))
        rank = self._rank.get(name)
        if rank is None:
            self._record(Violation(
                "LCK003", f"undeclared lock {name} acquired at runtime",
                where=name))
        else:
            for h in held:
                hr = self._rank.get(h)
                if hr is not None and hr >= rank:
                    self._record(Violation(
                        "LCK001", f"runtime inversion: {name} acquired "
                        f"while holding {h}",
                        where=" -> ".join(st + [name])))
        st.append(name)

    def note_release(self, name: str, all_depths: bool = False) -> None:
        st = self._stack()
        while name in st:
            for i in range(len(st) - 1, -1, -1):
                if st[i] == name:
                    del st[i]
                    break
            if not all_depths:
                break

    def _record(self, v: Violation) -> None:
        with self._mu:
            self.violations.append(v)


class InstrumentedLock:
    """Wraps a Lock/RLock, reporting acquisitions to a LockMonitor.

    Implements the private ``Condition`` protocol
    (``_is_owned`` / ``_release_save`` / ``_acquire_restore``) by
    delegation, so ``threading.Condition(InstrumentedLock(RLock()))``
    behaves exactly like a Condition over the raw lock.
    """

    def __init__(self, inner, name: str, monitor: LockMonitor):
        self._inner = inner
        self.name = name
        self._monitor = monitor

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._monitor.note_acquire(self.name)
        return got

    def release(self) -> None:
        self._monitor.note_release(self.name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition protocol -------------------------------------------------

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        # RLock releases ALL recursion levels here
        self._monitor.note_release(self.name, all_depths=True)
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._monitor.note_acquire(self.name)

    def __repr__(self) -> str:
        return f"InstrumentedLock({self.name}, {self._inner!r})"


def instrument_session(session, monitor: LockMonitor) -> None:
    session._lock = InstrumentedLock(session._lock, "session._lock",
                                     monitor)


def instrument_store(store, monitor: LockMonitor) -> None:
    store._lock = InstrumentedLock(store._lock, "store._lock", monitor)
    store._repair_lock = InstrumentedLock(store._repair_lock,
                                          "store._repair_lock", monitor)


def instrument_telemetry(telemetry, monitor: LockMonitor) -> None:
    telemetry._lock = InstrumentedLock(telemetry._lock, "telemetry._lock",
                                       monitor)


def instrument_engine(engine, monitor: LockMonitor) -> None:
    engine._serve_mutex = InstrumentedLock(engine._serve_mutex,
                                           "engine._serve_mutex", monitor)
    engine._mutex = InstrumentedLock(engine._mutex, "engine._mutex",
                                     monitor)
    # the Conditions were built over the raw mutex — rebuild them over the
    # wrapper so waits keep the monitor's held-stack in sync
    engine._work = threading.Condition(engine._mutex)
    engine._repair_cond = threading.Condition(engine._mutex)


@contextlib.contextmanager
def monitored(monitor: Optional[LockMonitor] = None):
    """Patch the four lock-bearing constructors so every instance built
    inside the context runs on instrumented locks, and swap the module-
    level locks (:data:`MODULE_LOCKS`) for instrumented wrappers of
    themselves until the context ends.  Yields the monitor; callers
    assert ``monitor.violations == []`` afterwards."""
    import importlib

    from ..core.session import QuerySession
    from ..core.versions import VersionedCacheStore
    from ..serve.engine import AsyncQueryEngine
    from ..serve.telemetry import Telemetry

    mon = monitor or LockMonitor()
    patches = [
        (QuerySession, instrument_session),
        (VersionedCacheStore, instrument_store),
        (AsyncQueryEngine, instrument_engine),
        (Telemetry, instrument_telemetry),
    ]
    originals = []
    for cls, hook in patches:
        orig = cls.__init__

        def wrapped(self, *a, _orig=orig, _hook=hook, **kw):
            _orig(self, *a, **kw)
            _hook(self, mon)

        originals.append((cls, orig))
        cls.__init__ = wrapped
    swapped = []
    for name, module in MODULE_LOCKS.items():
        mod = importlib.import_module(module)
        attr = name.split(".", 1)[1]
        raw = getattr(mod, attr)
        swapped.append((mod, attr, raw))
        setattr(mod, attr, InstrumentedLock(raw, name, mon))
    try:
        yield mon
    finally:
        for cls, orig in originals:
            cls.__init__ = orig
        for mod, attr, raw in swapped:
            setattr(mod, attr, raw)
