"""Repo-specific AST lint: past bug classes as named rules, retargeted
to torch from the reference package's ``repro.analysis.lint`` (same rule
ids, same suppression form).

* **RPR001** ``torch.from_numpy`` / ``torch.as_tensor`` /
  ``torch.asarray`` on (a view of) a mutable host buffer:
  ``Fragmentation.arrays`` entries are mutated in place by
  ``apply_delta``, and these calls share the numpy memory on the CPU
  instead of copying it (use ``torch.tensor``, which always copies).
* **RPR002** lock held across a host sync or transfer (``.to(...)``,
  ``.cuda()``, ``.cpu()``, ``.item()``, ``.tolist()``,
  ``torch.cuda.synchronize()``, ``torch.equal``): it stalls every thread
  queued on the lock for a device round-trip.
* **RPR003** unseeded randomness or direct wall-clock reads on serving
  paths: they break the deterministic fault injection and fake-clock
  scheduler tests.
* **RPR004** unbounded container growth on serving paths: anything a
  long-running server appends to must be windowed or drained.
* **RPR005** mutable state captured by an ``lru_cache``-ed factory:
  cached closures outlive graph versions, so factories must take only
  hashable immutable parameters.

Suppressions are inline and must be justified::

    with self._lock:   # repr: ignore[RPR002] a 4-byte read, measured
        ...

A bare ``# repr: ignore[RPRnnn]`` with no justification is itself a
violation (**RPR000**): zero silent suppressions.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .report import Violation

RULES: Dict[str, str] = {
    "RPR000": "bare `# repr: ignore[...]` without a justification",
    "RPR001": "torch.from_numpy / as_tensor on a (view of a) mutable host "
              "buffer; use torch.tensor (copies)",
    "RPR002": "lock held across a host sync or transfer (.to, .cuda, .cpu, "
              ".item, .tolist, torch.cuda.synchronize, torch.equal)",
    "RPR003": "unseeded np.random / wall-clock read on a serving path",
    "RPR004": "unbounded container growth on a serving path",
    "RPR005": "mutable state captured in an lru_cache-ed factory",
}

_IGNORE_RE = re.compile(
    r"#\s*repr:\s*ignore\[([A-Z0-9,\s]+)\]\s*(.*)")

# methods that return a VIEW of (or taint-preserving handle to) their
# receiver; anything else returns fresh storage
_VIEW_METHODS = {"reshape", "ravel", "transpose", "view", "swapaxes",
                 "squeeze", "items", "values", "get"}
# methods that copy to or from the device, or wait for it
_SYNC_METHODS = {"to", "cuda", "cpu", "item", "tolist"}
# torch functions that wait for the device
_SYNC_CALLS = {"torch.cuda.synchronize", "torch.equal"}
# torch constructors that may share the memory of a numpy argument
_ALIASING_CALLS = {"from_numpy", "as_tensor", "asarray"}
_SEEDED_RANDOM = {"default_rng", "Generator", "SeedSequence", "PCG64",
                  "Philox"}
_CLOCK_CALLS = {"time", "monotonic", "perf_counter"}
_GROW_METHODS = {"append", "appendleft", "add", "extend"}
_SHRINK_METHODS = {"pop", "popleft", "popitem", "clear", "remove",
                   "discard"}
_MUTATE_METHODS = {"append", "extend", "update", "add", "pop", "clear",
                   "setdefault", "__setitem__"}


def _parse_ignores(text: str) -> Tuple[Dict[int, Set[str]],
                                       List[Violation]]:
    """line -> suppressed rules; bare (unjustified) ignores are RPR000."""
    ignores: Dict[int, Set[str]] = {}
    bare: List[Violation] = []
    for i, line in enumerate(text.splitlines(), 1):
        m = _IGNORE_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        ignores[i] = rules
        justification = m.group(2).strip(" -—:\t")
        if len(justification) < 8:
            bare.append(Violation(
                "RPR000",
                f"suppression of {sorted(rules)} has no justification",
                where=f"line {i}"))
    return ignores, bare


def _attr_chain(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


# --------------------------------------------------------------------------
# RPR001: host-buffer aliasing taint


def _fancy_index(idx: ast.AST) -> bool:
    """Advanced (copying) numpy indexing: array-valued or list index.
    A subscript expression as index (``x[owner[rows]]``) is array-valued
    in this codebase; bare names/constants/slices stay basic (views)."""
    if isinstance(idx, (ast.Call, ast.List, ast.ListComp, ast.Subscript)):
        return True
    if isinstance(idx, ast.Tuple):
        return any(_fancy_index(e) for e in idx.elts)
    return False


def _tainted(node: ast.AST, env: Dict[str, bool]) -> bool:
    """Does ``node`` evaluate to (a view of) a ``.arrays`` host buffer?"""
    if isinstance(node, ast.Name):
        return env.get(node.id, False)
    if isinstance(node, ast.Attribute):
        if node.attr == "arrays":
            return True             # the host-buffer dict itself
        if node.attr == "T":
            return _tainted(node.value, env)
        return False
    if isinstance(node, ast.Subscript):
        if not _tainted(node.value, env):
            return False
        return not _fancy_index(node.slice)   # basic indexing == view
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _VIEW_METHODS:
            return _tainted(f.value, env)
        return False                # any other call returns fresh storage
    return False


def _comp_taints(node: ast.AST, env: Dict[str, bool]) -> Dict[str, bool]:
    """Extra taint for comprehension targets iterating ``.arrays``."""
    extra: Dict[str, bool] = {}
    for gen in getattr(node, "generators", []):
        if _tainted(gen.iter, env):
            targets = (gen.target.elts
                       if isinstance(gen.target, ast.Tuple)
                       else [gen.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    extra[t.id] = True
    return extra


class _AliasVisitor(ast.NodeVisitor):
    def __init__(self, env: Dict[str, bool]):
        self.env = dict(env)
        self.hits: List[ast.Call] = []

    def _visit_comp(self, node):
        saved = self.env
        self.env = {**saved, **_comp_taints(node, saved)}
        self.generic_visit(node)
        self.env = saved

    visit_ListComp = visit_SetComp = visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp

    def visit_Call(self, node: ast.Call):
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in _ALIASING_CALLS
                and isinstance(f.value, ast.Name) and f.value.id == "torch"
                and node.args and _tainted(node.args[0], self.env)):
            self.hits.append(node)
        self.generic_visit(node)


def _scope_env(scope: ast.AST) -> Dict[str, bool]:
    """Fixpoint over simple ``name = expr`` bindings in one scope."""
    env: Dict[str, bool] = {}
    assigns = [n for n in ast.walk(scope) if isinstance(n, ast.Assign)]
    for _ in range(4):
        changed = False
        for a in assigns:
            val = _tainted(a.value, env)
            for tgt in a.targets:
                if isinstance(tgt, ast.Name) and env.get(tgt.id) != val:
                    env[tgt.id] = val
                    changed = True
        if not changed:
            break
    return env


def _check_rpr001(tree: ast.AST, path: str) -> List[Violation]:
    out: List[Violation] = []
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    seen: Set[int] = set()
    for scope in scopes:
        v = _AliasVisitor(_scope_env(scope))
        for stmt in (scope.body if isinstance(scope, ast.Module)
                     else scope.body):
            v.visit(stmt)
        for call in v.hits:
            if call.lineno in seen:
                continue
            seen.add(call.lineno)
            out.append(Violation(
                "RPR001",
                f"torch.{call.func.attr} may alias a mutable "
                "Fragmentation.arrays host buffer — use torch.tensor "
                "(copies)",
                where=f"{path}:{call.lineno}"))
    return out


# --------------------------------------------------------------------------
# RPR002: host sync or device transfer under a lock


def _is_lock_ctx(expr: ast.AST) -> bool:
    name = _attr_chain(expr).lower()
    return any(t in name for t in ("lock", "mutex", "cond"))


def _check_rpr002(tree: ast.AST, path: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if not any(_is_lock_ctx(item.context_expr)
                   for item in node.items):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            chain = _attr_chain(sub.func)
            if chain in _SYNC_CALLS:
                name = chain
            elif (isinstance(sub.func, ast.Attribute)
                  and sub.func.attr in _SYNC_METHODS):
                name = f".{sub.func.attr}()"
            else:
                continue
            out.append(Violation(
                "RPR002",
                f"{name} while holding a lock stalls every queued thread "
                "for a device round-trip",
                where=f"{path}:{sub.lineno}",
                context=f"lock taken at line {node.lineno}"))
    return out


# --------------------------------------------------------------------------
# RPR003: nondeterminism on serving paths


def _check_rpr003(tree: ast.AST, path: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if chain in (f"time.{c}" for c in _CLOCK_CALLS):
            out.append(Violation(
                "RPR003",
                f"direct wall-clock read {chain}() on a serving path — "
                "inject a clock so scheduler tests stay deterministic",
                where=f"{path}:{node.lineno}"))
        elif (chain.startswith("np.random.")
              or chain.startswith("numpy.random.")):
            fn = chain.rsplit(".", 1)[1]
            if fn not in _SEEDED_RANDOM:
                out.append(Violation(
                    "RPR003",
                    f"unseeded {chain}() on a serving path — use a "
                    "seeded np.random.default_rng",
                    where=f"{path}:{node.lineno}"))
        elif chain in ("random.random", "random.randint", "random.choice",
                       "random.shuffle", "random.uniform"):
            out.append(Violation(
                "RPR003",
                f"unseeded stdlib {chain}() on a serving path",
                where=f"{path}:{node.lineno}"))
    return out


# --------------------------------------------------------------------------
# RPR004: unbounded growth on serving paths


def _deque_has_maxlen(call: ast.Call) -> bool:
    return (len(call.args) >= 2
            or any(kw.arg == "maxlen" for kw in call.keywords))


def _check_rpr004(tree: ast.AST, path: str, text: str) -> List[Violation]:
    out = []
    candidates: Dict[str, int] = {}     # attr name -> assign line
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"):
            continue
        val = node.value
        unbounded = False
        if isinstance(val, (ast.List, ast.Set)) or (
                isinstance(val, ast.Call)
                and _attr_chain(val.func) in ("set", "list")):
            unbounded = True
        elif (isinstance(val, ast.Call)
              and _attr_chain(val.func) in ("deque", "collections.deque")
              and not _deque_has_maxlen(val)):
            unbounded = True
        if unbounded:
            candidates[tgt.attr] = node.lineno
    for attr, line in candidates.items():
        grows = re.search(
            rf"self\.{re.escape(attr)}\.({'|'.join(_GROW_METHODS)})\(",
            text)
        shrinks = (re.search(
            rf"self\.{re.escape(attr)}\.({'|'.join(_SHRINK_METHODS)})"
            rf"\b|del\s+self\.{re.escape(attr)}\b", text)
            # reassigned somewhere after __init__ == drained wholesale
            or len(re.findall(rf"self\.{re.escape(attr)}\s*=", text)) > 1)
        if grows and not shrinks:
            out.append(Violation(
                "RPR004",
                f"self.{attr} grows (.{grows.group(1)}) but is never "
                "drained/windowed — unbounded on a long-running server",
                where=f"{path}:{line}"))
    return out


# --------------------------------------------------------------------------
# RPR005: mutable capture in lru_cache factories


def _is_lru_cache(dec: ast.AST) -> bool:
    if isinstance(dec, ast.Call):
        dec = dec.func
    return _attr_chain(dec) in ("lru_cache", "functools.lru_cache",
                                "cache", "functools.cache")


def _check_rpr005(tree: ast.AST, path: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not any(_is_lru_cache(d) for d in node.decorator_list):
            continue
        if any(isinstance(d, (ast.List, ast.Dict, ast.Set))
               for d in node.args.defaults):
            out.append(Violation(
                "RPR005",
                f"lru_cache-ed {node.name} has a mutable default arg",
                where=f"{path}:{node.lineno}"))
        params = {a.arg for a in (node.args.args
                                  + node.args.kwonlyargs)} - {"self"}
        for sub in ast.walk(node):
            hit: Optional[str] = None
            if (isinstance(sub, ast.Attribute) and sub.attr == "arrays"
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id in params):
                hit = f"{sub.value.id}.arrays"
            elif (isinstance(sub, ast.Subscript)
                  and isinstance(sub.value, ast.Name)
                  and sub.value.id in params):
                hit = f"{sub.value.id}[...]"
            elif (isinstance(sub, ast.Call)
                  and isinstance(sub.func, ast.Attribute)
                  and sub.func.attr in _MUTATE_METHODS
                  and isinstance(sub.func.value, ast.Name)
                  and sub.func.value.id in params):
                hit = f"{sub.func.value.id}.{sub.func.attr}()"
            if hit:
                out.append(Violation(
                    "RPR005",
                    f"lru_cache-ed {node.name} captures mutable state "
                    f"through parameter use {hit} — cached programs must "
                    "close over hashable immutable params only",
                    where=f"{path}:{sub.lineno}"))
                break
    return out


# --------------------------------------------------------------------------
# entry points

_SERVE_RULES = ("RPR003", "RPR004")


def lint_source(text: str, path: str = "<memory>",
                serve_path: Optional[bool] = None) -> List[Violation]:
    """Lint one Python source.  ``serve_path`` forces/suppresses the
    serving-only rules (default: inferred from the path)."""
    tree = ast.parse(text)
    ignores, bare = _parse_ignores(text)
    if serve_path is None:
        serve_path = f"{os.sep}serve{os.sep}" in path or "/serve/" in path
    found: List[Violation] = []
    found += _check_rpr001(tree, path)
    found += _check_rpr002(tree, path)
    if serve_path:
        found += _check_rpr003(tree, path)
        found += _check_rpr004(tree, path, text)
    found += _check_rpr005(tree, path)
    kept: List[Violation] = list(bare)
    for v in found:
        line = int(v.where.rsplit(":", 1)[-1]) if ":" in v.where else 0
        anchors = {line, line - 1}      # same line or the line above
        if v.context.startswith("lock taken at line "):
            anchors.add(int(v.context.rsplit(" ", 1)[-1]))
        if any(v.rule in ignores.get(a, ()) for a in anchors):
            continue
        kept.append(v)
    return kept


def lint_paths(roots: Sequence[str]) -> List[Violation]:
    """Lint every ``.py`` file under the given roots."""
    out: List[Violation] = []
    for root in roots:
        if os.path.isfile(root):
            files = [root]
        else:
            files = [os.path.join(dp, f)
                     for dp, _, fs in os.walk(root)
                     for f in sorted(fs) if f.endswith(".py")]
        for f in sorted(files):
            with open(f) as fh:
                text = fh.read()
            try:
                out.extend(lint_source(text, path=f))
            except SyntaxError as e:   # pragma: no cover - defensive
                out.append(Violation("RPR000",
                                     f"unparseable source: {e}", where=f))
    return out
