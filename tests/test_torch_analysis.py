"""repro_torch.analysis: the wire checker (HLO001-HLO004 on recorded
collectives), the repo lint retargeted to torch (RPR000-RPR005) and the
lock-order checker on the port's lock names (LCK001-LCK003).

Each rule is shown to fire on a seeded violation and to stay quiet on its
fixed twin (the cases of the reference's tests/test_analysis_*.py, in
their torch form), and ``python -m repro_torch.analysis --all`` passes
clean on the tree.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import (LOCK_ORDER, InstrumentedLock, LockMonitor,
                                  ProgramModel, check_lock_order,
                                  check_program, lint_paths, lint_source,
                                  model_of, monitored, verify_session)
from repro_torch.analysis.locks import check_edges, extract_acquisition_graph
from repro_torch.analysis.wire_check import CollectiveOp, TensorType
from repro_torch.core import distributed as tdist
from repro_torch.core import engine
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import erdos_renyi, random_partition

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def rules(vs):
    return [v.rule for v in vs]


# ---------------------------------------------------------------------------
# the wire checker
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo_rank(tmp_path):
    """A one-rank gloo process group on a FileStore, destroyed after."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _wire(rows, cols, dtype=torch.int32):
    return torch.zeros((rows, cols), dtype=dtype)


def _recorded(program):
    """Run ``program`` (which issues collectives through the sharded
    backend's ``_all_reduce``) under a record; its model."""
    with tdist.record_collectives() as rec:
        program()
    return model_of(rec)


def test_recorded_single_collective_passes(gloo_rank):
    m = _recorded(lambda: tdist._all_reduce(_wire(48, 2),
                                            dist.ReduceOp.SUM, None))
    (c,) = m.collectives
    assert (c.kind, c.op, c.in_loop) == ("all-reduce", "sum", False)
    assert [str(t) for t in c.results] == ["int32[48,2]"]
    assert c.payload_bits == m.payload_bits == 48 * 2 * 32
    assert check_program(m, expect_count=1,
                         expected_bits=48 * 2 * 32) == []


def test_seeded_second_collective_caught(gloo_rank):
    def two():
        tdist._all_reduce(_wire(48, 2), dist.ReduceOp.SUM, None)
        tdist._all_reduce(_wire(48, 2), dist.ReduceOp.SUM, None)
    vs = check_program(_recorded(two), expect_count=1)
    assert rules(vs) == ["HLO001"]


def test_seeded_collective_inside_a_fixpoint_caught(gloo_rank):
    """A collective issued inside a fixpoint loop (here: inside the
    engine's own FIXPOINT mark) breaks the one-round bound."""
    def looped():
        with engine.FIXPOINT:
            for _ in range(1):
                tdist._all_reduce(_wire(8, 4), dist.ReduceOp.MIN, None)
    m = _recorded(looped)
    assert m.n_fixpoints == 1 and m.collectives[0].in_loop
    assert rules(check_program(m, expect_count=1)) == ["HLO002"]


def test_seeded_collective_inside_an_engine_fixpoint_caught(gloo_rank,
                                                            monkeypatch):
    """The same through a real fixpoint: a step of the engine's propagation
    that (wrongly) issues a collective is flagged."""
    orig = torch.equal

    def equal_with_wire(a, b):
        tdist._all_reduce(_wire(1, 1), dist.ReduceOp.SUM, None)
        return orig(a, b)

    esrc = torch.tensor([[0, 1]], dtype=torch.int32)
    edst = torch.tensor([[1, 2]], dtype=torch.int32)
    front = torch.zeros((1, 1, 4), dtype=torch.bool)
    front[0, 0, 0] = True
    monkeypatch.setattr(engine.torch, "equal", equal_with_wire)
    m = _recorded(lambda: engine._propagate_bool(esrc, edst, front))
    monkeypatch.setattr(engine.torch, "equal", orig)
    assert m.n_fixpoints == 1 and all(c.in_loop for c in m.collectives)
    assert "HLO002" in rules(check_program(m, expect_count=None))


def test_seeded_payload_mismatch_caught(gloo_rank):
    m = _recorded(lambda: tdist._all_reduce(_wire(48, 2),
                                            dist.ReduceOp.SUM, None))
    vs = check_program(m, expect_count=1, expected_bits=48 * 2 * 32 + 32)
    assert rules(vs) == ["HLO003"]


def test_seeded_graph_sized_wire_dim_caught(gloo_rank):
    """A |V|-sized dimension on the wire breaks Theorem 2; the same dims
    pass when they belong to the declared wire model."""
    m = _recorded(lambda: tdist._all_reduce(_wire(48, 2),
                                            dist.ReduceOp.SUM, None))
    vs = check_program(m, expect_count=1, forbidden_dims=(48,))
    assert rules(vs) == ["HLO004"]
    assert check_program(m, expect_count=1, forbidden_dims=(48,),
                         allowed_dims=(48, 2)) == []


def test_model_rejects_unknown_dtype_and_wrong_bits():
    bad = tdist.CollectiveRecord([tdist.CollectiveEntry(
        "all-reduce", "sum", "complex32", (4,), 128, False)])
    with pytest.raises(ValueError, match="unknown element type"):
        model_of(bad)
    bad = tdist.CollectiveRecord([tdist.CollectiveEntry(
        "all-reduce", "sum", "int32", (4,), 64, False)])
    with pytest.raises(ValueError, match="records 64 bits"):
        model_of(bad)


def test_check_program_on_a_built_model():
    """check_program reads a model however it was made."""
    t = TensorType("bool", (3, 5))
    m = ProgramModel([CollectiveOp("all-reduce", "sum", 0, True, [t], [t])],
                     n_fixpoints=1)
    assert t.bits == 3 * 5 * 8 and t.bytes == 15
    assert rules(check_program(m, expect_count=2, expected_bits=1,
                               forbidden_dims=(5,))) == [
        "HLO001", "HLO002", "HLO003", "HLO004"]


def test_verify_session_on_one_rank_is_clean(gloo_rank):
    """The five programs of a sharded session on one gloo rank: one
    collective each, of the wire model's bits."""
    import repro_torch
    g = erdos_renyi(40, 110, n_labels=3, seed=3)
    fr = fragment_graph(g, random_partition(g, 4, 3), 4, reserve_boundary=4)
    sess = repro_torch.connect(fr, backend="shard_map", device="cpu")
    assert verify_session(sess) == []
    assert fr.rvset_cache is not None          # the update program's cache
    vmap = repro_torch.connect(fr, backend="vmap", device="cpu")
    with pytest.raises(ValueError, match="shard_map"):
        verify_session(vmap)


# ---------------------------------------------------------------------------
# the lint (the reference's RPR cases, in their torch form)
# ---------------------------------------------------------------------------

def test_rpr001_from_numpy_on_fragment_arrays_flagged():
    src = (
        "import torch\n"
        "def upload(fr):\n"
        "    return {k: torch.from_numpy(v) for k, v in fr.arrays.items()}\n"
    )
    assert rules(lint_source(src)) == ["RPR001"]


def test_rpr001_taint_flows_through_views_not_copies():
    src = (
        "import torch\n"
        "def f(fr, row_ids, owner, nb):\n"
        "    esrc = fr.arrays['esrc']\n"
        "    view = esrc.reshape(-1)\n"            # view: still aliased
        "    bad = torch.as_tensor(view)\n"
        "    cols = fr.arrays['tgt_local'][owner[row_ids]][:, :nb]\n"
        "    ok = torch.as_tensor(cols)\n"         # advanced indexing: copy
        "    safe = torch.from_numpy(esrc.copy())\n"  # explicit copy
        "    return bad, ok, safe\n"
    )
    vs = lint_source(src)
    assert rules(vs) == ["RPR001"]
    assert ":5" in vs[0].where


def test_rpr001_torch_tensor_is_the_fix():
    src = (
        "import torch\n"
        "def upload(fr):\n"
        "    return {k: torch.tensor(v) for k, v in fr.arrays.items()}\n"
    )
    assert lint_source(src) == []


@pytest.mark.parametrize("call", ["x.cpu()", "x.to('cuda')", "x.cuda()",
                                  "x.item()", "x.tolist()",
                                  "torch.cuda.synchronize()",
                                  "torch.equal(x, x)"])
def test_rpr002_host_sync_under_lock_flagged(call):
    src = (
        "import torch\n"
        "class S:\n"
        "    def go(self, x):\n"
        "        with self._lock:\n"
        f"            y = {call}\n"
        "        return y\n"
    )
    vs = lint_source(src)
    assert rules(vs) == ["RPR002"]
    assert "lock taken at line 4" in vs[0].context


def test_rpr002_sync_outside_lock_ok():
    src = (
        "import torch\n"
        "class S:\n"
        "    def go(self, x):\n"
        "        with self._lock:\n"
        "            n = len(x)\n"
        "        return x.cpu(), n\n"
    )
    assert lint_source(src) == []


def test_rpr003_wall_clock_and_unseeded_rng_on_serve_path():
    src = (
        "import time\n"
        "import numpy as np\n"
        "import random\n"
        "def schedule():\n"
        "    t0 = time.monotonic()\n"
        "    jitter = np.random.random()\n"
        "    pick = random.choice([1, 2])\n"
        "    return t0 + jitter + pick\n"
    )
    assert rules(lint_source(src, serve_path=True)) == ["RPR003"] * 3


def test_rpr003_seeded_generator_ok_and_rule_is_serve_only():
    src = (
        "import numpy as np\n"
        "def schedule():\n"
        "    rng = np.random.default_rng(0)\n"
        "    return rng.random()\n"
    )
    assert lint_source(src, serve_path=True) == []
    clocky = "import time\ndef f():\n    return time.time()\n"
    assert lint_source(clocky, serve_path=False) == []
    assert rules(lint_source(clocky, serve_path=True)) == ["RPR003"]


def test_rpr004_append_only_list_flagged():
    src = (
        "class Q:\n"
        "    def __init__(self):\n"
        "        self.dead = []\n"
        "    def push(self, x):\n"
        "        self.dead.append(x)\n"
    )
    vs = lint_source(src, serve_path=True)
    assert rules(vs) == ["RPR004"]
    assert "dead" in vs[0].message


def test_rpr004_drained_or_bounded_containers_ok():
    src = (
        "import collections\n"
        "class Q:\n"
        "    def __init__(self):\n"
        "        self.window = collections.deque(maxlen=64)\n"
        "        self.batch = []\n"
        "    def push(self, x):\n"
        "        self.window.append(x)\n"
        "        self.batch.append(x)\n"
        "    def flush(self):\n"
        "        out, self.batch = self.batch, []\n"
        "        return out\n"
    )
    assert lint_source(src, serve_path=True) == []


def test_rpr005_lru_cache_over_mutable_state_flagged():
    src = (
        "import functools\n"
        "@functools.lru_cache(maxsize=8)\n"
        "def plan(fr):\n"
        "    return fr.arrays['esrc'].sum()\n"
    )
    assert rules(lint_source(src)) == ["RPR005"]


def test_rpr005_cache_on_immutable_key_ok():
    src = (
        "import functools\n"
        "@functools.lru_cache(maxsize=8)\n"
        "def plan(n, kind):\n"
        "    return n * 2 + len(kind)\n"
    )
    assert lint_source(src) == []


def test_justified_ignore_suppresses_only_that_rule():
    src = (
        "import time\n"
        "def f():\n"
        "    # repr: ignore[RPR003] wall-clock batch pacing is by design\n"
        "    return time.monotonic()\n"
    )
    assert lint_source(src, serve_path=True) == []


def test_bare_ignore_is_itself_a_violation():
    src = (
        "import time\n"
        "def f():\n"
        "    return time.monotonic()  # repr: ignore[RPR003]\n"
    )
    assert rules(lint_source(src, serve_path=True)) == ["RPR000"]


def test_ignore_for_wrong_rule_does_not_suppress():
    src = (
        "import time\n"
        "def f():\n"
        "    # repr: ignore[RPR001] totally unrelated justification\n"
        "    return time.monotonic()\n"
    )
    assert rules(lint_source(src, serve_path=True)) == ["RPR003"]


def test_port_lints_clean():
    src = os.path.join(ROOT, "src", "repro_torch")
    assert [str(v) for v in lint_paths([src])] == []


# ---------------------------------------------------------------------------
# lock order: static
# ---------------------------------------------------------------------------

def _doctored(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(body)
    return str(p)


def test_port_acquisition_graph_respects_declared_order():
    vs, edges = check_lock_order(ROOT)
    assert [str(v) for v in vs] == []
    assert ("store._repair_lock", "session._lock") in edges
    assert ("store._repair_lock", "store._lock") in edges
    assert ("engine._mutex", "telemetry._lock") in edges
    # the build lock is an RLock: library() builds under it
    assert ("_build._lock", "_build._lock") in edges


def test_injected_static_inversion_caught(tmp_path):
    bad = (
        "class VersionedCacheStore:\n"
        "    def commit_delta(self, delta):\n"
        "        with self._lock:\n"
        "            with self._repair_lock:\n"
        "                pass\n"
    )
    vs, edges = check_lock_order(
        files={_doctored(tmp_path, "versions.py", bad): "store"})
    assert ("store._lock", "store._repair_lock") in edges
    assert rules(vs) == ["LCK001"]


def test_injected_inversion_through_cross_module_call_caught(tmp_path):
    tele = (
        "class Telemetry:\n"
        "    def record(self, sess):\n"
        "        with self._lock:\n"
        "            self.session.snapshot()\n"
    )
    sess = (
        "class QuerySession:\n"
        "    def snapshot(self):\n"
        "        with self._lock:\n"
        "            return 1\n"
    )
    vs, edges = check_lock_order(files={
        _doctored(tmp_path, "telemetry.py", tele): "telemetry",
        _doctored(tmp_path, "session.py", sess): "session",
    })
    assert ("telemetry._lock", "session._lock") in edges
    assert rules(vs) == ["LCK001"]


def test_module_level_locks_through_module_calls(tmp_path):
    """Module-level locks are found through calls between a module's own
    functions: the build lock re-taken by ``build()`` under ``library()``
    is a legal RLock self-edge, a counter lock re-taken through a helper
    is a self-deadlock, and any lock under a leaf inverts the order."""
    build = (
        "def library(name):\n"
        "    with _lock:\n"
        "        return build([name])\n"
        "def build(names):\n"
        "    with _lock:\n"
        "        return names\n"
    )
    vs, edges = check_lock_order(
        files={_doctored(tmp_path, "_build.py", build): "_build"})
    assert edges == {("_build._lock", "_build._lock")} and vs == []
    bad = (
        "def _count_launch():\n"
        "    with _count_lock:\n"
        "        _bump()\n"
        "def _bump():\n"
        "    with _count_lock:\n"
        "        pass\n"
    )
    vs, edges = check_lock_order(
        files={_doctored(tmp_path, "ops.py", bad): "bool_matmul"})
    assert edges == {("bool_matmul._count_lock", "bool_matmul._count_lock")}
    assert rules(vs) == ["LCK002"]
    assert rules(check_edges({("bool_matmul._count_lock",
                               "_build._lock")})) == ["LCK001"]


def test_static_self_deadlock_on_plain_lock(tmp_path):
    bad = (
        "class Telemetry:\n"
        "    def snapshot(self):\n"
        "        with self._lock:\n"
        "            with self._lock:\n"
        "                pass\n"
    )
    vs, _ = check_lock_order(
        files={_doctored(tmp_path, "telemetry.py", bad): "telemetry"})
    assert rules(vs) == ["LCK002"]


def test_static_reentrant_self_edge_allowed(tmp_path):
    ok = (
        "class QuerySession:\n"
        "    def run(self):\n"
        "        with self._lock:\n"
        "            self._plan()\n"
        "    def _plan(self):\n"
        "        with self._lock:\n"
        "            pass\n"
    )
    vs, edges = check_lock_order(
        files={_doctored(tmp_path, "session.py", ok): "session"})
    assert ("session._lock", "session._lock") in edges
    assert vs == []


def test_static_undeclared_lock_reported(tmp_path):
    bad = (
        "class QuerySession:\n"
        "    def run(self):\n"
        "        with self._lock:\n"
        "            with self._shadow_lock:\n"
        "                pass\n"
    )
    vs, _ = check_lock_order(
        files={_doctored(tmp_path, "session.py", bad): "session"})
    assert rules(vs) == ["LCK003"]
    assert "session._shadow_lock" in vs[0].message


def test_condition_objects_alias_the_engine_mutex(tmp_path):
    eng = (
        "class AsyncQueryEngine:\n"
        "    def _next_work(self):\n"
        "        with self._work:\n"
        "            self.telemetry.record(1)\n"
    )
    tele = (
        "class Telemetry:\n"
        "    def record(self, x):\n"
        "        with self._lock:\n"
        "            pass\n"
    )
    edges = extract_acquisition_graph({
        _doctored(tmp_path, "engine.py", eng): "engine",
        _doctored(tmp_path, "telemetry.py", tele): "telemetry",
    })
    assert ("engine._mutex", "telemetry._lock") in edges
    assert check_edges(edges) == []


def test_lock_order_names_the_port_locks():
    assert list(LOCK_ORDER) == [
        "engine._serve_mutex", "engine._mutex", "store._repair_lock",
        "session._lock", "store._lock", "telemetry._lock", "_build._lock",
        "bool_matmul._count_lock", "tropical_matmul._count_lock",
        "bitpack_ops._count_lock", "distributed._count_lock"]


# ---------------------------------------------------------------------------
# lock order: runtime
# ---------------------------------------------------------------------------

def _locks(monitor):
    return (InstrumentedLock(threading.RLock(), "engine._mutex", monitor),
            InstrumentedLock(threading.Lock(), "telemetry._lock", monitor))


def test_runtime_ordered_acquisition_clean():
    mon = LockMonitor()
    mutex, tlock = _locks(mon)
    with mutex:
        with tlock:
            pass
    assert mon.violations == []


def test_runtime_inversion_caught():
    mon = LockMonitor()
    mutex, tlock = _locks(mon)
    with tlock:
        with mutex:
            pass
    assert rules(mon.violations) == ["LCK001"]
    assert "engine._mutex acquired while holding telemetry._lock" in \
        mon.violations[0].message


def test_runtime_inversion_across_threads_is_per_thread():
    mon = LockMonitor()
    mutex, tlock = _locks(mon)
    hold, done = threading.Event(), threading.Event()

    def holder():
        with tlock:
            hold.set()
            done.wait(timeout=5)

    th = threading.Thread(target=holder)
    th.start()
    assert hold.wait(timeout=5)
    with mutex:
        pass
    done.set()
    th.join(timeout=5)
    assert not th.is_alive()
    assert mon.violations == []


def test_runtime_nonreentrant_double_acquire_flagged():
    mon = LockMonitor()
    lk = InstrumentedLock(threading.RLock(), "store._lock", mon)
    with lk:
        with lk:
            pass
    assert rules(mon.violations) == ["LCK002"]


def test_runtime_undeclared_lock_flagged():
    mon = LockMonitor()
    lk = InstrumentedLock(threading.Lock(), "mystery._lock", mon)
    with lk:
        pass
    assert rules(mon.violations) == ["LCK003"]


def test_condition_over_instrumented_rlock_keeps_stack_consistent():
    mon = LockMonitor()
    mutex, tlock = _locks(mon)
    cond = threading.Condition(mutex)
    woke = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            with tlock:
                woke.append(1)

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.1)
    with cond:
        cond.notify_all()
    th.join(timeout=5)
    assert not th.is_alive()
    assert woke == [1]
    assert mon.violations == []


def test_monitored_swaps_the_module_locks_back():
    """monitored() wraps the module-level leaf locks for its duration, and
    a kernel wrapper's counter taken under a session lock is in order."""
    from repro_torch.kernels.bool_matmul import ops as bops
    raw = bops._count_lock
    with monitored() as mon:
        assert isinstance(bops._count_lock, InstrumentedLock)
        session_lock = InstrumentedLock(threading.RLock(), "session._lock",
                                        mon)
        with session_lock:
            bops._count_launch()
        with bops._count_lock:
            with session_lock:             # a lock under a leaf: inverted
                pass
    assert bops._count_lock is raw
    assert rules(mon.violations) == ["LCK001"]


def test_monitored_serving_stack_end_to_end():
    """A real QueryServer built under monitored() runs every dispatch,
    flush and telemetry read on instrumented locks, and stays clean."""
    import repro_torch
    g = erdos_renyi(14, 26, n_labels=3, seed=3)
    fr = fragment_graph(g, random_partition(g, 2, 3), 2)
    with monitored() as mon:
        srv = repro_torch.QueryServer(fr, batch_size=4, start=False,
                                      device="cpu")
        assert isinstance(srv.engine._mutex, InstrumentedLock)
        rng = np.random.default_rng(0)
        reqs = [srv.submit(int(rng.integers(g.n)), int(rng.integers(g.n)))
                for _ in range(6)]
        srv.flush()
        vals = [r.value for r in reqs]
        srv.telemetry()
        srv.close()
    assert all(v in (True, False) for v in vals)
    assert [str(v) for v in mon.violations] == []


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_all_passes_on_the_tree(tmp_path):
    """``python -m repro_torch.analysis --all`` exits 0 on the tree: the
    five programs on 2 live MVCC versions of an exact-fit (k = 8) and a
    packed (k = 32) fragmentation on 8 gloo ranks, the lint and the lock
    order; the report is written."""
    out_path = tmp_path / "report.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all",
         "--root", ROOT, "--out", str(out_path)],
        capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(out_path.read_text())
    assert report["ok"] is True
    assert report["counts"] == {"wire": 0, "lint": 0, "locks": 0}
    covered = report["wire"]["covered"]
    assert any(c.startswith("k8d8: 2 versions") and "fpd=1" in c
               and "repair_sharded" in c for c in covered), covered
    assert any(c.startswith("k32d8: 2 versions") and "fpd=4" in c
               and "repair_sharded" in c for c in covered), covered
    assert report["locks"]["order"][0] == "engine._serve_mutex"
