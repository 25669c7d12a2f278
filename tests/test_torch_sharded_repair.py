"""The port's sharded cache repair (``connect(fr, backend="shard_map")
.apply(delta)`` -> ``core.distributed.apply_delta_sharded``) on 8 gloo CPU
ranks, vs the JAX package.

One module-scoped run of 8 ranks, each its own process, replays the
reference's sharded-update scenario (tests/test_incremental.py: an
erdos_renyi(48, 120) graph in 8 fragments with reserves 8/32/16, three
insert steps) and then the cases that stay on the host.  Rank 0 prints a
report that the tests hold against the reference's repair of the same
deltas, the oracles and the wire model.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import GraphDelta as JGraphDelta
from repro.core import fragment_graph as j_fragment
from repro.core import incremental as jinc
from repro.core import prepare_rvset_cache as j_prepare
from repro.core.distributed import apply_delta_sharded as j_apply_sharded
from repro.graph import erdos_renyi as j_er
from repro.graph import random_partition as j_random_partition
from repro.graph.graph import Graph as JGraph
from repro_torch import NoCudaDevice
from repro_torch.core import distributed as tdist
from repro_torch.core import incremental as tinc
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import erdos_renyi, random_partition

from oracles import oracle_reach

N_RANKS = 8
RESERVE = dict(reserve_boundary=8, reserve_edges=32, reserve_stubs=16)

_RANK = r"""
import json, sys
sys.path.insert(0, __SRC__)
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + __STORE__,
                        rank=rank, world_size=__RANKS__)
import repro_torch
from repro_torch import DeltaApplyFailed, GraphDelta, Reach
from repro_torch.core import cache as C
from repro_torch.core import distributed as D
from repro_torch.core.fragments import fragment_graph
from repro_torch.graph import erdos_renyi, random_partition
from repro_torch.graph.graph import Graph

RESERVE = __RESERVE__


def bits(x):
    return np.packbits(x.cpu().numpy()).tobytes().hex()


def state(fr):
    c = fr.rvset_cache
    return dict(closure=bits(c.closure), closure_t=bits(c.closure_t),
                bl_frontier=bits(c.bl_frontier), version=c.version,
                arrays_version=fr.arrays_version)


def counted(sess, delta):
    D.collectives = D.payload_bits = 0
    with D.record_collectives() as rec:
        st = sess.apply(delta)
    return dict(mode=st.mode, changed_rows=st.changed_rows,
                new_boundary=st.new_boundary, collectives=D.collectives,
                bits=D.payload_bits,
                in_fixpoint=[e.in_fixpoint for e in rec.entries])


report = {}
# --- the reference's scenario: three insert steps -------------------------
g = erdos_renyi(48, 120, 4, seed=5)
k = 8
part = random_partition(g, k, seed=2)
fr = fragment_graph(g, part, k, **RESERVE)
sess = repro_torch.connect(fr, backend="shard_map", device="cpu").warm()
rng = np.random.default_rng(0)
steps = []
for step in range(3):
    f = int(rng.integers(k))
    mine = np.nonzero(part == f)[0]
    other = np.nonzero(part != f)[0]
    adds = [(int(rng.choice(mine)), int(rng.choice(mine))) for _ in range(2)]
    adds += [(int(rng.choice(mine)), int(rng.choice(other)))]
    rec = counted(sess, GraphDelta.insert(adds))
    pairs = [(int(rng.integers(g.n)), int(rng.integers(g.n)))
             for _ in range(24)]
    rec.update(adds=adds, pairs=pairs, nb=fr.n_boundary,
               sharded=[r.answer for r in sess.run([Reach(s, t)
                                                    for s, t in pairs])],
               cached=[bool(a) for a in C.dis_reach_batch(fr, pairs, "cpu")],
               **state(fr))
    steps.append(rec)
report["steps"] = steps


# --- the cases the reference keeps on the host ----------------------------
def fresh(g=g, part=part, k=k, with_dist=False):
    fr = fragment_graph(g, part, k, **RESERVE)
    sess = repro_torch.connect(fr, backend="shard_map", device="cpu")
    return fr, sess.warm(with_dist=with_dist)


intra = [(int(a), int(b)) for a, b in
         [(np.nonzero(part == 3)[0][0], np.nonzero(part == 3)[0][1])]]
cases = {}
fr2, s2 = fresh()
cases["delete"] = counted(s2, GraphDelta.delete(
    [(int(g.src[0]), int(g.dst[0])), (int(g.src[7]), int(g.dst[7]))]))
cases["delete"].update(state(fr2))
fr2, s2 = fresh(with_dist=True)
cases["dist"] = counted(s2, GraphDelta.insert(intra))
cases["dist"].update(state(fr2))
fr2, s2 = fresh()
before = state(fr2)
cases["empty"] = counted(s2, GraphDelta())
cases["empty"]["unchanged"] = state(fr2) == before
fr2, s2 = fresh()
f = int(np.argmax(fr2.n_edges))
mine = np.nonzero(part == f)[0]
cases["rebuild"] = counted(s2, GraphDelta.insert(
    [(int(mine[0]), int(mine[i % len(mine)]))
     for i in range(fr2.e_max - int(fr2.n_edges[f]) + 1)]))
cases["rebuild"].update(state(fr2))
# fragment 0 receives no cross edge, so it owns no boundary row
n2, k2 = 32, 8
part2 = (np.arange(n2) // 4).astype(np.int32)
src2 = [i for i in range(n2 - 1) if i % 4 != 3] + [4 * f + 3 for f in range(7)]
dst2 = [i + 1 for i in range(n2 - 1) if i % 4 != 3] + [4 * f + 4
                                                        for f in range(7)]
g2 = Graph(n2, np.array(src2), np.array(dst2), np.zeros(n2, np.int32))
fr2, s2 = fresh(g2, part2, k2)
cases["rows_free"] = counted(s2, GraphDelta.insert([(3, 0)]))
cases["rows_free"].update(state(fr2))


class Fail:
    def maybe_fail(self, site, pairs=None):
        if site == "delta.repair":
            raise RuntimeError("injected at " + site)


fr2, s2 = fresh()
before = state(fr2)
s2.chaos = Fail()
try:
    s2.apply(GraphDelta.insert(intra))
    raised = None
except DeltaApplyFailed as exc:
    raised = str(exc.__cause__)
s2.chaos = None
cases["fault"] = dict(raised=raised, unchanged=state(fr2) == before,
                      rollbacks=s2.stats.rollbacks)
cases["fault"]["after"] = counted(s2, GraphDelta.insert(intra))
report["cases"] = cases
report["intra"] = intra
report["rebuild_edges"] = int(fr2.e_max)

every = [None] * dist.get_world_size()
dist.all_gather_object(every, report)
if rank == 0:
    print(json.dumps(dict(ranks=every)))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks_report(tmp_path_factory):
    """One run of N_RANKS gloo ranks, each its own process: every rank's
    report, gathered by rank 0."""
    here = os.path.dirname(os.path.abspath(__file__))
    store = tmp_path_factory.mktemp("gloo") / "store"
    code = (_RANK.replace("__SRC__", repr(os.path.join(here, "..", "src")))
            .replace("__STORE__", repr(str(store)))
            .replace("__RANKS__", str(N_RANKS))
            .replace("__RESERVE__", repr(RESERVE)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(N_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])["ranks"]


def _bits(arr) -> str:
    return np.packbits(np.asarray(arr)).tobytes().hex()


def _reference_steps(report):
    """The reference's host repair (``incremental.apply_delta``) of the
    same three deltas: its cache state and graph after each."""
    g = j_er(48, 120, 4, seed=5)
    part = j_random_partition(g, 8, seed=2)
    fr = j_fragment(g, part, 8, **RESERVE)
    j_prepare(fr)
    out = []
    for step in report["steps"]:
        st = jinc.apply_delta(fr, JGraphDelta.insert(
            [tuple(e) for e in step["adds"]]))
        c = fr.rvset_cache
        out.append(dict(mode=st.mode, closure=_bits(c.closure),
                        bl_frontier=_bits(c.bl_frontier),
                        graph=fr.g))
    return out


def test_insert_steps_repair_sharded(ranks_report):
    """Each insert step is a sharded repair on every rank, with the
    changed rows of the dirty fragments."""
    for rep in ranks_report:
        for step in rep["steps"]:
            assert step["mode"] == "repair_sharded", step
            assert step["changed_rows"] > 0
            assert step["new_boundary"] >= 0


def test_one_collective_of_traffic_bits_update(ranks_report):
    """Exactly one collective per repair, outside every fixpoint loop, of
    ``traffic_bits_update(r)`` bits for the padded changed-row count r."""
    g = erdos_renyi(48, 120, 4, seed=5)
    fr = fragment_graph(g, random_partition(g, 8, seed=2), 8, **RESERVE)
    for rep in ranks_report:
        for step in rep["steps"]:
            assert step["nb"] == fr.n_boundary
            r = len(tinc.pad_row_ids(np.arange(step["changed_rows"]),
                                     cap=step["nb"]))
            assert step["collectives"] == 1, step
            assert step["in_fixpoint"] == [False]
            assert step["bits"] == fr.traffic_bits_update(r), step


def test_every_rank_cache_equals_the_reference_repair(ranks_report):
    """After each step every rank's closure and bl_frontier are bit-equal
    to the reference's host repair of the same deltas, and the closure's
    K-major copy is its transpose."""
    ref = _reference_steps(ranks_report[0])
    for rep in ranks_report:
        for step, want in zip(rep["steps"], ref):
            assert step["closure"] == want["closure"]
            assert step["bl_frontier"] == want["bl_frontier"]
    ref_closure = np.unpackbits(np.frombuffer(
        bytes.fromhex(ref[-1]["closure"]), np.uint8))
    nb = ranks_report[0]["steps"][-1]["nb"]
    C = ref_closure[:nb * nb].reshape(nb, nb)
    got_t = np.unpackbits(np.frombuffer(
        bytes.fromhex(ranks_report[0]["steps"][-1]["closure_t"]), np.uint8))
    np.testing.assert_array_equal(got_t[:nb * nb].reshape(nb, nb), C.T)


def test_answers_after_each_step_match_bfs(ranks_report):
    """24 reach queries after each step, through the sharded batch and the
    cached path, on every rank, equal the oracle on the updated graph."""
    ref = _reference_steps(ranks_report[0])
    for rep in ranks_report:
        for step, want in zip(rep["steps"], ref):
            oracle = [oracle_reach(want["graph"], s, t)
                      for s, t in step["pairs"]]
            assert step["sharded"] == oracle
            assert step["cached"] == oracle


def _jax_case(name, report):
    """The mode the reference's apply_delta_sharded takes for a host-path
    case (none of them reaches its mesh)."""
    part = None
    if name == "rows_free":
        n, k = 32, 8
        part = (np.arange(n) // 4).astype(np.int32)
        src = [i for i in range(n - 1) if i % 4 != 3] + [4 * f + 3
                                                         for f in range(7)]
        dst = [i + 1 for i in range(n - 1) if i % 4 != 3] + [4 * f + 4
                                                             for f in range(7)]
        g = JGraph(n, np.array(src), np.array(dst), np.zeros(n, np.int32))
    else:
        g, k = j_er(48, 120, 4, seed=5), 8
        part = j_random_partition(g, 8, seed=2)
    fr = j_fragment(g, part, k, **RESERVE)
    j_prepare(fr, with_dist=name == "dist")
    intra = [tuple(e) for e in report["intra"]]
    if name == "delete":
        delta = JGraphDelta.delete([(int(g.src[0]), int(g.dst[0])),
                                    (int(g.src[7]), int(g.dst[7]))])
    elif name == "dist":
        delta = JGraphDelta.insert(intra)
    elif name == "empty":
        delta = JGraphDelta()
    elif name == "rebuild":
        f = int(np.argmax(fr.n_edges))
        mine = np.nonzero(part == f)[0]
        delta = JGraphDelta.insert(
            [(int(mine[0]), int(mine[i % len(mine)]))
             for i in range(fr.e_max - int(fr.n_edges[f]) + 1)])
    else:
        delta = JGraphDelta.insert([(3, 0)])
    st = j_apply_sharded(fr, delta)
    c = fr.rvset_cache
    return st.mode, _bits(c.closure), _bits(c.bl_frontier)


@pytest.mark.parametrize("name", ["delete", "dist", "empty", "rebuild",
                                  "rows_free"])
def test_host_path_cases_take_the_reference_modes(ranks_report, name):
    """Deletions, a distance cache, the empty delta, a rebuild and a delta
    whose dirty fragment owns no boundary row take the modes the
    reference's apply_delta_sharded takes, with no collective, and end
    with its cache on every rank."""
    mode, closure, front = _jax_case(name, ranks_report[0])
    for rep in ranks_report:
        case = rep["cases"][name]
        assert case["mode"] == mode, (name, case["mode"], mode)
        assert case["collectives"] == 0 and case["bits"] == 0
        if name == "empty":
            assert case["unchanged"]
        else:
            assert case["closure"] == closure
            assert case["bl_frontier"] == front
    assert {"delete": "recompute", "dist": "repair", "empty": "noop",
            "rebuild": "rebuild", "rows_free": "repair_sharded"}[name] == mode


def test_injected_fault_rolls_back_on_every_rank(ranks_report):
    """A fault at ``delta.repair`` (after the host arrays mutated) rolls
    the fragmentation and the cache back on every rank; the same delta
    then repairs sharded with one collective."""
    for rep in ranks_report:
        case = rep["cases"]["fault"]
        assert case["raised"] == "injected at delta.repair"
        assert case["unchanged"] and case["rollbacks"] == 1
        assert case["after"]["mode"] == "repair_sharded"
        assert case["after"]["collectives"] == 1


# ---------------------------------------------------------------------------
# in-process: no card, no device
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


@pytest.mark.parametrize("call", ["reach_batch", "dist_batch", "rpq_batch",
                                  "reach_one", "rpq_one"])
def test_sharded_functions_raise_without_a_card(gloo_rank, monkeypatch,
                                                call):
    """With no card and no ``device=``, the sharded batch and one-shot
    functions raise the typed NoCudaDevice, as ``connect`` does."""
    from repro_torch.core.automaton import build_query_automaton
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = erdos_renyi(32, 80, 3, seed=1)
    fr = fragment_graph(g, random_partition(g, 4, 1), 4)
    qa = build_query_automaton("(0|1)*", int)
    fn = {"reach_batch": lambda: tdist.dis_reach_batch_sharded(fr, [(0, 5)]),
          "dist_batch": lambda: tdist.dis_dist_batch_sharded(fr, [(0, 5)]),
          "rpq_batch": lambda: tdist.dis_rpq_batch_sharded(fr, [(0, 5)], qa),
          "reach_one": lambda: tdist.dis_reach_sharded(fr, 0, 5),
          "rpq_one": lambda: tdist.dis_rpq_sharded(fr, 0, 5, qa)}[call]
    with pytest.raises(NoCudaDevice):
        fn()


def test_record_collectives_marks_fixpoints(gloo_rank):
    """The record of one sharded repair on one rank: one entry of the wire
    model's shape and dtype, outside the fixpoints the program entered."""
    import repro_torch
    from repro_torch import GraphDelta
    g = erdos_renyi(48, 120, 4, seed=5)
    part = random_partition(g, 8, seed=2)
    fr = fragment_graph(g, part, 8, **RESERVE)
    sess = repro_torch.connect(fr, backend="shard_map", device="cpu").warm()
    mine = np.nonzero(part == 2)[0]
    with tdist.record_collectives() as rec:
        st = sess.apply(GraphDelta.insert([(int(mine[0]), int(mine[1]))]))
    assert st.mode == "repair_sharded"
    (e,) = rec.entries
    r = len(tinc.pad_row_ids(np.arange(st.changed_rows), cap=fr.n_boundary))
    words = (fr.n_boundary + 31) // 32 + (fr.n_max + 32) // 32
    assert (e.kind, e.op, e.dtype, e.shape) == ("all-reduce", "sum",
                                                 "int32", (r, words))
    assert e.bits == fr.traffic_bits_update(r) and not e.in_fixpoint
    assert rec.fixpoints >= 2          # the resume and the r x r closure
    with pytest.raises(RuntimeError, match="already open"):
        with tdist.record_collectives():
            with tdist.record_collectives():
                pass
