"""The port's launch layer (repro_torch.launch) and ``train.reshard``.

In-process: partition specs and their DTensor placements, ``hint`` on
plain tensors and on a mesh without the spec's dims, the production
meshes' requirements, the dry run's records and CLI (argument bytes
against a hand count; nothing allocated), and a ``reshard`` round trip on
a one-rank gloo group (the counterpart of test_substrate.py's).

One spawned run of 8 gloo ranks, each a ``python -c`` process whose rank
0 prints a JSON report, on a 2x4 ("data", "model") mesh: the counterpart
of test_launch.py's mini dry run (three reduced cells placed by their
``arg_specs`` with ``reshard``, one step each under
``implicit_replication`` at an optimizer step past the warm-up, equal
to the single-process step within rtol 1e-4 / atol 1e-5 and its update
within tests/torch_update.py's UPDATE_TOL of the update's scale, their
collectives recorded); ``collective_bytes`` and
``collective_schedule`` over known redistributions; and bert4rec's
two-stage top-k through ``local_map``, equal to the single-device top-k
with ties.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.constraints import P, hint, placements
from repro_torch.launch.mesh import (PRODUCTION, make_host_mesh,
                                     make_production_mesh)
from repro_torch.train import reshard
from torch_update import UPDATE_TOL

N_RANKS = 8


# ---------------------------------------------------------------------------
# specs, placements, hints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,names,want", [
    (P("data", None), ("data", "model"), [Shard(0), Replicate()]),
    (P(None, "model"), ("data", "model"), [Replicate(), Shard(1)]),
    (P(("data", "model")), ("data", "model"), [Shard(0), Shard(0)]),
    (P(("pod", "data"), None, "model"), ("pod", "data", "model"),
     [Shard(0), Shard(0), Shard(2)]),
    (P(), ("data", "model"), [Replicate(), Replicate()]),
], ids=["data", "model", "flat", "multipod", "replicated"])
def test_placements_of_specs(spec, names, want):
    assert placements(spec, names) == want


@pytest.mark.parametrize("spec", [P("pod"), P("data", "data"),
                                  P(("model", "data"))],
                         ids=["unknown", "twice", "order"])
def test_placements_reject_bad_specs(spec):
    with pytest.raises(ValueError):
        placements(spec, ("data", "model"))


def test_spec_normalizes_like_jax():
    assert P(("data",), None) == P("data", None)
    assert P((), "model") == P(None, "model")
    assert P(("pod", "data"), None).names() == ("pod", "data")


def test_hint_leaves_plain_tensors_alone():
    x = torch.ones(4, 3)
    assert hint(x, "data", None) is x


@pytest.fixture
def gloo_rank(tmp_path):
    """A one-rank gloo process group on a FileStore, destroyed after."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_hint_needs_the_spec_dims(gloo_rank):
    """On a one-rank mesh named ("data", "model"), a hint naming "pod"
    does nothing; one naming "model" places the tensor."""
    mesh = make_host_mesh(1, device_type="cpu")
    x = DTensor.from_local(torch.ones(4, 3), mesh, [Replicate(), Replicate()])
    assert hint(x, "pod", None) is x
    y = hint(x, None, "model")
    assert y.placements == (Replicate(), Shard(1))
    assert torch.equal(y.full_tensor(), torch.ones(4, 3))


def test_production_mesh_needs_its_world(gloo_rank):
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=str(n)):
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert PRODUCTION[False].names == ("data", "model")
    assert PRODUCTION[True].shape == (2, 16, 16)


def test_reshard_roundtrip(gloo_rank):
    mesh = make_host_mesh(1, device_type="cpu")
    tree = dict(w=torch.ones(8, 4), b=[torch.zeros(4), torch.arange(3)])
    specs = {"['w']": P("data", "model"), "['b'][0]": P(), "['b'][1]": P()}
    out = reshard(tree, mesh, lambda path, leaf: specs[path])
    assert isinstance(out["w"], DTensor) and isinstance(out["b"], list)
    assert out["w"].placements == (Shard(0), Shard(1))
    assert torch.equal(out["w"].full_tensor(), torch.ones(8, 4))
    assert torch.equal(out["b"][1].full_tensor(), torch.arange(3))


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _retrieval_bytes():
    """bert4rec retrieval_cand by hand: (whole, on one device)."""
    d, ff, n_items, seq, n_cand = 64, 256, 1_000_000, 200, 1_000_000
    block = 2 * d + d * 3 * d + d * d + d * ff + ff * d
    replicated = 4 * (seq * d + d + 2 * block) + 4 * seq
    whole = replicated + 4 * n_items * d + 4 * n_cand
    per_dev = replicated + 4 * (n_items // 16) * d + 4 * (n_cand // 16)
    return whole, per_dev


def test_dryrun_cli_one_cell(tmp_path):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "bert4rec", "--shape", "retrieval_cand",
                        "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    whole, per_dev = _retrieval_bytes()
    for r in recs:
        assert r["status"] == "ok" and r["kind"] == "retrieval"
        assert r["arg_bytes"] == whole
        assert r["arg_bytes_per_dev"] == per_dev
        assert r["args_fit_one_card"]


def test_dryrun_records_allocate_nothing():
    """A full-size cell is built on the meta device: qwen1.5-32b's decode
    cell holds 2.9 TB of arguments and fits no card."""
    prog = get_arch("qwen1.5-32b").build("decode_32k")
    from repro_torch.tree import leaves
    assert all(x.device.type == "meta" for x in leaves(prog.abstract_args))
    rec = dryrun.run_cell("qwen1.5-32b", "decode_32k", False, verbose=False)
    assert rec["arg_bytes"] > 2e12 and not rec["args_fit_one_card"]
    assert rec["arg_bytes_per_dev"] < rec["arg_bytes"] / 200
    skipped = dryrun.run_cell("qwen2-1.5b", "long_500k", True)
    assert skipped["status"] == "skipped" and "attention" in skipped["reason"]


def test_dryrun_shard_shape_ceil_divides():
    mesh = PRODUCTION[True]
    assert dryrun.shard_shape((1000, 7), P(("pod", "data"), "model"),
                              mesh) == (32, 1)
    assert dryrun.shard_shape((5,), P(), mesh) == (5,)
    assert math.prod(mesh.shape) == mesh.size == 512


# ---------------------------------------------------------------------------
# 8 gloo ranks on a 2x4 mesh
# ---------------------------------------------------------------------------

_RANK = r"""
import json, sys
sys.path.insert(0, __SRC__)
sys.path.insert(0, __TESTS__)
import torch
import torch.distributed as dist
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + __STORE__,
                        rank=rank, world_size=__RANKS__)
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.configs.families.base import spec_lookup, zeros_from_abstract
from repro_torch.launch.collective_stats import (
    collective_bytes, collective_schedule, record_step_collectives)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import bert4rec as B
from repro_torch.train import reshard
from repro_torch.tree import flatten, keystr, tree_map_with_path
from torch_update import at_step, update_errors

mesh = make_host_mesh(__RANKS__, model=4, device_type="cpu")
# the int arguments drawn in range (zeros would send every edge 0 -> 0)
BOUNDS = {
    ("qwen2-1.5b", "train_4k"): {"[4]": 128, "[5]": 128},
    ("gat-cora", "molecule"): {
        "[5]['senders']": 64, "[5]['receivers']": 64, "[5]['graph_ids']": 8,
        "[5]['node_mask']": 2, "[5]['edge_mask']": 2, "[6]": 5},
    ("bert4rec", "train_batch"): {"[4]": 512, "[5]": 16, "[6]": 512,
                                  "[7]": 512}}


def whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


report = {"cells": {}}
for (aid, sid), bounds in BOUNDS.items():
    prog = get_arch(aid).build(sid, reduced=True)
    gen = torch.Generator().manual_seed(6)
    args = tree_map_with_path(
        lambda p, x: torch.randint(0, bounds[keystr(p)], x.shape,
                                   generator=gen).to(x.dtype)
        if keystr(p) in bounds else x,
        zeros_from_abstract(prog.abstract_args, seed=5, device="cpu"))
    args = at_step(args)                # the update reads above rtol/atol
    want = prog.step_fn(*tree_map_with_path(lambda p, x: x.clone(), args))
    placed = reshard(args, mesh, spec_lookup(prog.arg_specs))
    with record_step_collectives() as rec, implicit_replication():
        got = prog.step_fn(*placed)
    equal, dtensors = True, 0
    for g, w in zip(flatten(got)[1], flatten(want)[1]):
        dtensors += isinstance(g, DTensor)
        g = whole(g).detach()
        equal &= (torch.allclose(g, w, rtol=1e-4, atol=1e-5)
                  if g.dtype.is_floating_point else torch.equal(g, w))
    update_err = max(update_errors(args, got, want).values())
    report["cells"][f"{aid}/{sid}"] = dict(
        equal=bool(equal), update_err=update_err, dtensors=dtensors,
        outputs=len(flatten(got)[1]),
        collectives=collective_bytes(rec),
        schedule=collective_schedule(rec, 4))

# known redistributions of an [8, 4] f32 tensor
x = torch.arange(32.0).reshape(8, 4)
part = DTensor.from_local(x / 2, mesh, [Partial(), Replicate()],
                          run_check=False)
rows = distribute_tensor(x, mesh, [Shard(0), Replicate()])
by_model = distribute_tensor(x, mesh, [Replicate(), Shard(0)])
with record_step_collectives() as rec:
    a = rows.redistribute(mesh, [Replicate(), Replicate()])
    b = part.redistribute(mesh, [Replicate(), Replicate()])
    c = part.redistribute(mesh, [Shard(0), Replicate()])
report["known"] = dict(bytes=collective_bytes(rec),
                       schedule=collective_schedule(rec),
                       values=bool(torch.equal(a.full_tensor(), x)
                                   and torch.equal(b.full_tensor(), x)
                                   and torch.equal(c.full_tensor(), x)))

# two-stage top-k through local_map, with ties (values from a small set)
cfg = B.Bert4RecConfig(n_items=64, embed_dim=8, n_blocks=1, n_heads=2,
                       seq_len=4, topk_ways=8)
scores = torch.randint(0, 5, (8, 64), generator=torch.Generator()
                       .manual_seed(7)).float()
placed = distribute_tensor(scores, mesh, [Shard(0), Replicate()])
with record_step_collectives() as rec:
    v, i = B._topk_scores(cfg, placed, 6)
v1, i1 = B._top_k(scores, 6)
report["topk"] = dict(dtensor=isinstance(v, DTensor),
                      values=bool(torch.equal(whole(v), v1)),
                      indices=bool(torch.equal(whole(i), i1)),
                      ties=int((v1[:, 1:] == v1[:, :-1]).sum()),
                      collectives=collective_bytes(rec))
if rank == 0:
    print(json.dumps(report))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks_report(tmp_path_factory):
    """One run of N_RANKS gloo ranks, each its own process."""
    here = os.path.dirname(os.path.abspath(__file__))
    store = tmp_path_factory.mktemp("gloo") / "store"
    code = (_RANK.replace("__SRC__", repr(os.path.join(here, "..", "src")))
            .replace("__STORE__", repr(str(store)))
            .replace("__TESTS__", repr(here))
            .replace("__RANKS__", str(N_RANKS)))
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
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["qwen2-1.5b/train_4k", "gat-cora/molecule",
                                  "bert4rec/train_batch"])
def test_mini_dryrun_sharded_equals_single_process(ranks_report, cell):
    rep = ranks_report["cells"][cell]
    assert rep["equal"], rep
    assert rep["update_err"] <= UPDATE_TOL, rep
    assert rep["dtensors"] == rep["outputs"]      # every output placed
    assert rep["collectives"]["count"] > 0
    assert rep["collectives"]["total"] == sum(
        v for k, v in rep["collectives"].items() if k not in ("total",
                                                              "count"))


def test_mini_dryrun_qwen2_communicates(ranks_report):
    coll = ranks_report["cells"]["qwen2-1.5b/train_4k"]["collectives"]
    assert coll["count"] > 0 and coll["all-gather"] > 0
    assert coll["all-reduce"] > 0


def test_collective_bytes_by_kind(ranks_report):
    """All-gather of row shards, all-reduce of a partial sum, and
    reduce-scatter of one: each result's bytes, in order."""
    known = ranks_report["known"]
    assert known["values"]
    assert known["bytes"] == {"all-gather": 8 * 4 * 4,
                              "all-reduce": 8 * 4 * 4,
                              "reduce-scatter": 4 * 4 * 4,
                              "total": 8 * 4 * 4 * 2 + 4 * 4 * 4,
                              "count": 3}
    assert known["schedule"] == ["all-gather(f32[8,4])",
                                 "all-reduce(f32[8,4])",
                                 "reduce-scatter(f32[4,4])"]


def test_two_stage_topk_local_map_is_exact(ranks_report):
    rep = ranks_report["topk"]
    assert rep["dtensor"] and rep["values"] and rep["indices"], rep
    assert rep["ties"] > 0
    assert rep["collectives"]["all-gather"] > 0
