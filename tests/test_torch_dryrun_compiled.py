"""The dry run's compiled half (repro_torch.launch.step_costs, the
compiled fields and probes of repro_torch.launch.dryrun) and its summary
(repro_torch.launch.summarize_dryrun).

* Hand counts on a (2, 2) ("data", "model") mesh of a 4-rank fake
  process group: the FLOPs and bytes of sharded matmuls and the bytes of
  each collective of known redistributions; a 2-layer reduced LM cell and
  a reduced GNN cell, replicated, against a hand count of the LM's matmul
  FLOPs and against ``FlopCounterMode`` on the plain step.
* The fake group's collectives of a reduced train cell on a 2x4 mesh
  against 8 gloo ranks running the same cell (kind, order, bytes and
  departure, in the order started); the same run holds the model code's
  DTensor repairs (the KV-cache write, MoE routing, top-k of rows, the
  graph gathered whole) equal to the single-process step.
* Every runnable cell's reduced step on real zero shards of a fake 2x4
  group: the local shapes that the meta shards of the dry run cannot
  check.
* The LM probes' extrapolation (L = 2, 4) against the direct count at L,
  on a reduced architecture at the production mesh.
* The records: every key of the reference's ``run_cell``, the departures
  apart, an error recorded with its traceback and exit code 1, and the
  summary's table with its ``fits one card`` column.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, all_cells, get_arch
from repro_torch.configs.families.base import zeros_from_abstract
from repro_torch.configs.families.lm import LMShapes
from repro_torch.launch import dryrun, step_costs, summarize_dryrun
from repro_torch.launch.collective_stats import split_departures
from repro_torch.launch.constraints import P
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.tree import leaves, tree_map
from torch_update import UPDATE_TOL

N_RANKS = 8
# every key of the reference's run_cell record (src/repro/launch/dryrun.py)
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "variant", "status", "kind", "seconds",
    "n_devices", "hlo_flops", "hlo_bytes", "arg_bytes_per_dev",
    "temp_bytes_per_dev", "out_bytes_per_dev", "peak_bytes_per_dev",
    "collective_bytes", "collective_count", "collective_breakdown",
    "collective_schedule", "model_flops", "model_bytes", "probe_flops",
    "probe_bytes", "probe_collective_bytes", "probe_method"}


@pytest.fixture
def mesh22():
    """A (2, 2) ("data", "model") CPU mesh over a 4-rank fake group."""
    with step_costs.fake_process_group(4):
        yield make_host_mesh(4, model=2, device_type="cpu")


def _meta(shape, local, mesh, places):
    """A DTensor of ``shape`` whose rank-0 shard is an f32 meta tensor of
    ``local`` (by hand)."""
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              places, run_check=False, shape=shape,
                              stride=torch.empty(shape).stride())


# ---------------------------------------------------------------------------
# hand counts
# ---------------------------------------------------------------------------

def test_private_modules_fail_clearly(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake process group"):
        step_costs._private()


def test_fake_group_refuses_a_live_group(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            with step_costs.fake_process_group(4):
                pass
    finally:
        dist.destroy_process_group()


def test_place_meta_gives_rank_zero_shards(mesh22):
    """Rank 0's shard of each leaf, by ceiling division, as meta
    tensors under the spec's placements."""
    tree = dict(a=torch.empty(5, 7, device="meta"),
                b=[torch.empty(8, 3, device="meta")])
    specs = dict(a=P(("data", "model"), None), b=[P(None, "model")])
    placed = step_costs.place_meta(tree, specs, mesh22)
    a, b = placed["a"], placed["b"][0]
    assert a.shape == (5, 7) and a.to_local().shape == (2, 7)
    assert a.placements == (Shard(0), Shard(0))
    assert b.to_local().shape == (8, 2) and b.to_local().is_meta
    assert b.placements == (Replicate(), Shard(1))


def test_sharded_matmul_flops_and_bytes(mesh22):
    """Rows on "data", columns on "model": rank 0 multiplies [4, 16] by
    [16, 2]; no collective."""
    x = _meta((8, 16), (4, 16), mesh22, [Shard(0), Replicate()])
    w = _meta((16, 4), (16, 2), mesh22, [Replicate(), Shard(1)])
    c = step_costs.run_step(lambda a, b: a @ b, (x, w))
    assert c.flops == 2 * 4 * 16 * 2
    assert c.bytes == 4 * (4 * 16 + 16 * 2 + 4 * 2)
    assert c.collectives == []
    assert c.arg_bytes == 4 * (4 * 16 + 16 * 2)
    assert c.out_bytes == 4 * 4 * 2


def test_contraction_over_model_all_reduces(mesh22):
    """The contracted dim on "model": a partial [8, 4] sum, all-reduced
    when replicated: 2 * 8 * 8 * 4 FLOPs and one all-reduce of 128 B."""
    x = _meta((8, 16), (8, 8), mesh22, [Replicate(), Shard(1)])
    w = _meta((16, 4), (8, 4), mesh22, [Replicate(), Shard(0)])
    c = step_costs.run_step(
        lambda a, b: (a @ b).redistribute(a.device_mesh,
                                          [Replicate(), Replicate()]),
        (x, w))
    assert c.flops == 2 * 8 * 8 * 4
    assert [(k.kind, k.nbytes) for k in c.collectives] == \
        [("all-reduce", 8 * 4 * 4)]


def test_known_redistributions_bytes(mesh22):
    """All-gather of row shards, all-reduce of a partial sum,
    reduce-scatter of one: each result's bytes, as on 8 gloo ranks
    (tests/test_torch_launch.py::test_collective_bytes_by_kind)."""
    rows = _meta((8, 4), (4, 4), mesh22, [Shard(0), Replicate()])
    part = _meta((8, 4), (8, 4), mesh22, [Partial(), Replicate()])
    whole = [Replicate(), Replicate()]

    def step(r, p):
        m = r.device_mesh
        return (r.redistribute(m, whole), p.redistribute(m, whole),
                p.redistribute(m, [Shard(0), Replicate()]))

    c = step_costs.run_step(step, (rows, part))
    assert [(k.kind, k.nbytes) for k in c.collectives] == [
        ("all-gather", 8 * 4 * 4), ("all-reduce", 8 * 4 * 4),
        ("reduce-scatter", 4 * 4 * 4)]
    assert c.flops == 0


def _replicated(prog):
    return tree_map(lambda s: P(), prog.arg_specs)


def _plain_flops(prog):
    args = zeros_from_abstract(prog.abstract_args, seed=1, device="cpu")
    with FlopCounterMode(display=False) as fc:
        prog.step_fn(*args)
    return fc.get_total_flops()


def _lm_prefill_hand_flops(cfg, B, S, C):
    """The matmul FLOPs of a qwen2-style prefill by hand: projections,
    SwiGLU, the tied head, and the blockwise attention's two products
    over the n (n + 1) / 2 causal block pairs."""
    T, d, H, K, dh = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.d_head
    G, n = H // K, S // C
    proj = 2 * T * d * H * dh * 2 + 2 * T * d * K * dh * 2
    ffn = 3 * 2 * T * d * cfg.d_ff
    attn = n * (n + 1) // 2 * 2 * (2 * B * K * G * C * C * dh)
    return cfg.n_layers * (proj + ffn + attn) + 2 * T * d * cfg.vocab


def test_lm_cell_flops_hand_count(mesh22):
    """qwen2-1.5b's 2-layer reduced prefill, its arguments replicated on
    the (2, 2) mesh: rank 0 does the whole program's matmuls."""
    arch = get_arch("qwen2-1.5b")
    prog = arch.build("prefill_32k", reduced=True)
    cfg = arch.smoke_cfg
    c = step_costs.run_step(prog.step_fn, step_costs.place_meta(
        prog.abstract_args, _replicated(prog), mesh22))
    want = _lm_prefill_hand_flops(cfg, 2, 64, 8)
    assert c.flops == want == _plain_flops(prog)
    assert c.collectives == []


def test_gnn_cell_flops_match_flop_counter(mesh22):
    """gat-cora's reduced full_graph_sm train step, replicated: rank 0's
    count is FlopCounterMode's on the plain step."""
    prog = get_arch("gat-cora").build("full_graph_sm", reduced=True)
    c = step_costs.run_step(prog.step_fn, step_costs.place_meta(
        prog.abstract_args, _replicated(prog), mesh22))
    assert c.flops == _plain_flops(prog) > 0
    assert c.temp_bytes > 0 and c.peak_bytes >= c.arg_bytes


# ---------------------------------------------------------------------------
# the fake group against 8 gloo ranks
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
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.configs.families.base import spec_lookup, zeros_from_abstract
from repro_torch.launch.collective_stats import record_step_collectives
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import reshard
from repro_torch.tree import flatten, keystr, tree_map_with_path
from torch_update import at_step, update_errors

mesh = make_host_mesh(__RANKS__, model=4, device_type="cpu")


def lm(aid):
    return get_arch(aid).smoke_cfg.vocab


# integer arguments drawn in range
BOUNDS = {
    ("qwen2-1.5b", "train_4k"): {"[4]": lm("qwen2-1.5b"),
                                 "[5]": lm("qwen2-1.5b")},
    ("qwen2-1.5b", "decode_32k"): {"[2]": lm("qwen2-1.5b"), "[3]": 64},
    ("olmoe-1b-7b", "prefill_32k"): {"[1]": lm("olmoe-1b-7b")},
    ("bert4rec", "serve_bulk"): {"[1]": 512},
    ("nequip", "full_graph_sm"): {
        "[4]": 8, "[6]['senders']": 64, "[6]['receivers']": 64,
        "[6]['node_mask']": 2, "[6]['edge_mask']": 2}}


def whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


report = {}
for (aid, sid), bounds in BOUNDS.items():
    prog = get_arch(aid).build(sid, reduced=True)
    gen = torch.Generator().manual_seed(6)
    args = tree_map_with_path(
        lambda p, x: torch.randint(0, bounds[keystr(p)], x.shape,
                                   generator=gen).to(x.dtype)
        if keystr(p) in bounds else x,
        zeros_from_abstract(prog.abstract_args, seed=5, device="cpu"))
    if prog.kind == "train":
        args = at_step(args)
    want = prog.step_fn(*tree_map_with_path(lambda p, x: x.clone(), args))
    placed = reshard(args, mesh, spec_lookup(prog.arg_specs))
    with record_step_collectives() as rec, implicit_replication():
        got = prog.step_fn(*placed)
    equal = True
    for g, w in zip(flatten(got)[1], flatten(want)[1]):
        g = whole(g).detach()
        equal &= (torch.allclose(g, w, rtol=1e-4, atol=1e-5)
                  if g.dtype.is_floating_point else torch.equal(g, w))
    report[f"{aid}/{sid}"] = dict(
        equal=bool(equal),
        update_err=(max(update_errors(args, got, want).values())
                    if prog.kind == "train" else 0.0),
        record=[[c.kind, c.nbytes, c.departure] for c in rec])
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


@pytest.mark.parametrize("cell", ["qwen2-1.5b/train_4k",
                                  "qwen2-1.5b/decode_32k",
                                  "olmoe-1b-7b/prefill_32k",
                                  "bert4rec/serve_bulk",
                                  "nequip/full_graph_sm"])
def test_dtensor_step_equals_single_process(ranks_report, cell):
    """The cells whose DTensor gaps the model code steps around (the
    KV-cache write, MoE routing, top-k of rows, the graph gathered whole),
    and the train cell the collectives are compared on."""
    rep = ranks_report[cell]
    assert rep["equal"], cell
    assert rep["update_err"] <= UPDATE_TOL, rep["update_err"]


def test_fake_group_collectives_match_gloo(ranks_report):
    """qwen2-1.5b's reduced train_4k on a 2x4 mesh: the fake group starts
    the collectives the 8 gloo ranks start, in kind, order and bytes,
    with the departures labelled alike."""
    prog = get_arch("qwen2-1.5b").build("train_4k", reduced=True)
    with step_costs.fake_process_group(N_RANKS):
        mesh = make_host_mesh(N_RANKS, model=4, device_type="cpu")
        c = step_costs.run_step(prog.step_fn, step_costs.place_meta(
            prog.abstract_args, prog.arg_specs, mesh))
    fake = [[k.kind, k.nbytes, k.departure] for k in c.collectives]
    gloo = ranks_report["qwen2-1.5b/train_4k"]["record"]
    kept = [r for r in fake if not r[2]]
    assert kept == [r for r in gloo if not r[2]]
    assert [r for r in fake if r[2]] == [r for r in gloo if r[2]]
    assert {r[2] for r in fake} == {"", "batch_sharded", "vocab_gather"}
    assert len(kept) > 0


# ---------------------------------------------------------------------------
# every cell's DTensor program on real shards
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh24():
    """A (2, 4) ("data", "model") CPU mesh over an 8-rank fake group."""
    with step_costs.fake_process_group(N_RANKS):
        yield make_host_mesh(N_RANKS, model=4, device_type="cpu")


@pytest.mark.parametrize("aid,sid", [
    (a, s) for a, s in all_cells() if ARCHS[a].skip_reason(s) is None])
def test_reduced_cell_runs_on_real_shards(mesh24, aid, sid):
    """Meta shards hold no values, and meta ops do not check every index:
    the dry run's meta step can pass where DTensor's local shapes are
    inconsistent.  Each reduced cell runs here on real zero shards of
    ``place_meta``'s shapes (the fake group's collectives move nothing),
    and every output's local shard has the shape DTensor assigns it."""
    prog = ARCHS[aid].build(sid, reduced=True)
    args = tree_map(
        lambda d: DTensor.from_local(
            torch.zeros(d.to_local().shape, dtype=d.dtype), mesh24,
            d.placements, run_check=False, shape=d.shape, stride=d.stride()),
        step_costs.place_meta(prog.abstract_args, prog.arg_specs, mesh24))
    with implicit_replication():
        out = prog.step_fn(*args)
    for x in leaves(out):
        if isinstance(x, DTensor):
            want, _ = compute_local_shape_and_global_offset(
                x.shape, mesh24, x.placements)
            assert tuple(x.to_local().shape) == tuple(want)


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def _small_lm(n_layers=6):
    """qwen2-1.5b with its smoke config at ``n_layers`` as the "full"
    config and small shapes, so that probes and the direct count run in a
    second at the production mesh."""
    arch = get_arch("qwen2-1.5b")
    return dataclasses.replace(
        arch, base_cfg=dataclasses.replace(arch.smoke_cfg,
                                           n_layers=n_layers),
        shapes=LMShapes(train_seq=32, train_batch=32, grad_accum=2,
                        prefill_seq=32, prefill_batch=16, decode_seq=64,
                        decode_batch=16))


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_lm_probe_extrapolates_to_direct_count(shape):
    """Loop-free LM programs are linear in the layers: the 2- and 4-layer
    probes extrapolate to the direct count at L = 6 exactly."""
    arch = _small_lm()
    pc = dryrun.probe_costs(arch, shape, False)
    direct = dryrun._costs(step_costs.cell_costs(arch.build(shape), False))
    assert {k: pc[k] for k in ("flops", "bytes", "coll")} == direct
    assert pc["method"] == "lm-2pt-extrapolation(L=6, scale=1.0)"


def test_lm_train_probe_counts_the_update_per_microbatch():
    """train_4k: one microbatch's probe times the accumulation count. The
    FLOPs (products only) match the direct count; bytes and collectives
    count the optimizer update once a microbatch, as the reference's
    probe does, so they come out at or above it."""
    arch = _small_lm()
    pc = dryrun.probe_costs(arch, "train_4k", False)
    direct = dryrun._costs(step_costs.cell_costs(arch.build("train_4k"),
                                                 False))
    assert pc["flops"] == direct["flops"] > 0
    assert pc["bytes"] >= direct["bytes"] and pc["coll"] >= direct["coll"]
    assert pc["method"] == "lm-2pt-extrapolation(L=6, scale=2.0)"


# ---------------------------------------------------------------------------
# records and the summary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,method", [
    ("retrieval_cand", "loop-free-direct"), ("serve_bulk", "chunk-probe")])
def test_record_has_every_reference_key(shape, method):
    rec = dryrun.run_cell("bert4rec", shape, False, verbose=False)
    assert REFERENCE_KEYS <= set(rec), REFERENCE_KEYS - set(rec)
    assert rec["status"] == "ok" and rec["counter"] == "dtensor-eager"
    assert rec["probe_method"].startswith(method)
    assert rec["peak_bytes_per_dev"] == \
        rec["arg_bytes_per_dev"] + rec["temp_bytes_per_dev"]
    assert rec["fits_one_card"] and rec["hlo_flops"] > 0
    assert rec["collective_bytes"] == sum(rec["collective_breakdown"].values())


def test_record_counts_departures_apart():
    """A reduced LM train cell at the production mesh: the vocab-dim and
    batch_sharded gathers go to departure_collectives, the rest to the
    collective_* fields."""
    prog = _small_lm(2).build("train_4k")
    costs = step_costs.cell_costs(prog, False)
    rec = dryrun.compiled_fields(costs, 0)
    kept, apart = split_departures(costs.collectives)
    assert set(rec["departure_collectives"]) == {"batch_sharded",
                                                 "vocab_gather"}
    assert rec["collective_count"] == len(kept) > 0
    assert sum(d["count"] for d in rec["departure_collectives"].values()) \
        == len(costs.collectives) - len(kept)
    for d in rec["departure_collectives"].values():
        assert d["bytes"] == sum(d["breakdown"].values()) > 0


def test_cli_records_an_error_and_exits_1(tmp_path, monkeypatch):
    def fail(prog, multi_pod):
        raise RuntimeError("no sharding rule")

    monkeypatch.setattr(dryrun, "cell_costs", fail)
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "bert4rec", "--shape", "serve_p99",
                        "--multi-pod", "no", "--out", str(out)]) == 1
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "error" and "no sharding rule" in rec["error"]
    assert "Traceback" in rec["traceback"]


def test_summary_merges_and_marks_fit(tmp_path):
    ok = dryrun.run_cell("bert4rec", "retrieval_cand", True, verbose=False)
    big = dict(ok, shape="serve_p99", temp_bytes_per_dev=int(90e9))
    err = dict(arch="mace", shape="molecule", mesh="16x16", status="error",
               error="boom")
    (tmp_path / "dr_a.json").write_text(json.dumps([ok, err]))
    (tmp_path / "dr_b.json").write_text(json.dumps([big, dict(err)]))
    merged = tmp_path / "all.json"
    recs = summarize_dryrun.merge(str(tmp_path / "dr_*.json"), str(merged))
    assert len(recs) == 3 and len(json.loads(merged.read_text())) == 3
    table = summarize_dryrun.dryrun_table(recs)
    assert "fits one card" in table.splitlines()[0]
    rows = {line.split(" | ")[1]: line for line in table.splitlines()[2:]}
    assert rows["retrieval_cand"].endswith("| yes |")
    assert rows["serve_p99"].endswith("| no |")
    assert "ERROR" in rows["molecule"]
    assert summarize_dryrun.main([str(merged)]) == 0
