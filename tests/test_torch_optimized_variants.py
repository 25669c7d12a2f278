"""The port's optimized variants, as tests/test_optimized_variants.py
holds the reference's: the two-stage top-k is exact; the fused GNN
aggregation matches the per-path one within bf16's tolerance; the LM's
and the equivariant nets' mesh hints are accepted and numeric no-ops on
plain tensors; the three optimized builds run and give finite outputs,
and one step of each equals the JAX package's optimized build on the same
arguments (tests/torch_cells.py's tolerances; bf16 for MACE's
``fused_agg``).  Each of the others is also held against the JAX package
on the same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import bert4rec as JB
from repro.models import transformer as JT
from repro.models.gnn import common as jcommon
from repro.models.gnn import equivariant as jeq
from repro_torch.configs import get_arch
from repro_torch.configs.families.base import zeros_from_abstract
from repro_torch.models import bert4rec as B
from repro_torch.models import transformer as T
from repro_torch.models.gnn import common, equivariant
from repro_torch.tree import leaves
import torch_cells as tc


def test_two_stage_topk_exact():
    cfg = B.Bert4RecConfig(n_items=512, embed_dim=32, n_blocks=1,
                           n_heads=2, seq_len=8, topk_ways=8)
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(6, 512)).astype(np.float32)
    scores[:, 100:140] = scores[:, 99:100]        # ties across the ways
    v2, i2 = B._topk_scores(cfg, torch.from_numpy(scores), 10)
    v1, i1 = B._top_k(torch.from_numpy(scores), 10)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), 10)
    jcfg = JB.Bert4RecConfig(n_items=512, embed_dim=32, n_blocks=1,
                             n_heads=2, seq_len=8, topk_ways=8)
    jv2, ji2 = JB._topk_scores(jcfg, jnp.asarray(scores), 10)
    np.testing.assert_array_equal(v2.numpy(), v1.numpy())
    np.testing.assert_array_equal(i2.numpy(), i1.numpy())
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji2))
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), rtol=1e-6)


def test_fused_agg_matches_per_path():
    rng = np.random.default_rng(1)
    base = equivariant.EquivariantConfig(arch="nequip", n_layers=2,
                                         channels=8, l_max=2, correlation=1,
                                         n_species=4, cutoff=3.0)
    fused = dataclasses.replace(base, fused_agg=True,
                                shard_axes=("data", "model"))
    jbase = jeq.EquivariantConfig(arch="nequip", n_layers=2, channels=8,
                                  l_max=2, correlation=1, n_species=4,
                                  cutoff=3.0)
    tree = jax.tree.map(np.asarray, jeq.init_params(jbase, jax.random.key(0)))
    params = equivariant.params_from_jax(base, tree, device="cpu")
    senders = rng.integers(0, 12, 40)
    receivers = rng.integers(0, 12, 40)
    g = common.pad_graph(senders, receivers, 12, 48, 16, device="cpu")
    jg = jcommon.pad_graph(senders, receivers, 12, 48, 16)
    species = rng.integers(0, 4, 16)
    coords = rng.normal(size=(16, 3)).astype(np.float32)
    with torch.no_grad():
        e_base = equivariant.forward(base, params, torch.from_numpy(species),
                                     torch.from_numpy(coords), g)
        e_fused = equivariant.forward(fused, params,
                                      torch.from_numpy(species),
                                      torch.from_numpy(coords), g)
    want = jeq.forward(jbase, jax.tree.map(jnp.asarray, tree),
                       jnp.asarray(species, jnp.int32), jnp.asarray(coords),
                       jg)
    np.testing.assert_allclose(e_base.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    # the fused path aggregates messages in bf16
    np.testing.assert_allclose(e_base.numpy(), e_fused.float().numpy(),
                               rtol=3e-2, atol=3e-2)


def test_lm_dp_hints_are_numeric_noops():
    base = T.LMConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab=97, attn_chunk=8,
                      remat=False)
    hinted = dataclasses.replace(base, dp_axes=("data",))
    params = T.init_params(base, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 97, (2, 32)))
    with torch.no_grad():
        l1, _ = T.forward(base, params, toks)
        l2, _ = T.forward(hinted, params, toks)      # no mesh -> no-op
    assert torch.equal(l1, l2)
    jc = JT.LMConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_head=16, d_ff=128, vocab=97, attn_chunk=8,
                     remat=False, dp_axes=("data",))
    assert jc.dp_axes == hinted.dp_axes


def test_optimized_builds_smoke():
    for aid, sid in [("bert4rec", "serve_bulk"), ("mace", "molecule"),
                     ("qwen2-1.5b", "train_4k")]:
        prog = get_arch(aid).build(sid, reduced=True, optimized=True)
        args = zeros_from_abstract(prog.abstract_args, seed=1, device="cpu")
        out = prog.step_fn(*args)
        floats = [x for x in leaves(out) if x.dtype.is_floating_point]
        assert floats, (aid, sid)
        for x in floats:
            assert torch.isfinite(x).all(), (aid, sid)


@pytest.fixture(scope="module")
def optimized_reference():
    """The reference's optimized reduced steps, each jitted once."""
    return tc.reference_outputs(tc.OPTIMIZED, optimized=True)


@pytest.mark.parametrize("aid,sid", tc.OPTIMIZED,
                         ids=[f"{a}::{s}" for a, s in tc.OPTIMIZED])
def test_optimized_build_matches_reference(optimized_reference, aid, sid):
    tc.check_reduced(aid, sid, optimized_reference[aid, sid],
                     optimized=True, bf16=aid == "mace")


def test_optimized_configs_accept_mesh_hints():
    """dp_axes and shard_axes are taken, on both meshes' dims."""
    for multipod in (False, True):
        lm = get_arch("qwen2-1.5b")._cfg("train_4k", False, multipod=multipod,
                                         optimized=True)
        assert lm.dp_axes == (("pod", "data") if multipod else ("data",))
    eq = equivariant.EquivariantConfig(fused_agg=True,
                                       shard_axes=("pod", "data", "model"))
    assert eq.shard_axes == ("pod", "data", "model")
