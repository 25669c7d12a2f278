"""The registry of the port (repro_torch.configs: ARCHS, get_arch,
list_archs, all_cells) against the JAX package's, and bert4rec's cell
programs (repro_torch.configs.families.recsys) against the reference's:
every cell at full size, abstractly, and at ``reduced=True``, one step
on the reference's arguments, outputs within the f32 tolerance of
tests/torch_cells.py (rtol 1e-4, atol 1e-5), top-k indices exactly."""
import pytest

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
import torch_cells as tc

CELLS = tc.cells("recsys")
RUNNABLE = tc.runnable("recsys")


@pytest.fixture(scope="module")
def reference():
    """The reference's reduced steps, each jitted once for the module."""
    return tc.reference_outputs(RUNNABLE)


def test_registry_has_all_ten_and_forty_cells():
    expected = {"olmoe-1b-7b", "mixtral-8x7b", "qwen1.5-32b", "qwen2-1.5b",
                "chatglm3-6b", "egnn", "mace", "nequip", "gat-cora",
                "bert4rec"}
    assert set(tconfigs.ARCHS) == expected
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.all_cells() == jconfigs.all_cells()
    assert len(tconfigs.all_cells()) == 40
    for aid in expected:
        assert tconfigs.get_arch(aid) is tconfigs.ARCHS[aid]
    assert (set(tconfigs.LM_ARCHS) | set(tconfigs.GNN_ARCHS)
            | set(tconfigs.RECSYS_ARCHS)) == expected


def test_skips_match_reference_and_are_only_long_context():
    got = [(a, s, tconfigs.ARCHS[a].skip_reason(s))
           for a, s in tconfigs.all_cells()]
    want = [(a, s, jconfigs.ARCHS[a].skip_reason(s))
            for a, s in jconfigs.all_cells()]
    assert got == want
    skips = [(a, s) for a, s, r in got if r]
    assert sorted(a for a, _ in skips) == sorted(
        ["olmoe-1b-7b", "qwen1.5-32b", "qwen2-1.5b", "chatglm3-6b"])
    assert all(s == "long_500k" for _, s in skips)


def test_full_configs_match_assignment():
    """The spot-checks of tests/test_arch_smoke.py, on the port."""
    get = tconfigs.get_arch
    q32 = get("qwen1.5-32b").base_cfg
    assert (q32.n_layers, q32.d_model, q32.n_heads, q32.d_ff,
            q32.vocab) == (64, 5120, 40, 27392, 152064)
    assert q32.qkv_bias
    mix = get("mixtral-8x7b").base_cfg
    assert (mix.n_layers, mix.d_model, mix.n_experts, mix.top_k,
            mix.d_ff_expert, mix.sliding_window) == (32, 4096, 8, 2, 14336,
                                                     4096)
    olm = get("olmoe-1b-7b").base_cfg
    assert (olm.n_experts, olm.top_k, olm.d_ff_expert,
            olm.vocab) == (64, 8, 1024, 50304)
    q2 = get("qwen2-1.5b").base_cfg
    assert (q2.n_layers, q2.d_model, q2.n_heads, q2.n_kv_heads,
            q2.d_ff, q2.vocab) == (28, 1536, 12, 2, 8960, 151936)
    glm = get("chatglm3-6b").base_cfg
    assert (glm.n_layers, glm.d_model, glm.n_heads, glm.n_kv_heads,
            glm.d_ff, glm.vocab) == (28, 4096, 32, 2, 13696, 65024)
    assert glm.rope_pct == 0.5
    b4r = get("bert4rec").full_cfg
    assert (b4r.embed_dim, b4r.n_blocks, b4r.n_heads,
            b4r.seq_len) == (64, 2, 2, 200)


@pytest.mark.parametrize("multipod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("aid,sid", CELLS,
                         ids=[f"{a}::{s}" for a, s in CELLS])
def test_full_size_program_matches_reference(aid, sid, multipod):
    tc.check_abstract(aid, sid, multipod)


@pytest.mark.parametrize("aid,sid", RUNNABLE,
                         ids=[f"{a}::{s}" for a, s in RUNNABLE])
def test_reduced_step_matches_reference(reference, aid, sid):
    tc.check_reduced(aid, sid, reference[aid, sid])


def test_serve_bulk_probe_is_one_chunk():
    """``probe=True``: serve_bulk runs one chunk, cost_scale the count."""
    p = tconfigs.get_arch("bert4rec").build("serve_bulk", probe=True)
    j = jconfigs.get_arch("bert4rec").build("serve_bulk", probe=True)
    assert p.cost_scale == j.cost_scale == 262_144 / 4_096
    assert tuple(p.abstract_args[1].shape) == tuple(j.abstract_args[1].shape)
