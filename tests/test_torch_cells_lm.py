"""The LM family's cell programs (repro_torch.configs.families.lm)
against the JAX package's: every cell at full size, abstractly (kind,
model FLOPs and bytes, cost scale, argument shapes, dtypes and partition
specs, for both production meshes), and every runnable cell at
``reduced=True``, one step on the reference's arguments, outputs within
the f32 tolerance of tests/torch_cells.py (rtol 1e-4, atol 1e-5)."""
import pytest

import torch_cells as tc

CELLS = tc.cells("lm")
RUNNABLE = tc.runnable("lm")


@pytest.fixture(scope="module")
def reference():
    """The reference's reduced steps, each jitted once for the module."""
    return tc.reference_outputs(RUNNABLE)


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


def test_lm_param_specs_drop_the_layer_axis():
    """The port's rule on its per-layer layout: every projection, expert
    and router leaf of the MoE and dense archs gets the reference's spec
    without its layer entry (covered leaf for leaf above; here the rule's
    branches are named)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.families.lm import _lm_param_spec
    from repro_torch.launch.constraints import P
    prog = get_arch("olmoe-1b-7b").build("prefill_32k")
    layer = prog.abstract_args[0]["layers"][0]
    cfg = get_arch("olmoe-1b-7b").base_cfg
    specs = {k: _lm_param_spec(cfg, f"['layers'][0]['{k}']", v)
             for k, v in layer.items()}
    assert specs["wq"] == P("data", "model")
    assert specs["wo"] == P("model", "data")
    assert specs["router"] == P("data", None)
    assert specs["w1"] == specs["w2"] == P("model", "data", None)  # 64 % 16
    assert specs["ln1"] == P()
