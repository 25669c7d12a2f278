"""The GNN family's cell programs (repro_torch.configs.families.gnn)
against the JAX package's: every cell at full size, abstractly (kind,
model FLOPs and bytes, argument shapes, dtypes and partition specs, for
both production meshes), and every cell at ``reduced=True``, one train
step on the reference's arguments, outputs within the f32 tolerance of
tests/torch_cells.py (rtol 1e-4, atol 1e-5).  The molecule loss
differentiates the forces again (``create_graph``)."""
import pytest

import torch_cells as tc

CELLS = tc.cells("gnn")
RUNNABLE = tc.runnable("gnn")


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


def test_train_cells_expose_their_loss():
    """Every GNN cell is a train cell whose ``loss_fn`` is what its step
    differentiates: the step's loss equals it on the same arguments."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.families.base import zeros_from_abstract
    prog = get_arch("egnn").build("molecule", reduced=True)
    args = zeros_from_abstract(prog.abstract_args, seed=4, device="cpu")
    loss = prog.loss_fn(args[0], *args[4:])
    assert torch.equal(prog.step_fn(*args)[-1], loss.detach())
