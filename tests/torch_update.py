"""A train step's update held against another run's, without JAX (the
card tests and the gloo ranks import this too): the update is new minus
old params, ``m`` and ``v`` (outputs 0-2 of a cell's train step).

A train cell steps at :data:`STEP`, past the optimizer's 200 warm-up
steps, where lr is ~1e-4 and a parameter of ~0.05 moves by ~1e-4; at
step 0 lr is 5e-7 and the update is lost under an f32 tolerance of the
parameters themselves (rtol 1e-4 / atol 1e-5)."""
import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import flatten, keystr

STEP = 1000
# max |update - reference update| <= UPDATE_TOL x max |reference update|,
# leaf by leaf (f32)
UPDATE_TOL = 1e-3


def at_step(args):
    """A train cell's arguments ``(params, m, v, step, *batch)`` at STEP."""
    return (*args[:3], torch.tensor(STEP, dtype=torch.int32), *args[4:])


def update_errors(args, out, ref_out):
    """{path: max |(new - old) - (ref_new - old)| / max |ref_new - old|}
    over params, m and v: ``args`` the step's arguments, ``out`` and
    ``ref_out`` two runs' outputs (DTensors whole, any device; f64
    differences).  Every leaf must have moved in ``ref_out``."""
    errs = {}
    for part in range(3):
        for path, o, g, w in zip(*flatten(args[part]),
                                 flatten(out[part])[1],
                                 flatten(ref_out[part])[1]):
            g, w = (x.full_tensor() if isinstance(x, DTensor) else x
                    for x in (g, w))
            o = o.detach().cpu().double()
            du = g.detach().cpu().double() - o
            dw = w.detach().cpu().double() - o
            scale = dw.abs().max().item()
            assert scale > 0, (part, keystr(path))   # the reference moved it
            errs[f"[{part}]{keystr(path)}"] = \
                (du - dw).abs().max().item() / scale
    return errs
