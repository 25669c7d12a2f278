"""One cell's step run once on a production mesh that nothing backs: the
costs the dry run records in place of the reference's compiled program.

The reference compiles each cell's SPMD program and reads XLA's memory
and cost analyses.  PyTorch compiles no such program: DTensor runs the
step eagerly, one op at a time, choosing each op's local work and
collectives as it goes.  So the step is run, once, by rank 0 of a
one-process *fake* process group of 256 or 512 ranks (collectives return
at once and move nothing), on the ``DeviceMesh`` that
:func:`repro_torch.launch.mesh.make_production_mesh` builds over it.  The
arguments are DTensors placed by the cell's ``arg_specs``, whose local
shards are ``meta`` tensors (rank 0's shard: a sharded dim split by
ceiling division, as DTensor and XLA split it): every op computes
shapes only, nothing is
allocated, and no GPU is needed.  ``FakeTensorMode`` would do the same,
but DTensor's cost model for strided shards reads an index tensor's
values, which a fake tensor does not have, so the shards are plain meta
tensors.

What is counted, all for rank 0 and all in rank 0's local ops (what
DTensor runs on the shards, not the DTensor-level ops):

  * FLOPs, by ``torch.utils.flop_counter``'s registry of counting rules
    (the rules ``FlopCounterMode`` applies);
  * bytes: each local op's tensor operands and results, each tensor once,
    views excepted (they move nothing);
  * peak memory, by ``torch.distributed._tools.mem_tracker.MemTracker``,
    the arguments' shards included;
  * the collectives, by :func:`.collective_stats.record_step_collectives`,
    with those of the departures from GSPMD labelled apart.

Ops that DTensor runs under its own fake mode to propagate shardings are
not the device's work and are not counted.  These are eager DTensor
counts, not XLA's: where DTensor's rules replicate what GSPMD would keep
sharded, the counts say so.

``torch.testing._internal.distributed.fake_pg`` and
``torch.distributed._tools.mem_tracker`` are private to PyTorch and
change between versions; :func:`_private` imports both and fails with a
clear error where either is missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..tree import flatten, keystr, leaves, tree_map_with_path
from .collective_stats import Collective, _tensors, record_step_collectives
from .constraints import placements
from .mesh import PRODUCTION, MeshShape, make_production_mesh, shard_shape

META = torch.device("meta")
# ops that write or move no data of their own
_NO_BYTES = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_strided.default,
             torch.ops._c10d_functional.wait_tensor.default}


def _private():
    """``(FakeStore, MemTracker, active_fake_mode)`` from PyTorch's private
    modules, or a RuntimeError that names what this torch lacks."""
    try:
        from torch._guards import active_fake_mode
        from torch.distributed._tools.mem_tracker import MemTracker
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the compiled dry run needs PyTorch's fake process group "
            f"(torch.testing._internal.distributed.fake_pg), MemTracker "
            f"(torch.distributed._tools.mem_tracker) and "
            f"torch._guards.active_fake_mode; torch {torch.__version__} "
            f"lacks one: {e}") from e
    return FakeStore, MemTracker, active_fake_mode


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A one-process ``fake`` default process group of ``world_size``
    ranks, this process rank 0; destroyed on exit.  It refuses to replace
    a group that is already initialized."""
    FakeStore, _, _ = _private()
    if dist.is_initialized():
        raise RuntimeError("the compiled dry run makes its own fake process "
                           "group; one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def place_meta(tree, specs, mesh):
    """``tree``'s abstract (meta) leaves as DTensors on ``mesh`` placed by
    the ``P`` at the same path of ``specs``, each with rank 0's shard as a
    meta local tensor."""
    paths, parts = flatten(specs)
    table = {keystr(p): s for p, s in zip(paths, parts)}
    dims = MeshShape(tuple(mesh.shape), tuple(mesh.mesh_dim_names))

    def place(path, x):
        spec = table[keystr(path)]
        loc = torch.empty(shard_shape(x.shape, spec, dims), dtype=x.dtype,
                          device=META)
        return DTensor.from_local(loc, mesh, placements(spec, mesh),
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    return tree_map_with_path(place, tree)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _tensor_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


class _LocalCounter(TorchDispatchMode):
    """FLOPs and bytes of the local ops: a DTensor op returns
    ``NotImplemented`` so that DTensor runs first and its local ops come
    back here; ops under DTensor's propagation fake mode are skipped."""

    def __init__(self, active_fake_mode):
        super().__init__()
        self.active_fake_mode = active_fake_mode
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.active_fake_mode() is None:
            rule = flop_registry.get(func._overloadpacket)
            if rule is not None:
                self.flops += rule(*args, **kwargs, out_val=out)
            if not func.is_view and func not in _NO_BYTES:
                ins = _tensors((args, tuple(kwargs.values())))
                outs = [t for t in _tensors(out)
                        if not any(t is i for i in ins)]
                self.bytes += _tensor_bytes(ins) + _tensor_bytes(outs)
        return out


@dataclasses.dataclass
class StepCosts:
    """What one run of a step costs rank 0 (bytes are rank 0's)."""
    flops: int
    bytes: int
    arg_bytes: int         # the arguments' local shards
    peak_bytes: int        # MemTracker's peak, the arguments included
    out_bytes: int         # the results' local shards
    collectives: List[Collective]

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.arg_bytes


def run_step(step_fn, args) -> StepCosts:
    """Run ``step_fn(*args)`` once on DTensor arguments with meta shards
    (:func:`place_meta`) and count it."""
    _, MemTracker, active_fake_mode = _private()
    shards = [_local(x) for x in leaves(args)]
    arg_bytes = _tensor_bytes(shards)
    tracker = MemTracker()
    tracker.track_external(*shards)
    counter = _LocalCounter(active_fake_mode)
    with tracker, counter, record_step_collectives() as record, \
            implicit_replication():
        out = step_fn(*args)
    peak = tracker.get_tracker_snapshot("peak").get(META, {}).get("Total", 0)
    return StepCosts(flops=int(counter.flops), bytes=int(counter.bytes),
                     arg_bytes=arg_bytes, peak_bytes=int(peak),
                     out_bytes=_tensor_bytes(_local(x) for x in leaves(out)),
                     collectives=record)


def cell_costs(prog, multi_pod: bool) -> StepCosts:
    """A cell program's step run once on the production mesh of a fake
    process group (256 ranks, 512 with ``multi_pod``).  The mesh is
    typed "cuda", as on the cluster (DTensor picks some collectives by
    the device type), and touches no device."""
    with fake_process_group(PRODUCTION[multi_pod].size):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
        return run_step(prog.step_fn,
                        place_meta(prog.abstract_args, prog.arg_specs, mesh))
