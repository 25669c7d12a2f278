"""Device meshes: the port's counterpart of ``repro.launch.mesh``.

Functions, not module constants: importing this module touches no device
and no process group.  :data:`PRODUCTION` describes the two production
meshes (shape and dim names) without any process group; the dry run
reads it.  :func:`make_production_mesh` and :func:`make_host_mesh` build
``DeviceMesh`` objects over an initialized ``torch.distributed`` group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's shape and dim names, without devices."""
    shape: Tuple[int, ...]
    names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def label(self) -> str:
        return "x".join(str(s) for s in self.shape)


def shard_shape(shape, spec, mesh: MeshShape):
    """A leaf's shape on one device of ``mesh`` under ``spec``."""
    size = dict(zip(mesh.names, mesh.shape))
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        out[dim] = -(-out[dim] // math.prod(size[n] for n in names))
    return tuple(out)


# 16x16 (256 chips, one pod) and 2x16x16 (512 chips, two pods).  The
# "pod" dim carries only data-parallel traffic (gradient all-reduce
# between pods); "model" carries the tensor- and expert-parallel
# collectives.
PRODUCTION = {False: MeshShape((16, 16), ("data", "model")),
              True: MeshShape((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the default process group, which must
    hold 256 ranks (512 with ``multi_pod``)."""
    want = PRODUCTION[multi_pod]
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != want.size:
        raise ValueError(f"the {want.label()} production mesh needs a "
                         f"process group of {want.size} ranks; the default "
                         f"group holds {world}")
    return init_device_mesh(device_type, want.shape,
                            mesh_dim_names=want.names)


def make_host_mesh(k: int, model: int = 1, device_type: str = "cuda"):
    """A ``(k // model, model)`` mesh named ``("data", "model")`` over the
    default process group of ``k`` ranks (gloo on the CPU in the tests, a
    one-rank NCCL group on the card).  Unlike the reference's 1-D host
    mesh it has both dims of the single-pod production mesh, so a cell's
    ``arg_specs`` place on it as they are."""
    if k % model:
        raise ValueError(f"model dim {model} does not divide {k} ranks")
    return init_device_mesh(device_type, (k // model, model),
                            mesh_dim_names=("data", "model"))
