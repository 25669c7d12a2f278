"""Partition specs and sharding hints usable inside model code: the
port's counterpart of ``repro.launch.constraints``.

:class:`P` is a partition spec: one entry per tensor dim, each ``None``
(not sharded), a mesh dim name or a tuple of names.  :func:`placements`
turns it into DTensor placements over a ``DeviceMesh``, one per mesh dim.
:func:`hint` redistributes a DTensor to a spec when the tensor's mesh
names every dim the spec names, and returns anything else unchanged: a
plain tensor (single-device runs and the CPU tests run the same model
code with no mesh) or a DTensor on a mesh without those dims.  The
decision is made by type and by dim names; nothing is caught.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

from torch.distributed.tensor import DTensor, Replicate, Shard

from .collective_stats import departure

Entry = Union[None, str, Tuple[str, ...]]


class P:
    """A partition spec, ``jax.sharding.PartitionSpec``'s counterpart:
    ``P(None, "data", ("pod", "data"))``.  It is not a tuple, so the trees
    of :mod:`repro_torch.tree` hold it as a leaf."""

    __slots__ = ("parts",)

    def __init__(self, *parts: Entry):
        # as JAX normalizes them: ("data",) is "data", () is None
        self.parts = tuple(
            (p[0] if len(p) == 1 else (tuple(p) or None))
            if isinstance(p, (tuple, list)) else p for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"P{self.parts!r}"

    def names(self) -> Tuple[str, ...]:
        """Every mesh dim name the spec uses, in order."""
        out = []
        for entry in self.parts:
            if entry is not None:
                out.extend((entry,) if isinstance(entry, str) else entry)
        return tuple(out)


def _entry_names(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: P, mesh_dim_names: Sequence[str]) -> list:
    """DTensor placements of ``spec`` over a mesh whose dims are named
    ``mesh_dim_names`` (a ``DeviceMesh`` is taken too): a mesh dim named in
    the entry for tensor dim ``i`` gives ``Shard(i)``, every other mesh dim
    ``Replicate()``.  A tensor dim split over several mesh dims, e.g.
    ``("pod", "data")``, is sharded in mesh-dim order, which is the
    major-to-minor order JAX uses; an entry that names them in another
    order, a name the mesh lacks, or a name used twice raises
    ``ValueError``."""
    names = tuple(getattr(mesh_dim_names, "mesh_dim_names", mesh_dim_names)
                  or ())
    out = [Replicate() for _ in names]
    seen = set()
    for dim, entry in enumerate(spec):
        used = _entry_names(entry)
        for name in used:
            if name not in names:
                raise ValueError(f"{spec} names mesh dim {name!r}; the mesh "
                                 f"has {names}")
            if name in seen:
                raise ValueError(f"{spec} uses mesh dim {name!r} twice")
            seen.add(name)
            out[names.index(name)] = Shard(dim)
        order = [names.index(n) for n in used]
        if order != sorted(order):
            raise ValueError(f"{spec}: entry {entry} is not in the mesh's "
                             f"dim order {names}")
    return out


def hint(x, *spec_parts: Entry):
    """``x`` redistributed to ``P(*spec_parts)`` (padded with ``None`` to
    its rank) when it is a DTensor whose mesh names every dim the spec
    names; otherwise ``x`` unchanged."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    spec = P(*spec_parts, *([None] * (x.ndim - len(spec_parts))))
    if not set(spec.names()) <= set(mesh.mesh_dim_names or ()):
        return x
    return x.redistribute(mesh, placements(spec, mesh))



def batch_sharded(x, label: str = "batch_sharded"):
    """``x`` with every tensor dim but the first (the batch) replicated,
    when ``x`` is a DTensor; otherwise ``x`` unchanged.  DTensor cannot
    reshard a view by itself as GSPMD does (it refuses to split a sharded
    dim into heads that its shard count does not divide), so attention
    takes q, k and v in this layout: the one the reference's ``dp_axes``
    hints pin.  A departure from GSPMD: its collectives are labelled
    ``label`` (``collective_stats.departure``)."""
    if not isinstance(x, DTensor):
        return x
    keep = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]
    return departure(label, lambda: x.redistribute(x.device_mesh, keep))


def replicated(x, label: str):
    """``x`` whole on every rank when it is a DTensor; otherwise ``x``
    unchanged.  A departure from GSPMD: its collectives are labelled
    ``label``."""
    if not isinstance(x, DTensor):
        return x
    whole = [Replicate()] * x.device_mesh.ndim
    if list(x.placements) == whole:
        return x
    return departure(label, lambda: x.redistribute(x.device_mesh, whole))
