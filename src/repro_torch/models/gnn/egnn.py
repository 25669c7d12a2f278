"""EGNN (arXiv:2102.09844): E(n)-equivariant message passing without
spherical harmonics — scalar-distance MLP messages + coordinate updates.

Assigned config: 4 layers, d_hidden 64.  The reference stacks the layers
on a leading axis and scans them; here they are a list of dicts, and
:func:`params_from_jax` unstacks the reference's tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ...core.session import _resolve_device
from ...tree import from_numpy, tree_map
from .common import (GraphData, forces_of, graph_readout, mlp_apply,
                     mlp_init, segment_mp)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    dtype: Any = torch.float32

    def n_params(self) -> int:
        d = self.d_hidden
        per = (2 * d + 1) * d + d * d + d * d + d + (2 * d) * d + d * d
        return self.d_in * d + self.n_layers * per + d


def init_params(cfg: EGNNConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters at the reference's shapes and scales, drawn from
    ``generator`` on ``device`` (``None``: the CUDA device, raising
    :class:`~repro_torch.errors.NoCudaDevice` without one)."""
    dev = _resolve_device(device)
    d = cfg.d_hidden

    def mlp(sizes):
        return mlp_init(generator, sizes, cfg.dtype, dev)

    return dict(
        embed=mlp([cfg.d_in, d]),
        layers=[dict(phi_e=mlp([2 * d + 1, d, d]), phi_x=mlp([d, d, 1]),
                     phi_h=mlp([2 * d, d, d]))
                for _ in range(cfg.n_layers)],
        readout=mlp([d, d, 1]),
    )


def params_from_jax(cfg: EGNNConfig, tree, device=None) -> Params:
    """The reference's parameters (numpy arrays, layers stacked on axis 0)
    on ``device``, value for value."""
    p = from_numpy(tree, _resolve_device(device))
    p["layers"] = [tree_map(lambda x: x[i], p["layers"])
                   for i in range(cfg.n_layers)]
    return p


def _layer(p, h, x, g: GraphData):
    N = h.shape[0]
    src, dst = g.senders, g.receivers
    diff = x[src] - x[dst]                                   # [E, 3]
    d2 = torch.sum(diff * diff, dim=-1, keepdim=True)        # [E, 1]
    m = mlp_apply(p["phi_e"], torch.cat([h[src], h[dst], d2], -1),
                  final_act=True)                            # [E, d]
    m = m * g.edge_mask[:, None]
    # coordinate update (mean-normalized for stability)
    cw = mlp_apply(p["phi_x"], m)                            # [E, 1]
    xmsg = diff * cw * g.edge_mask[:, None]
    x = x + segment_mp(xmsg, dst, N, "mean")
    # feature update
    agg = segment_mp(m, dst, N)
    h = h + mlp_apply(p["phi_h"], torch.cat([h, agg], -1))
    return h, x


def forward(cfg: EGNNConfig, params: Params, feats, coords, g: GraphData
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (per-graph energy [G], node features [N, d], coords [N, 3])."""
    h = mlp_apply(params["embed"], feats)
    x = coords
    for p in params["layers"]:
        h, x = _layer(p, h, x, g)
    node_e = mlp_apply(params["readout"], h)                 # [N, 1]
    energy = graph_readout(node_e, g.graph_ids, g.n_graphs, g.node_mask)
    return energy[:, 0], h, x


def energy_and_forces(cfg: EGNNConfig, params: Params, feats, coords, g):
    """(total energy, forces [N, 3]); see :func:`common.forces_of` for
    when the forces can be differentiated again."""
    return forces_of(lambda c: forward(cfg, params, feats, c, g)[0], coords)
