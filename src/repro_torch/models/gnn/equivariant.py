"""NequIP (arXiv:2101.03164) and MACE (arXiv:2206.07697) on the e3 library.

* NequIP: per-layer equivariant convolution — neighbor irreps (x) SH of the
  edge direction through CG paths, radial-MLP path weights, segment-sum
  aggregation, per-l self-interaction, gated nonlinearity.
* MACE: per-layer density A (one-hop conv), then *higher-order* symmetric
  tensor-power contractions B up to correlation order nu=3 (the paper's
  ACE-style product basis), linear message, residual update, per-layer
  scalar readouts summed into the site energy.

Uniform channel width per l, as in the reference.  ``fused_agg`` is the
reference's bf16 path: one aggregation per output l over the
concatenated path messages, with the node features carried in bf16 and
the energy readout in f32; with ``shard_axes`` its messages and
aggregates carry the reference's mesh hints.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ...core.session import _resolve_device
from ...launch.constraints import hint
from ...tree import from_numpy, tree_map
from .common import (GraphData, forces_of, graph_readout, mlp_apply,
                     mlp_init, segment_sum, silu)
from .e3 import (bessel_rbf, cg_tensor, irreps_zeros, linear_mix,
                 self_tensor_product, spherical_harmonics)

Params = Dict[str, Any]


def _paths(l_max: int) -> List[Tuple[int, int, int]]:
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                out.append((l1, l2, l3))
    return out


def _paths_to(l_max: int) -> Dict[int, int]:
    """The number of paths into each output l."""
    per_l = {l: 0 for l in range(l_max + 1)}
    for (_, _, l3) in _paths(l_max):
        per_l[l3] += 1
    return per_l


@dataclasses.dataclass(frozen=True)
class EquivariantConfig:
    name: str = "nequip"
    arch: str = "nequip"          # "nequip" | "mace"
    n_layers: int = 5
    channels: int = 32            # d_hidden
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    correlation: int = 3          # MACE only
    n_species: int = 8
    dtype: Any = torch.float32
    # one bf16 aggregation per output l instead of one f32 aggregation
    # per path, node features carried in bf16
    fused_agg: bool = False
    # the fused path's distribution hints: edge messages and aggregated
    # node arrays sharded on these (flat) mesh dims
    # (``launch.constraints.hint``; nothing without a DTensor mesh)
    shard_axes: tuple = ()

    def n_params(self) -> int:
        C, P = self.channels, len(_paths(self.l_max))
        per_layer = P * self.n_rbf * C
        per_layer += (self.l_max + 1) * (C * P) * C          # mix
        per_layer += self.l_max * C * C + C * C              # gates
        if self.arch == "mace":
            per_layer += (self.correlation - 1) * (self.l_max + 1) * 4 * C * C
            per_layer += C * 1
        return self.n_species * C + self.n_layers * per_layer + C


def _conv_init(cfg: EquivariantConfig, generator: torch.Generator,
               device) -> Params:
    C = cfg.channels

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(cfg.dtype)

    p: Params = {}
    for (l1, l2, l3) in _paths(cfg.l_max):
        p[f"rad_{l1}{l2}{l3}"] = normal((cfg.n_rbf, C), 1 / np.sqrt(cfg.n_rbf))
    # per-l mixing weights: [C * n_paths_to_l, C]
    for l, n in _paths_to(cfg.l_max).items():
        p[f"mix_{l}"] = normal((C * n, C), 1 / np.sqrt(C * n))
    # gates for l > 0
    p["gate_w"] = normal((C, cfg.l_max * C), 1 / np.sqrt(C))
    return p


def _conv_apply(cfg: EquivariantConfig, p: Params, feats, coords,
                g: GraphData):
    """One equivariant convolution; returns aggregated {l: [N, C, m]}."""
    N = coords.shape[0]
    src, dst = g.senders, g.receivers
    vec = coords[src] - coords[dst]
    # safe norm (zero gradient at r=0; forces differentiate through this)
    r = torch.sqrt(torch.clamp(torch.sum(vec * vec, dim=-1), min=1e-18))
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff) * g.edge_mask[:, None]
    sh = spherical_harmonics(vec, cfg.l_max)
    mix = {l: p[f"mix_{l}"] for l in range(cfg.l_max + 1)}

    if cfg.fused_agg:
        # pure-bf16 message path (the layer's parameters arrive in bf16)
        bf = torch.bfloat16
        sh_b = {l: v.to(bf) for l, v in sh.items()}
        rbf_b = rbf.to(bf)
        per_l = {l: [] for l in range(cfg.l_max + 1)}
        for (l1, l2, l3) in _paths(cfg.l_max):
            w = rbf_b @ p[f"rad_{l1}{l2}{l3}"].to(bf)
            fa = feats[l1].to(bf)[src]
            cg = cg_tensor(l1, l2, l3, bf, fa.device)
            per_l[l3].append(torch.einsum("eci,ej,ijk,ec->eck",
                                          fa, sh_b[l2], cg, w))
        ax = cfg.shard_axes
        stacked = {}
        for l3, msgs in per_l.items():
            cat = torch.cat(msgs, dim=1)                      # [E, P*C, m]
            if ax:
                cat = hint(cat, ax, None, None)
            agg = segment_sum(cat, dst, N)
            if ax:
                agg = hint(agg, ax, None, None)               # node-sharded
            agg = agg.reshape(N, len(msgs), msgs[0].shape[1], 2 * l3 + 1)
            stacked[l3] = agg.permute(0, 2, 1, 3)             # [N, C, P, m]
        return linear_mix(stacked, mix)

    agg = {l: [] for l in range(cfg.l_max + 1)}
    for (l1, l2, l3) in _paths(cfg.l_max):
        w = rbf @ p[f"rad_{l1}{l2}{l3}"]                      # [E, C]
        fa = feats[l1][src]                                   # [E, C, m1]
        cg = cg_tensor(l1, l2, l3, cfg.dtype, fa.device)
        msg = torch.einsum("eci,ej,ijk,ec->eck", fa, sh[l2], cg, w)
        agg[l3].append(segment_sum(msg, dst, N))
    stacked = {l: torch.stack(v, dim=2) for l, v in agg.items()}  # [N,C,P,m]
    return linear_mix(stacked, mix)


def _gate(cfg: EquivariantConfig, p: Params, feats):
    """Equivariant gated nonlinearity: silu on scalars, sigmoid(scalar)
    gates on the norms of l>0 features."""
    scalars = feats[0][..., 0]                                # [N, C]
    out = {0: silu(scalars)[..., None]}
    if cfg.l_max > 0:
        gates = torch.sigmoid(scalars @ p["gate_w"])          # [N, l_max*C]
        C = cfg.channels
        for l in range(1, cfg.l_max + 1):
            gl = gates[:, (l - 1) * C: l * C]
            out[l] = feats[l] * gl[..., None]
    return out


# ---------------------------------------------------------------------------

def init_params(cfg: EquivariantConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters at the reference's shapes and scales, drawn from
    ``generator`` on ``device`` (``None``: the CUDA device, raising
    :class:`~repro_torch.errors.NoCudaDevice` without one)."""
    dev = _resolve_device(device)
    C = cfg.channels
    layers = []
    for _ in range(cfg.n_layers):
        lp = _conv_init(cfg, generator, dev)
        if cfg.arch == "mace":
            for nu in range(2, cfg.correlation + 1):
                for l, n in _paths_to(cfg.l_max).items():
                    lp[f"bmix_{nu}_{l}"] = (
                        torch.randn((C * n, C), generator=generator,
                                    device=dev) / np.sqrt(C * n)
                    ).to(cfg.dtype)
            lp["readout"] = (torch.randn((C, 1), generator=generator,
                                         device=dev) / np.sqrt(C)
                             ).to(cfg.dtype)
        layers.append(lp)
    return dict(
        embed=(torch.randn((cfg.n_species, C), generator=generator,
                           device=dev) * 0.5).to(cfg.dtype),
        layers=layers,
        readout=mlp_init(generator, [C, C, 1], cfg.dtype, dev),
    )


def params_from_jax(cfg: EquivariantConfig, tree, device=None) -> Params:
    """The reference's parameters (numpy arrays) on ``device``, value for
    value."""
    return from_numpy(tree, _resolve_device(device))


def forward(cfg: EquivariantConfig, params: Params, species, coords,
            g: GraphData):
    """species [N] int, coords [N, 3] -> per-graph energy [G]."""
    N = coords.shape[0]
    C = cfg.channels
    # the fused path carries node features in bf16; the energy readout
    # accumulates in f32
    fdtype = torch.bfloat16 if cfg.fused_agg else cfg.dtype
    feats = irreps_zeros(N, C, cfg.l_max, fdtype, coords.device)
    # cast the (small) table before the gather
    feats[0] = params["embed"].to(fdtype)[species][..., None]

    energy_acc = torch.zeros((N, 1), dtype=cfg.dtype, device=coords.device)
    for lp in params["layers"]:
        if cfg.fused_agg:
            lp = tree_map(lambda x: x.to(fdtype), lp)
        conv = _conv_apply(cfg, lp, feats, coords, g)
        if cfg.arch == "mace":
            # higher-order ACE product basis: B_nu = sym. powers of A
            A = conv
            B = A
            msg = {l: A[l] for l in range(cfg.l_max + 1)}
            for nu in range(2, cfg.correlation + 1):
                prod = self_tensor_product(B, A, cfg.l_max)   # [N,C,P,m]
                B = linear_mix(prod, {l: lp[f"bmix_{nu}_{l}"]
                                      for l in range(cfg.l_max + 1)})
                msg = {l: msg[l] + B[l] for l in msg}
            feats = {l: feats[l] + msg[l] for l in feats}
            feats = _gate(cfg, lp, feats)
            # JAX promotes the (bf16 on the fused path) readout to f32
            energy_acc = energy_acc + \
                (feats[0][..., 0].to(cfg.dtype) @ lp["readout"].to(cfg.dtype))
        else:
            feats = {l: feats[l] + conv[l] for l in feats}
            feats = _gate(cfg, lp, feats)
        # keep the carried node arrays in the low-precision format
        feats = {l: v.to(fdtype) for l, v in feats.items()}

    node_e = mlp_apply(params["readout"],
                       feats[0][..., 0].to(cfg.dtype))        # [N, 1]
    node_e = node_e + energy_acc
    energy = graph_readout(node_e, g.graph_ids, g.n_graphs, g.node_mask)
    return energy[:, 0]


def energy_and_forces(cfg: EquivariantConfig, params: Params, species,
                      coords, g: GraphData):
    """(total energy, forces [N, 3]); see :func:`common.forces_of` for
    when the forces can be differentiated again."""
    return forces_of(lambda c: forward(cfg, params, species, c, g), coords)
