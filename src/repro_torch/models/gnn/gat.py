"""GAT (arXiv:1710.10903): SDDMM edge scores -> segment softmax -> SpMM.

gat-cora assigned config: 2 layers, d_hidden 8, 8 heads, attn aggregator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...core.session import _resolve_device
from ...tree import from_numpy
from .common import GraphData, edge_softmax, segment_mp

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    dtype: Any = torch.float32

    def n_params(self) -> int:
        p = self.d_in * self.d_hidden * self.n_heads + 2 * self.n_heads * self.d_hidden
        p += (self.d_hidden * self.n_heads) * self.n_classes * 1 + 2 * self.n_classes
        return p


def init_params(cfg: GATConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters at the reference's shapes and scales, drawn from
    ``generator`` on ``device`` (``None``: the CUDA device, raising
    :class:`~repro_torch.errors.NoCudaDevice` without one)."""
    dev = _resolve_device(device)
    h, dh = cfg.n_heads, cfg.d_hidden

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(cfg.dtype)

    return dict(
        w1=normal((cfg.d_in, h * dh), 1 / np.sqrt(cfg.d_in)),
        a1_src=normal((h, dh), 0.1),
        a1_dst=normal((h, dh), 0.1),
        w2=normal((h * dh, cfg.n_classes), 1 / np.sqrt(h * dh)),
        a2_src=normal((1, cfg.n_classes), 0.1),
        a2_dst=normal((1, cfg.n_classes), 0.1),
    )


def params_from_jax(cfg: GATConfig, tree, device=None) -> Params:
    """The reference's parameters (numpy arrays) on ``device``, value for
    value."""
    return from_numpy(tree, _resolve_device(device))


def _gat_layer(x, g: GraphData, w, a_src, a_dst, n_heads):
    """x [N, d_in] -> [N, H, dh]."""
    N = x.shape[0]
    h = (x @ w).reshape(N, n_heads, -1)                       # [N, H, dh]
    s_src = torch.einsum("nhd,hd->nh", h, a_src)
    s_dst = torch.einsum("nhd,hd->nh", h, a_dst)
    scores = F.leaky_relu(s_src[g.senders] + s_dst[g.receivers], 0.2)
    alpha = edge_softmax(scores, g.receivers, g.edge_mask, N)  # [E, H]
    msgs = h[g.senders] * alpha[..., None]
    return segment_mp(msgs.reshape(msgs.shape[0], -1), g.receivers, N
                      ).reshape(N, n_heads, -1)


def forward(cfg: GATConfig, params: Params, x, g: GraphData) -> torch.Tensor:
    """Node classification logits [N, n_classes]."""
    h = _gat_layer(x, g, params["w1"], params["a1_src"], params["a1_dst"],
                   cfg.n_heads)
    h = F.elu(h.reshape(x.shape[0], -1))
    out = _gat_layer(h, g, params["w2"], params["a2_src"], params["a2_dst"], 1)
    return out[:, 0, :]


def loss(cfg: GATConfig, params: Params, x, g: GraphData, labels,
         label_mask) -> torch.Tensor:
    logits = forward(cfg, params, x, g).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[:, None].long(), dim=-1)[:, 0]
    nll = (logz - gold) * label_mask
    return torch.sum(nll) / torch.clamp(torch.sum(label_mask), min=1.0)
