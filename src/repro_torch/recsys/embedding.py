"""Embedding substrate for recsys: lookups and ragged bags built from a
gather and the segment ops of the GNN substrate (``index_add`` and
``scatter_reduce``), as the reference builds them from ``jnp.take`` and
``jax.ops.segment_*``.

A bag here is named by a *segment id per index* (``offsets[i]`` is the
bag of ``ids[i]``), not by ``torch.nn.EmbeddingBag``'s start offsets.
Empty bags give 0 for sum and mean, and ``-inf`` for max.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..launch.constraints import replicated
from ..models.gnn.common import segment_max, segment_sum


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain lookup: table [V, d], ids [...] -> [..., d].  A DTensor table
    is gathered whole and read through the ``embedding`` op, as the LM's
    is (``transformer._embed``): torch 2.11's DTensor fails to index a
    row-sharded table on a 3-D mesh and to accumulate the gather's
    backward (``index_put``).  A departure from GSPMD, labelled
    ``vocab_gather``."""
    if isinstance(table, DTensor):
        return F.embedding(ids, replicated(table, "vocab_gather"))
    return table[ids]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, n_bags: int, mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EmbeddingBag(sum|mean|max) over ragged bags.

    ids [nnz] flat indices; offsets [nnz] bag id per index (segment ids);
    returns [n_bags, d], with per-sample ``weights`` [nnz] if given.
    """
    vecs = table[ids]                                    # [nnz, d]
    if weights is not None:
        vecs = vecs * weights[:, None]
    offsets = offsets.long()
    if mode == "sum":
        return segment_sum(vecs, offsets, n_bags)
    if mode == "mean":
        s = segment_sum(vecs, offsets, n_bags)
        cnt = segment_sum(torch.ones(ids.shape, dtype=torch.float32,
                                     device=ids.device), offsets, n_bags)
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if mode == "max":
        return segment_max(vecs, offsets, n_bags)
    raise ValueError(mode)


def onehot_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather-free lookup: onehot(ids) @ table.  The reference uses it on
    its sharded path, where the table's rows are split across devices and
    the product becomes a partial sum and an all-reduce; on one device it
    equals :func:`embedding_lookup`."""
    oh = F.one_hot(ids.long(), table.shape[0]).to(table.dtype)
    return oh @ table
