"""Neighbor sampling for minibatch GNN training (GraphSAGE-style fanout).

``minibatch_lg`` (Reddit-scale: 233k nodes / 115M edges, batch 1024,
fanout 15-10) needs a *real* sampler: the host path samples from CSR with
numpy (data pipeline) and gives the reference's arrays at the same seed;
the device path draws fixed-fanout neighbor indices with a
``torch.Generator`` (padded with self-loops where the degree is short —
standard with-replacement fanout sampling).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ...core.session import _resolve_device


def sample_block_host(indptr: np.ndarray, indices: np.ndarray,
                      seeds: np.ndarray, fanout: int,
                      rng: np.random.Generator
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One fanout hop on the host: returns (senders, receivers, next_seeds).
    senders/receivers index into the *global* node id space; receivers are
    the seeds, senders the sampled neighbors (message direction src->dst).
    """
    s_list, r_list = [], []
    for v in seeds:
        lo, hi = indptr[v], indptr[v + 1]
        deg = hi - lo
        if deg == 0:
            nbrs = np.full(fanout, v)
        else:
            nbrs = indices[lo + rng.integers(0, deg, fanout)]
        s_list.append(nbrs)
        r_list.append(np.full(fanout, v))
    senders = np.concatenate(s_list)
    receivers = np.concatenate(r_list)
    next_seeds = np.unique(np.concatenate([seeds, senders]))
    return senders, receivers, next_seeds


def sample_subgraph_host(indptr, indices, seeds, fanouts: List[int],
                         seed: int = 0):
    """Multi-hop sampled subgraph (outermost hop first, GraphSAGE order).
    Returns (node_ids, senders_local, receivers_local) with local
    renumbering; seeds occupy the first len(seeds) slots."""
    rng = np.random.default_rng(seed)
    seeds = np.asarray(seeds)
    all_s, all_r = [], []
    frontier = seeds
    for f in fanouts:
        s, r, frontier = sample_block_host(indptr, indices, frontier, f, rng)
        all_s.append(s)
        all_r.append(r)
    s_glob, r_glob = np.concatenate(all_s), np.concatenate(all_r)
    node_ids = np.unique(np.concatenate([seeds, s_glob, r_glob]))
    # seeds first, then the other nodes in ascending id order
    rest = node_ids[~np.isin(node_ids, seeds)]
    node_ids = np.concatenate([seeds, rest]).astype(np.int64)
    order = np.argsort(node_ids)
    by_id = node_ids[order]

    def local(v):                        # global ids -> slots in node_ids
        return order[np.searchsorted(by_id, v)].astype(np.int32)

    return node_ids, local(s_glob), local(r_glob)


def _fanout_from_draws(u, indptr, indices, seeds, fanout: int):
    """The arithmetic after the draw: ``u`` [B, fanout] non-negative
    integers pick ``u % deg``-th neighbors; zero-degree seeds fall back to
    self-loops."""
    lo = indptr[seeds]
    deg = indptr[seeds + 1] - lo
    off = torch.where(deg[:, None] > 0,
                      u % torch.clamp(deg[:, None], min=1), 0)
    # a zero-degree seed past the last edge would index out of range (the
    # reference's gather clamps); its pick is replaced by the seed below
    pos = torch.clamp((lo[:, None] + off).reshape(-1),
                      max=max(indices.numel() - 1, 0))
    nbr = indices[pos] if indices.numel() else pos
    senders = torch.where(torch.repeat_interleave(deg, fanout) > 0, nbr,
                          torch.repeat_interleave(seeds, fanout))
    receivers = torch.repeat_interleave(seeds, fanout)
    return senders.long(), receivers.long()


def sample_fanout_device(generator: torch.Generator, indptr, indices, seeds,
                         fanout: int, device=None):
    """Single-hop fanout sampling on the device (with replacement, CSR).

    indptr [N+1], indices [E]; seeds [B] -> (senders [B*fanout],
    receivers [B*fanout]), int64.  Zero-degree seeds fall back to
    self-loops.  Runs on ``device`` (``None``: the CUDA device, raising
    :class:`~repro_torch.errors.NoCudaDevice` without one), where
    ``generator`` must live.
    """
    dev = _resolve_device(device)
    indptr, indices, seeds = (torch.as_tensor(a, device=dev).long()
                              for a in (indptr, indices, seeds))
    u = torch.randint(0, 1 << 30, (seeds.shape[0], fanout),
                      generator=generator, device=dev)
    return _fanout_from_draws(u, indptr, indices, seeds, fanout)
