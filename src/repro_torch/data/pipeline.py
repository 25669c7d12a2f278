"""Deterministic, step-indexed data pipelines (replayable after restart).

Every loader is a pure function of (seed, step), array for array the
reference's (``repro.data.pipeline``), so checkpoint-restart recovery
replays the identical stream.  Batches come back as tensors on the
stream's ``device`` (``None``: the CUDA device, raising
:class:`~repro_torch.errors.NoCudaDevice` without one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..core.session import _resolve_device


def _on(device, **arrays) -> Dict[str, torch.Tensor]:
    dev = _resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """Synthetic LM token batches (Zipf-ish unigram + ngram structure so the
    loss is learnable, not pure noise)."""
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    device: Any = None

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        base = rng.zipf(1.5, size=(self.batch, self.seq_len + 1))
        toks = np.minimum(base - 1, self.vocab - 1).astype(np.int32)
        # inject copy structure: second half repeats first half shifted
        half = (self.seq_len + 1) // 2
        toks[:, half:2 * half] = toks[:, :half]
        return _on(self.device, tokens=np.ascontiguousarray(toks[:, :-1]),
                   targets=np.ascontiguousarray(toks[:, 1:]))


@dataclasses.dataclass(frozen=True)
class MaskedItemStream:
    """BERT4Rec Cloze batches."""
    n_items: int
    batch: int
    seq_len: int
    mask_token: int = 1
    mask_rate: float = 0.15
    seed: int = 0
    device: Any = None

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        items = rng.integers(2, self.n_items, (self.batch, self.seq_len)
                             ).astype(np.int32)
        mask = rng.random((self.batch, self.seq_len)) < self.mask_rate
        mask[:, 0] |= ~mask.any(axis=1)          # ensure >=1 mask per row
        masked = np.where(mask, self.mask_token, items).astype(np.int32)
        return _on(self.device, items=masked, targets=items, mask=mask)


@dataclasses.dataclass(frozen=True)
class GraphEpochStream:
    """Minibatch GNN training: step-indexed seed-node batches."""
    n_nodes: int
    batch_nodes: int
    seed: int = 0
    device: Any = None

    def seeds_at(self, step: int) -> torch.Tensor:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        seeds = rng.choice(self.n_nodes, size=self.batch_nodes, replace=False)
        return _on(self.device, seeds=seeds)["seeds"]
