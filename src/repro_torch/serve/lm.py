"""Batched serving loop for the LM family: prefill and greedy decode with
a KV cache, on the card.

Requests are served in fixed-size batches.  The semantics are the
reference's (``repro.serve.lm``), kept as they are: prompts are
left-padded with token 0 and the padding is attended to, every row's
positions start at 0, the prefill steps ``decode_step`` over the prompt
one position at a time, each batch gets a fresh cache, and the greedy
choice is the first maximum of the logits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.session import _resolve_device
from ..models import transformer as T
from ..tree import tree_map


@dataclasses.dataclass
class Request:
    prompt: np.ndarray             # [S] int32
    max_new_tokens: int = 16
    generated: Optional[List[int]] = None


def _no_mark(phase: str) -> None:
    pass


class ServeEngine:
    """Fixed-batch decoder over ``model`` (the parameters of
    :mod:`repro_torch.models.transformer`), on ``device`` (``None``: the
    CUDA device, raising :class:`~repro_torch.errors.NoCudaDevice`
    without one; the parameters are moved there)."""

    def __init__(self, cfg: T.LMConfig, model, batch: int, max_len: int,
                 device=None):
        self.device = _resolve_device(device)
        self.cfg = cfg
        self.params = tree_map(lambda x: x.to(self.device), model)
        self.batch, self.max_len = batch, max_len

    def generate(self, requests: List[Request],
                 mark: Callable[[str], None] = _no_mark) -> List[Request]:
        """Serve a queue of requests in fixed-size batches.

        ``mark(phase)`` is called as each batch's ``"prefill"`` and
        ``"decode"`` begin and once after its last step (``"end"``); a
        caller can synchronize and read a clock there."""
        out: List[Request] = []
        with torch.inference_mode():
            for i in range(0, len(requests), self.batch):
                out.extend(self._serve_batch(requests[i:i + self.batch],
                                             mark))
        return out

    def _serve_batch(self, reqs: List[Request],
                     mark: Callable[[str], None]) -> List[Request]:
        B, dev, cfg = self.batch, self.device, self.cfg
        S = max(len(r.prompt) for r in reqs)
        prompts = np.zeros((B, S), np.int32)
        for j, r in enumerate(reqs):
            prompts[j, S - len(r.prompt):] = r.prompt      # left-pad
        prompts = torch.from_numpy(prompts).to(dev)
        cache = T.init_cache(cfg, B, self.max_len, device=dev)
        mark("prefill")
        logits = None
        for i in range(S):
            logits, cache = T.decode_step(
                cfg, self.params, cache, prompts[:, i],
                torch.full((B,), i, dtype=torch.long, device=dev))
        tok = torch.argmax(logits, dim=-1)
        mark("decode")
        n_new = max(r.max_new_tokens for r in reqs)
        gen = [tok]
        for i in range(n_new - 1):
            logits, cache = T.decode_step(
                cfg, self.params, cache, tok,
                torch.full((B,), S + i, dtype=torch.long, device=dev))
            tok = torch.argmax(logits, dim=-1)
            gen.append(tok)
        gen_np = torch.stack(gen, dim=1).cpu().numpy()      # [B, n_new]
        mark("end")
        for j, r in enumerate(reqs):
            r.generated = gen_np[j, : r.max_new_tokens].tolist()
        return reqs
