"""The plain reference: hop distances by breadth-first search, in plain
PyTorch, over the graph the benchmark made and the deltas it sent.

It imports nothing of the program and takes nothing the program made: the
edge lists, the deltas and the read requests are the benchmark's own.  The
graph is a dense ``[n, n]`` matrix of edge counts (a delta's insertion adds
one, its deletion takes one away), and a level of the search is one
product of the frontier with it, ``(F @ A) > 0``: on the card in float16,
whose sums of small counts stay exact, on the CPU in float32.  Sources go
in blocks of rows, so that the search fits beside nothing else, and each
block keeps only the distances its reads ask for.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: sources searched at once
BLOCK = 4096

#: a delta as the reference takes it: ``(inserted edges, deleted edges)``
Edges = Sequence[Tuple[int, int]]


def adjacency(n: int, src, dst, device) -> torch.Tensor:
    """The dense [n, n] matrix of edge counts u -> v."""
    cuda = torch.device(device).type == "cuda"
    dtype = torch.float16 if cuda else torch.float32
    a = torch.zeros((n, n), dtype=dtype, device=device)
    _count(a, src, dst, 1.0)
    return a


def _count(a: torch.Tensor, src, dst, sign: float) -> None:
    src, dst = np.asarray(src, dtype=np.int64), np.asarray(dst,
                                                          dtype=np.int64)
    if len(src):
        a.index_put_((torch.as_tensor(src, device=a.device),
                      torch.as_tensor(dst, device=a.device)),
                     torch.full((len(src),), sign, dtype=a.dtype,
                                device=a.device), accumulate=True)


def apply_delta(a: torch.Tensor, inserts: Edges, deletes: Edges) -> None:
    for edges, sign in ((inserts, 1.0), (deletes, -1.0)):
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        _count(a, e[:, 0], e[:, 1], sign)


def hop_distances(a: torch.Tensor, sources: Sequence[int],
                  max_depth: Optional[int] = None) -> torch.Tensor:
    """[len(sources), n] int32 hop distances from each source, -1 where
    unreachable.  ``max_depth`` stops the search after that many levels
    (the control: a fixpoint cut short)."""
    n = a.shape[0]
    d = torch.full((len(sources), n), -1, dtype=torch.int32,
                   device=a.device)
    rows = torch.as_tensor(np.asarray(sources, dtype=np.int64),
                           device=a.device)
    d[torch.arange(len(rows), device=a.device), rows] = 0
    seen = d >= 0
    frontier = seen.to(a.dtype)
    level = 0
    while max_depth is None or level < max_depth:
        level += 1
        new = ((frontier @ a) > 0) & ~seen
        if not bool(new.any()):
            break
        d[new] = level
        seen |= new
        frontier = new.to(a.dtype)
    return d


def answer(kind: str, d: int, bound: int):
    """What a read of ``kind`` answers when the hop distance is ``d`` (-1:
    unreachable): reach a bool, dist the distance or None, bounded whether
    ``d <= bound``."""
    if kind == "reach":
        return d >= 0
    if kind == "dist":
        return d if d >= 0 else None
    return 0 <= d <= bound


def distances(n: int, src, dst, deltas: List[Tuple[Edges, Edges]], reads,
              versions: Sequence[int], device,
              max_depth: Optional[int] = None) -> List[Optional[int]]:
    """The hop distance of each read's pair at its version, -1 where
    unreachable: version ``j`` is the graph after the first ``j`` of
    ``deltas``, each ``(inserted edges, deleted edges)``.  ``reads`` have
    ``s`` and ``t``.  A version outside ``[0, len(deltas)]`` gives
    None."""
    by_version: Dict[int, List[int]] = {}
    out: List[Optional[int]] = [None] * len(reads)
    for i, v in enumerate(versions):
        if v is not None and 0 <= v <= len(deltas):
            by_version.setdefault(v, []).append(i)
    a = adjacency(n, src, dst, device)
    applied = 0
    for v in sorted(by_version):
        while applied < v:
            apply_delta(a, *deltas[applied])
            applied += 1
        idx = by_version[v]
        srcs = sorted({reads[i].s for i in idx})
        for lo in range(0, len(srcs), BLOCK):
            block = srcs[lo:lo + BLOCK]
            row = {s: j for j, s in enumerate(block)}
            mine = [i for i in idx if reads[i].s in row]
            d = hop_distances(a, block, max_depth)
            at = d[torch.as_tensor([row[reads[i].s] for i in mine],
                                   device=a.device),
                   torch.as_tensor([reads[i].t for i in mine],
                                   device=a.device)].cpu().tolist()
            for i, x in zip(mine, at):
                out[i] = int(x)
            del d
    del a
    return out
