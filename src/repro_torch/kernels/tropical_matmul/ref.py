"""Plain PyTorch versions of the (min, +) semiring product, of evalDG's
fixpoint over it (the oracle of the answer by levels), and of evalDG's
answer by levels, on W as it is and on W's row lists."""
from typing import Optional, Tuple

import torch

INF = 1 << 29

#: int32 elements of the [rows, K, N] broadcast per chunk of rows (64 MiB)
CHUNK_ELEMENTS = 1 << 24


def min_plus_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                        init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a [M, K], b [K, N] int32 -> min(init, min_k (a + b), INF) [M, N]
    int32, a fresh tensor (``init`` [M, N] is read, never written; without
    it the floor is INF).

    Rows go as many at a time as keep the [rows, K, N] broadcast within
    ``CHUNK_ELEMENTS``, and at least one.  K = 0 gives the floor (min over
    nothing)."""
    M, K = a.shape
    N = b.shape[1]
    if init is None:
        out = torch.full((M, N), INF, dtype=torch.int32, device=a.device)
    else:
        out = init.clamp_max(INF)
    if K == 0:
        return out
    rows = max(1, CHUNK_ELEMENTS // max(1, K * N))
    for r0 in range(0, M, rows):
        part = out[r0:r0 + rows]
        torch.minimum(part, torch.amin(a[r0:r0 + rows, :, None]
                                       + b[None, :, :], dim=1), out=part)
    return out


def min_plus_fixpoint_ref(d0: torch.Tensor, W: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """d0 [B], W [B, B] int32 in [0, INF] -> (d, steps): d := min(d, d
    (min, +) W, INF) until a step changes nothing, one vector-matrix
    product a step and one host sync a step; steps (a 0-d int32 tensor on
    d0's device) counts the products, the last one included (0 when d0 is
    all INF).

    The plain Bellman-Ford iterate, as the reference's evalDG runs it: no
    kernel computes it, and it is the oracle against which
    :func:`min_plus_settle_ref` is defined and tested (its answer is the
    least d of this fixpoint over the targets)."""
    d = d0.clamp_max(INF)
    steps = 0
    if bool((d < INF).any()):
        while True:
            nxt = min_plus_matmul_ref(d[None, :], W, d[None, :])[0]
            steps += 1
            if torch.equal(nxt, d):
                break
            d = nxt
    return d, torch.tensor(steps, dtype=torch.int32, device=d0.device)


def min_plus_settle_ref(d0: torch.Tensor, W: torch.Tensor, tgt: torch.Tensor,
                        bound: Optional[int] = None) -> torch.Tensor:
    """d0 [B], W [B, B] int32 in [0, INF], tgt [B] bool -> int32 [answer,
    levels, rows] on d0's device: the least d over ``tgt`` of the fixpoint
    that :func:`min_plus_fixpoint_ref` computes, INF if it is none or above
    ``bound`` (None: no bound), found in Dijkstra's order with integer
    levels (Dial's), as the kernel finds it.

    Level by level, from the least finite d: the rows whose d is the level
    are settled, each read once and relaxed into d, and the rows that fall
    to the level (zero entries of W) after them, until none falls.  It stops
    before a level once the targets' least d is at most that level, or the
    level is above the bound, or no finite d is left; ``levels`` counts the
    levels settled and ``rows`` the rows of W read."""
    top = INF if bound is None else min(int(bound), INF)
    d = d0.clamp_max(INF)
    tgt = tgt.bool()
    settled = torch.zeros_like(tgt)

    def least(mask):
        return int(torch.where(mask, d, INF).min()) if d.numel() else INF

    tmin = least(tgt)
    levels = rows = 0
    while True:
        level = least(~settled)
        if tmin <= level or level > top:
            break
        levels += 1
        new = (d == level) & ~settled
        while bool(new.any()):
            settled |= new
            rows += int(new.sum())
            reach = torch.amin(level + W[new], dim=0).clamp_max(INF)
            d = torch.minimum(d, reach)
            new = (d == level) & ~settled
        tmin = least(tgt)
    answer = tmin if tmin <= top else INF
    return torch.tensor([answer, levels, rows], dtype=torch.int32,
                        device=d0.device)


def min_plus_settle_lists_ref(src: torch.Tensor, lists, tgt: torch.Tensor,
                              bound: Optional[int] = None) -> torch.Tensor:
    """src [B] bool (d starts at 0 there, INF elsewhere), ``lists`` the row
    lists of W (``ops.RowLists``: row k's (column, distance) pairs are
    ``pairs[k, :count[k]]``, every distance in [0, INF)), tgt [B] bool ->
    int32 [answer, levels, rows, overflow, entries] on src's device:
    :func:`min_plus_settle_ref`'s search, each settled row relaxed through
    its list, so that answer, levels and rows are the dense search's on the
    W the lists hold; ``overflow`` and ``entries`` are ``lists.meta``.
    Where ``overflow`` is set the lists do not hold W: nothing is searched,
    and the answer is INF."""
    over, entries = (int(x) for x in lists.meta.tolist())
    if over:
        return torch.tensor([INF, 0, 0, over, entries], dtype=torch.int32,
                            device=src.device)
    top = INF if bound is None else min(int(bound), INF)
    d = torch.where(src.bool(), 0, INF).to(torch.int32)
    tgt = tgt.bool()
    settled = torch.zeros_like(tgt)
    slot = torch.arange(lists.pairs.shape[1], device=src.device)

    def least(mask):
        return int(torch.where(mask, d, INF).min()) if d.numel() else INF

    tmin = least(tgt)
    levels = rows = 0
    while True:
        level = least(~settled)
        if tmin <= level or level > top:
            break
        levels += 1
        new = (d == level) & ~settled
        while bool(new.any()):
            settled |= new
            rows += int(new.sum())
            ks = torch.nonzero(new)[:, 0]
            live = slot < lists.count[ks][:, None]
            cols = lists.pairs[ks, :, 0][live].long()
            dist = (level + lists.pairs[ks, :, 1][live]).clamp_max(INF)
            d.scatter_reduce_(0, cols, dist.to(torch.int32), "amin")
            new = (d == level) & ~settled
        tmin = least(tgt)
    answer = tmin if tmin <= top else INF
    return torch.tensor([answer, levels, rows, 0, entries],
                        dtype=torch.int32, device=src.device)
