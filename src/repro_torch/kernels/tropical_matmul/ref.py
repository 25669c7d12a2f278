"""Plain PyTorch versions of the (min, +) semiring product and of evalDG's
fixpoint over it."""
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
    all INF)."""
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
