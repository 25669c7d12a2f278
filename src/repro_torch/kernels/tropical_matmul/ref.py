"""Plain PyTorch version of the (min, +) semiring product."""
import torch

INF = 1 << 29

#: int32 elements of the [rows, K, N] broadcast per chunk of rows (64 MiB)
CHUNK_ELEMENTS = 1 << 24


def min_plus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K], b [K, N] int32 -> min(min_k (a + b), INF) [M, N] int32.

    Rows go as many at a time as keep the [rows, K, N] broadcast within
    ``CHUNK_ELEMENTS``, and at least one.  K = 0 gives INF (min over
    nothing)."""
    M, K = a.shape
    N = b.shape[1]
    out = torch.full((M, N), INF, dtype=torch.int32, device=a.device)
    if K == 0:
        return out
    rows = max(1, CHUNK_ELEMENTS // max(1, K * N))
    for r0 in range(0, M, rows):
        out[r0:r0 + rows] = torch.amin(
            a[r0:r0 + rows, :, None] + b[None, :, :], dim=1).clamp_max_(INF)
    return out
