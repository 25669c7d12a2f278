"""Plain PyTorch version of the or-and semiring product."""
import torch


def or_and_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] bool, b [K, N] bool -> OR_k(a & b) [M, N] bool.

    Exact in float32: the sum of non-negative 0/1 products is positive iff
    one product is 1, whatever the rounding."""
    return (a.float() @ b.float()) > 0


def or_and_matmul_nt_ref(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a [M, K] bool, b_t [N, K] bool (the right operand K-major) ->
    OR_k(a[i, k] & b_t[j, k]) [M, N] bool."""
    return or_and_matmul_ref(a, b_t.T)
