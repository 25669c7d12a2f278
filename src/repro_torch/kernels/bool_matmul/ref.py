"""Plain PyTorch version of the or-and semiring product."""
from typing import Optional

import torch


def or_and_matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
                      init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a [M, K] bool, b [K, N] bool -> init | OR_k(a & b) [M, N] bool
    (no init: OR_k(a & b)).

    Exact in float32: the sum of non-negative 0/1 products is positive iff
    one product is 1, whatever the rounding."""
    c = (a.float() @ b.float()) > 0
    return c if init is None else c | init


def or_and_matmul_nt_ref(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a [M, K] bool, b_t [N, K] bool (the right operand K-major) ->
    OR_k(a[i, k] & b_t[j, k]) [M, N] bool."""
    return or_and_matmul_ref(a, b_t.T)
