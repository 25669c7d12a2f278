"""Plain PyTorch versions of the or-and semiring product and of evalDG's
fixpoint over it."""
from typing import Optional, Tuple

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


def or_and_fixpoint_ref(x0: torch.Tensor, D: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x0 [B] bool, D [B, B] bool -> (x, steps): x := x | x (or-and) D until
    a step changes nothing, one vector-matrix product a step and one host
    sync a step; steps (a 0-d int32 tensor on x0's device) counts the
    products, the last one included (0 when x0 is empty)."""
    x = x0.clone()
    steps = 0
    if bool(x.any()):
        while True:
            nxt = or_and_matmul_ref(x[None, :], D, init=x[None, :])[0]
            steps += 1
            if torch.equal(nxt, x):
                break
            x = nxt
    return x, torch.tensor(steps, dtype=torch.int32, device=x0.device)
