"""Boolean-equation-system / dependency-graph closures by repeated squaring.

For a reusable fragmentation the coordinator's BES solve becomes an
all-pairs closure: at most ceil(log2 B) semiring products, each one launch
of the or-and or min-plus kernel on the card.  The loop stops early once a
squaring changes nothing (one host sync per squaring).
"""
from __future__ import annotations

import math

import torch

from ..kernels.bool_matmul.ops import or_and_matmul
from ..kernels.tropical_matmul.ops import min_plus_matmul


def _ceil_log2(b: int) -> int:
    return max(1, math.ceil(math.log2(max(b, 2))))


def bool_closure(D: torch.Tensor) -> torch.Tensor:
    """Reflexive-transitive closure of a Boolean matrix [B, B].

    A := A@A over A = D | I, while a squaring changes A and at most
    ceil(log2 B) times: squaring doubles the covered path length, so the
    fixpoint comes after ceil(log2 diam) rounds (worst case diam == B).
    A holds I, so A@A holds A and equals the reference's A | A@A.
    """
    B = D.shape[-1]
    A = D | torch.eye(B, dtype=torch.bool, device=D.device)
    if B == 0:
        return A
    for _ in range(_ceil_log2(B)):
        A2 = or_and_matmul(A, A)
        if torch.equal(A2, A):
            break
        A = A2
    return A


def tropical_closure(W: torch.Tensor) -> torch.Tensor:
    """Min-plus closure of a distance matrix [B, B] (diagonal forced to 0).

    W := W (min,+) W, clipped at INF by the product, with the stop rule of
    :func:`bool_closure`.  The zero diagonal makes the product at most W,
    so it equals the reference's min(W, W (min,+) W).  Entries of W lie
    in [0, INF], the product's precondition."""
    B = W.shape[-1]
    W = torch.where(torch.eye(B, dtype=torch.bool, device=W.device), 0,
                    W).to(torch.int32)
    if B == 0:
        return W
    for _ in range(_ceil_log2(B)):
        W2 = min_plus_matmul(W, W)
        if torch.equal(W2, W):
            break
        W = W2
    return W
