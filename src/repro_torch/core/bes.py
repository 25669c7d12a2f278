"""Boolean-equation-system / dependency-graph closures by repeated squaring.

For a reusable fragmentation the coordinator's BES solve becomes an
all-pairs closure: at most ceil(log2 B) semiring products, each one launch
of the or-and or min-plus kernel on the card.  The loop stops early once a
squaring changes nothing (one host sync per squaring).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import tracing
from ..kernels.bool_matmul.ops import kmajor_copy, or_and_matmul_nt
from ..kernels.tropical_matmul.ops import min_plus_matmul, padded_i32
from .engine import FIXPOINT


def _ceil_log2(b: int) -> int:
    return max(1, math.ceil(math.log2(max(b, 2))))


def _count_squaring() -> None:
    """One squaring and the blocking comparison after it."""
    tracing.count("closure.squarings")
    tracing.count("host.syncs")


def bool_closure(D: torch.Tensor) -> torch.Tensor:
    """Reflexive-transitive closure of a Boolean matrix [B, B]: the first
    of :func:`bool_closure_kmajor`'s pair."""
    return bool_closure_kmajor(D)[0]


def bool_closure_kmajor(D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reflexive-transitive closure C of a Boolean matrix [B, B] and its
    K-major copy C^T, the form in which the or-and kernel takes a right
    operand (``or_and_matmul_nt``): a caller composing through C keeps both.

    A := A@A over A = D | I, while a squaring changes A and at most
    ceil(log2 B) times: squaring doubles the covered path length, so the
    fixpoint comes after ceil(log2 diam) rounds (worst case diam == B).
    A holds I, so A@A holds A and equals the reference's A | A@A.  Each
    squaring takes (A, A^T) and writes (A@A, (A@A)^T) in one launch, so
    only the first A is transposed.  Each squaring is counted in the
    tracing counter ``closure.squarings``, and its ``torch.equal`` in
    ``host.syncs``.
    """
    B = D.shape[-1]
    A = kmajor_copy(D)
    A.diagonal().fill_(True)
    At = kmajor_copy(A.T)
    if B == 0:
        return A, At
    with FIXPOINT:
        for _ in range(_ceil_log2(B)):
            A2, A2t = or_and_matmul_nt(A, At, with_transpose=True)
            _count_squaring()
            if torch.equal(A2, A):
                break
            A, At = A2, A2t
    return A, At


def tropical_closure(W: torch.Tensor) -> torch.Tensor:
    """Min-plus closure of a distance matrix [B, B] (diagonal forced to 0).

    W := W (min,+) W, clipped at INF by the product, with the stop rule of
    :func:`bool_closure`.  The zero diagonal makes the product at most W,
    so it equals the reference's min(W, W (min,+) W).  Entries of W lie
    in [0, INF], the product's precondition.  W is copied once into padded
    storage (rows 16 bytes apart), as are the products, so no squaring
    copies an operand.  Counted as :func:`bool_closure_kmajor` is."""
    B = W.shape[-1]
    W = padded_i32(B, B, W.device).copy_(W)
    W.diagonal().fill_(0)
    if B == 0:
        return W
    with FIXPOINT:
        for _ in range(_ceil_log2(B)):
            W2 = min_plus_matmul(W, W)
            _count_squaring()
            if torch.equal(W2, W):
                break
            W = W2
    return W


def closure_answers(A: torch.Tensor, src_rows, tgt_cols) -> torch.Tensor:
    """Batch answer extraction: ``ans[q] = A[src_rows[q], tgt_cols[q]]``
    for index tensors ``src_rows``/``tgt_cols`` [nq]."""
    return A[src_rows, tgt_cols]
