"""Plain PyTorch versions of the word packing and of the bit-packed or-and
product, written apart from ``ops.py`` so that each can check the other."""
import torch


def pack_rows_ref(a: torch.Tensor) -> torch.Tensor:
    """[M, K] bool -> [M, ceil(K/32)] int32 words, one column at a time:
    bit ``k % 32`` of word ``k // 32`` is ``a[:, k]``."""
    M, K = a.shape
    words = torch.zeros((M, (K + 31) // 32), dtype=torch.int64,
                        device=a.device)
    for k in range(K):
        words[:, k // 32] |= a[:, k].long() << (k % 32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _columns(words: torch.Tensor, K: int) -> torch.Tensor:
    """[R, W] int32 row-packed words -> [R, K] bool, column k read from
    bit ``k % 32`` of word ``k // 32``."""
    k = torch.arange(K, device=words.device)
    return ((words[:, k // 32] >> (k % 32).to(torch.int32)) & 1).bool()


def bitpack_matmul_ref(ap: torch.Tensor, bp: torch.Tensor,
                       K: int) -> torch.Tensor:
    """ap [M, W] row-packed, bp [W, N] column-packed int32 words -> the
    or-and product [M, N] bool of the unpacked operands.  Exact in
    float32: a sum of 0/1 products is positive iff one product is 1."""
    a = _columns(ap, K)                       # [M, K]
    b = _columns(bp.T, K).T                   # [K, N]
    return (a.float() @ b.float()) > 0
