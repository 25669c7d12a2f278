"""mixtral-8x7b [arXiv:2401.04088]: 32L d_model=4096 32H (kv=8) MoE 8e
top-2, d_ff=14336, vocab=32000, sliding-window attention (4096)."""
import torch

from ..models.transformer import LMConfig
from .families.lm import LMArch

ARCH = LMArch(
    arch_id="mixtral-8x7b",
    base_cfg=LMConfig(
        name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=0, vocab=32000, qkv_bias=False,
        sliding_window=4096, n_experts=8, top_k=2, d_ff_expert=14336,
        tie_embeddings=False, dtype=torch.bfloat16),
    smoke_cfg=LMConfig(
        name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=0, vocab=128, sliding_window=16,
        n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=4.0,
        tie_embeddings=False, remat=False),
    long_ok=True,    # SWA => O(window) per decoded token; ring KV cache
)
