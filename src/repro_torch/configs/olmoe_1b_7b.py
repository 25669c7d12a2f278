"""olmoe-1b-7b [arXiv:2409.02060]: 16L d_model=2048 16H (kv=16) MoE 64e
top-8, d_ff(expert)=1024, vocab=50304."""
import torch

from ..models.transformer import LMConfig
from .families.lm import LMArch

ARCH = LMArch(
    arch_id="olmoe-1b-7b",
    base_cfg=LMConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_ff=0, vocab=50304, qkv_bias=False,
        n_experts=64, top_k=8, d_ff_expert=1024, tie_embeddings=False,
        dtype=torch.bfloat16),
    smoke_cfg=LMConfig(
        name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_head=16, d_ff=0, vocab=128, n_experts=8, top_k=2, d_ff_expert=32,
        capacity_factor=4.0, tie_embeddings=False, remat=False),
    long_ok=False,   # pure full attention -> long_500k skipped
)
