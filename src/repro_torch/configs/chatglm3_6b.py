"""chatglm3-6b [arXiv:2406.12793]: 28L d_model=4096 32H (GQA kv=2)
d_ff=13696 vocab=65024, 2d/partial RoPE (rope_pct=0.5), QKV bias."""
import torch

from ..models.transformer import LMConfig
from .families.lm import LMArch

ARCH = LMArch(
    arch_id="chatglm3-6b",
    base_cfg=LMConfig(
        name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32,
        n_kv_heads=2, d_head=128, d_ff=13696, vocab=65024, qkv_bias=True,
        rope_pct=0.5, tie_embeddings=False, dtype=torch.bfloat16),
    smoke_cfg=LMConfig(
        name="chatglm3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=128, qkv_bias=True,
        rope_pct=0.5, tie_embeddings=False, remat=False),
    long_ok=False,
)
