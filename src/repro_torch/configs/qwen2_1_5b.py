"""qwen2-1.5b [arXiv:2407.10671]: 28L d_model=1536 12H (GQA kv=2)
d_ff=8960 vocab=151936, QKV bias, tied embeddings."""
import torch

from ..models.transformer import LMConfig
from .families.lm import LMArch

ARCH = LMArch(
    arch_id="qwen2-1.5b",
    base_cfg=LMConfig(
        name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, d_head=128, d_ff=8960, vocab=151936, qkv_bias=True,
        tie_embeddings=True, dtype=torch.bfloat16),
    smoke_cfg=LMConfig(
        name="qwen2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, vocab=128, qkv_bias=True, tie_embeddings=True,
        remat=False),
    long_ok=False,
)
