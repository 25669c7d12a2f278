"""qwen1.5-32b [hf:Qwen/Qwen1.5-32B]: 64L d_model=5120 40H (kv=40, i.e.
MHA) d_ff=27392 vocab=152064, QKV bias.  Its 32k-token decode uses the
int8 KV cache."""
import torch

from ..models.transformer import LMConfig
from .families.lm import LMArch

ARCH = LMArch(
    arch_id="qwen1.5-32b",
    base_cfg=LMConfig(
        name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=40, d_head=128, d_ff=27392, vocab=152064, qkv_bias=True,
        tie_embeddings=False, dtype=torch.bfloat16),
    smoke_cfg=LMConfig(
        name="qwen32b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=128, qkv_bias=True,
        tie_embeddings=False, remat=False),
    long_ok=False,
    kv_quant_decode=True,
)
