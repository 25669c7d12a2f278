"""bert4rec [arXiv:1904.06690]: embed_dim=64, 2 blocks, 2 heads,
seq_len=200, bidirectional Cloze; 1M-item table for the retrieval cell."""
from ..models.bert4rec import Bert4RecConfig
from .families.recsys import RecsysArch

ARCH = RecsysArch(
    arch_id="bert4rec",
    full_cfg=Bert4RecConfig(n_items=1_000_000, embed_dim=64, n_blocks=2,
                            n_heads=2, seq_len=200),
    smoke_cfg=Bert4RecConfig(n_items=512, embed_dim=32, n_blocks=2,
                             n_heads=2, seq_len=16),
)
