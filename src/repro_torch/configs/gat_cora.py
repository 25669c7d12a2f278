"""gat-cora [arXiv:1710.10903]: 2 layers, d_hidden=8, 8 heads, attention
aggregator (Cora: 2708 nodes / 10556 edges / 1433 features / 7 classes)."""
from ..models.gnn.gat import GATConfig
from .families.gnn import GNNArch

ARCH = GNNArch(
    arch_id="gat-cora",
    kind="gat",
    full_cfg_fn=lambda d_feat: GATConfig(n_layers=2, d_in=d_feat,
                                         d_hidden=8, n_heads=8,
                                         n_classes=47 if d_feat == 100 else 7),
    smoke_cfg_fn=lambda d_feat: GATConfig(n_layers=2, d_in=d_feat,
                                          d_hidden=4, n_heads=2,
                                          n_classes=5),
)
