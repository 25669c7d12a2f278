"""egnn [arXiv:2102.09844]: 4 layers, d_hidden=64, E(n)-equivariant."""
from ..models.gnn.egnn import EGNNConfig
from .families.gnn import GNNArch

ARCH = GNNArch(
    arch_id="egnn",
    kind="egnn",
    full_cfg_fn=lambda d_feat: EGNNConfig(n_layers=4, d_hidden=64,
                                          d_in=d_feat),
    smoke_cfg_fn=lambda d_feat: EGNNConfig(n_layers=2, d_hidden=16,
                                           d_in=d_feat),
)
