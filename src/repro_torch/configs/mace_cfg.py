"""mace [arXiv:2206.07697]: 2 layers, 128 channels, l_max=2,
correlation order 3, n_rbf=8, E(3)-ACE higher-order message passing."""
from ..models.gnn.equivariant import EquivariantConfig
from .families.gnn import GNNArch

ARCH = GNNArch(
    arch_id="mace",
    kind="mace",
    full_cfg_fn=lambda d_feat: EquivariantConfig(
        arch="mace", n_layers=2, channels=128, l_max=2, n_rbf=8,
        correlation=3, cutoff=5.0, n_species=64),
    smoke_cfg_fn=lambda d_feat: EquivariantConfig(
        arch="mace", n_layers=1, channels=8, l_max=2, n_rbf=4,
        correlation=2, cutoff=3.0, n_species=8),
)
