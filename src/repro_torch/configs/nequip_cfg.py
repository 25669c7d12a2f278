"""nequip [arXiv:2101.03164]: 5 layers, d_hidden=32, l_max=2, n_rbf=8,
cutoff=5, E(3) tensor-product convolutions."""
from ..models.gnn.equivariant import EquivariantConfig
from .families.gnn import GNNArch

ARCH = GNNArch(
    arch_id="nequip",
    kind="nequip",
    full_cfg_fn=lambda d_feat: EquivariantConfig(
        arch="nequip", n_layers=5, channels=32, l_max=2, n_rbf=8,
        correlation=1, cutoff=5.0, n_species=64),
    smoke_cfg_fn=lambda d_feat: EquivariantConfig(
        arch="nequip", n_layers=2, channels=8, l_max=2, n_rbf=4,
        correlation=1, cutoff=3.0, n_species=8),
)
