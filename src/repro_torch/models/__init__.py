"""Models of the substrate: the LM family
(:mod:`repro_torch.models.transformer`), the GNN family
(:mod:`repro_torch.models.gnn`) and bert4rec
(:mod:`repro_torch.models.bert4rec`)."""
from . import bert4rec, gnn, transformer

__all__ = ["bert4rec", "gnn", "transformer"]
