"""Models of the substrate.  This slice holds the LM family
(:mod:`repro_torch.models.transformer`); bert4rec and the GNNs follow."""
from . import transformer

__all__ = ["transformer"]
