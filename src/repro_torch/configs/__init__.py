"""Architecture registry of the port: the five LM architectures as
:class:`~repro_torch.configs.families.lm.LMArch` records, keyed by id.
The GNN and recsys architectures, and the full ``ARCHS`` registry with
its cell programs, follow in later slices."""
from __future__ import annotations

from typing import Dict

from . import (chatglm3_6b, mixtral_8x7b, olmoe_1b_7b, qwen1_5_32b,
               qwen2_1_5b)
from .families.lm import LMArch

LM_ARCHS: Dict[str, LMArch] = {
    a.ARCH.arch_id: a.ARCH
    for a in (olmoe_1b_7b, mixtral_8x7b, qwen1_5_32b, qwen2_1_5b,
              chatglm3_6b)
}

