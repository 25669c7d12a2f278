"""Architecture registries of the port, keyed by id: the five LM
architectures as :class:`~repro_torch.configs.families.lm.LMArch`
records, the four GNNs as :class:`~repro_torch.configs.families.gnn.
GNNArch` and bert4rec as :class:`~repro_torch.configs.families.recsys.
RecsysArch`.  The full ``ARCHS`` registry with its cell programs follows
in a later slice."""
from __future__ import annotations

from typing import Dict

from . import (bert4rec_cfg, chatglm3_6b, egnn_cfg, gat_cora, mace_cfg,
               mixtral_8x7b, nequip_cfg, olmoe_1b_7b, qwen1_5_32b,
               qwen2_1_5b)
from .families.gnn import GNNArch
from .families.lm import LMArch
from .families.recsys import RecsysArch

LM_ARCHS: Dict[str, LMArch] = {
    a.ARCH.arch_id: a.ARCH
    for a in (olmoe_1b_7b, mixtral_8x7b, qwen1_5_32b, qwen2_1_5b,
              chatglm3_6b)
}
GNN_ARCHS: Dict[str, GNNArch] = {
    a.ARCH.arch_id: a.ARCH for a in (egnn_cfg, mace_cfg, nequip_cfg, gat_cora)
}
RECSYS_ARCHS: Dict[str, RecsysArch] = {
    a.ARCH.arch_id: a.ARCH for a in (bert4rec_cfg,)
}
