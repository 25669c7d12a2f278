"""Architecture registry: the 10 architectures as ``--arch <id>``
entries.

Every arch has ``shape_ids()``, ``skip_reason(shape)`` and
``build(shape, multipod, reduced, ...) -> CellProgram`` (see
``families/base.py``).  ``LM_ARCHS``, ``GNN_ARCHS`` and ``RECSYS_ARCHS``
are the registry's three families.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import (bert4rec_cfg, chatglm3_6b, egnn_cfg, gat_cora, mace_cfg,
               mixtral_8x7b, nequip_cfg, olmoe_1b_7b, qwen1_5_32b,
               qwen2_1_5b)
from .families.gnn import GNNArch
from .families.lm import LMArch
from .families.recsys import RecsysArch

ARCHS: Dict[str, object] = {
    a.ARCH.arch_id: a.ARCH
    for a in (olmoe_1b_7b, mixtral_8x7b, qwen1_5_32b, qwen2_1_5b,
              chatglm3_6b, egnn_cfg, mace_cfg, nequip_cfg, gat_cora,
              bert4rec_cfg)
}
LM_ARCHS: Dict[str, LMArch] = {
    k: a for k, a in ARCHS.items() if a.family == "lm"}
GNN_ARCHS: Dict[str, GNNArch] = {
    k: a for k, a in ARCHS.items() if a.family == "gnn"}
RECSYS_ARCHS: Dict[str, RecsysArch] = {
    k: a for k, a in ARCHS.items() if a.family == "recsys"}


def get_arch(arch_id: str):
    return ARCHS[arch_id]


def list_archs() -> List[str]:
    return list(ARCHS)


def all_cells() -> List[Tuple[str, str]]:
    """Every (arch, shape) pair — 40 cells."""
    return [(aid, sid) for aid, arch in ARCHS.items()
            for sid in arch.shape_ids()]
