"""The LM family's record: an architecture's full-size and smoke
configurations and its serving flags.  The reference's cell programs
(train / prefill / decode / long lowerings for its dry run) are not part
of the port yet."""
from __future__ import annotations

import dataclasses

from ...models.transformer import LMConfig


@dataclasses.dataclass(frozen=True)
class LMArch:
    arch_id: str
    base_cfg: LMConfig                   # full-size config (dtype bf16)
    smoke_cfg: LMConfig                  # reduced config for CPU smoke
    long_ok: bool                        # sub-quadratic (SWA) => long_500k
    kv_quant_decode: bool = False        # int8 KV for the huge caches
    family: str = "lm"
