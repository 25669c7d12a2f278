"""The recsys family's record: bert4rec's full-size and smoke
configurations, and the four shapes with their sizes.  The reference's
cell programs (train / serve / bulk / retrieval, lowered for its dry run)
are not part of the port yet."""
from __future__ import annotations

import dataclasses
from ...models.bert4rec import Bert4RecConfig

RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")

FULL = dict(train_batch=dict(batch=65_536, n_mask=20, n_neg=8_192),
            serve_p99=dict(batch=512),
            serve_bulk=dict(batch=262_144, topk=100, chunk=4_096),
            retrieval_cand=dict(n_cand=1_000_000))
REDUCED = dict(train_batch=dict(batch=8, n_mask=4, n_neg=32),
               serve_p99=dict(batch=4),
               serve_bulk=dict(batch=16, topk=8, chunk=8),
               retrieval_cand=dict(n_cand=64))


@dataclasses.dataclass(frozen=True)
class RecsysArch:
    arch_id: str
    full_cfg: Bert4RecConfig
    smoke_cfg: Bert4RecConfig
    family: str = "recsys"
