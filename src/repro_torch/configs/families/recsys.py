"""RecSys-family adapter: bert4rec's train / serve / bulk / retrieval
cells."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ...launch.constraints import P
from ...models import bert4rec as B
from ...models.bert4rec import Bert4RecConfig
from ...tree import leaves
from .base import (CellProgram, dp, make_train_step, opt_state_like, sds,
                   spec_tree)

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

    def shape_ids(self):
        return list(RECSYS_SHAPES)

    def skip_reason(self, shape_id: str) -> Optional[str]:
        return None

    def build(self, shape_id: str, multipod: bool = False,
              reduced: bool = False, probe: bool = False,
              optimized: bool = False) -> CellProgram:
        """probe: the reference's loop-free cost variant — serve_bulk
        runs ONE scoring chunk with cost_scale = the chunk count.
        optimized: the two-stage top-k (``topk_ways=16``)."""
        cfg = self.smoke_cfg if reduced else self.full_cfg
        if optimized:
            cfg = dataclasses.replace(cfg, topk_ways=16)
        dims = dict((REDUCED if reduced else FULL)[shape_id])
        cost_scale = 1.0
        if probe and shape_id == "serve_bulk":
            cost_scale = dims["batch"] / dims["chunk"]
            dims["batch"] = dims["chunk"]
        dpx = dp(multipod)
        i32 = torch.int32
        params_abs = B.init_params(cfg, None, device="meta")
        pspec = spec_tree(params_abs, _param_spec)
        n_params = sum(math.prod(x.shape) for x in leaves(params_abs))

        if shape_id == "train_batch":
            bsz, M, n_neg = dims["batch"], dims["n_mask"], dims["n_neg"]

            def loss(p, items, mpos, tgt, neg):
                return B.sampled_masked_loss(cfg, p, items, mpos, tgt, neg)

            step = make_train_step(loss, accum=False)
            m, v, st = opt_state_like(params_abs)
            args = (params_abs, m, v, st, sds((bsz, cfg.seq_len), i32),
                    sds((bsz, M), i32), sds((bsz, M), i32),
                    sds((n_neg,), i32))
            specs = (pspec, pspec, pspec, P(), P(dpx, None), P(dpx, None),
                     P(dpx, None), P())
            # transformer flops + embedding/negatives scoring, fwd+bwd
            per_block = 12 * cfg.embed_dim ** 2
            flops = 3.0 * bsz * cfg.seq_len * cfg.n_blocks * per_block * 2 + \
                3.0 * 2.0 * bsz * M * n_neg * cfg.embed_dim
            return CellProgram(self.arch_id, shape_id, "train", step, args,
                               specs, flops, 10.0 * n_params, loss_fn=loss)

        if shape_id in ("serve_p99", "serve_bulk"):
            bsz = dims["batch"]
            if shape_id == "serve_p99":
                def step(p, items):
                    return B.score_next(cfg, p, items)
            else:
                topk, chunk = dims["topk"], dims["chunk"]

                def step(p, items):
                    return B.score_topk(cfg, p, items, k=topk, chunk=chunk)

            args = (params_abs, sds((bsz, cfg.seq_len), i32))
            specs = (pspec, P(dpx, None))
            per_block = 12 * cfg.embed_dim ** 2
            full_b = (REDUCED if reduced else FULL)[shape_id]["batch"]
            flops = full_b * cfg.seq_len * cfg.n_blocks * per_block * 2 + \
                2.0 * full_b * cfg.n_items * cfg.embed_dim
            return CellProgram(self.arch_id, shape_id, "serve", step, args,
                               specs, flops, 2.0 * n_params,
                               cost_scale=cost_scale)

        # retrieval_cand: one query against n_cand candidates
        n_cand = dims["n_cand"]

        def step(p, items, cands):
            return B.score_candidates(cfg, p, items, cands)

        args = (params_abs, sds((1, cfg.seq_len), i32), sds((n_cand,), i32))
        # 1e6 candidates: sharded on "model" only (1e6 / 16 divides; the
        # flat 256/512-way grid does not divide 1e6)
        specs = (pspec, P(), P("model"))
        flops = 2.0 * n_cand * cfg.embed_dim + \
            cfg.seq_len * cfg.n_blocks * 12 * cfg.embed_dim ** 2 * 2
        return CellProgram(self.arch_id, shape_id, "retrieval", step, args,
                           specs, flops, 8.0 * n_cand * cfg.embed_dim)


def _param_spec(path: str, leaf) -> P:
    if "item_embed" in path:
        return P("model", None)       # 1M rows sharded over model
    return P()                        # d=64 blocks: replicated
