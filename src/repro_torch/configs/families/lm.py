"""LM-family adapter: the train / prefill / decode / long cell programs of
the five transformer architectures."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ...launch.constraints import P
from ...models import transformer as T
from .base import (CellProgram, dp, make_train_step, opt_state_like,
                   sds, spec_tree)

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@dataclasses.dataclass(frozen=True)
class LMShapes:
    train_seq: int = 4096
    train_batch: int = 256
    grad_accum: int = 8
    prefill_seq: int = 32768
    prefill_batch: int = 32
    decode_seq: int = 32768
    decode_batch: int = 128
    long_seq: int = 524288
    long_batch: int = 1


@dataclasses.dataclass(frozen=True)
class LMArch:
    arch_id: str
    base_cfg: T.LMConfig                 # full-size config (dtype bf16)
    smoke_cfg: T.LMConfig                # reduced config for CPU smoke
    long_ok: bool                        # sub-quadratic (SWA) => long_500k
    kv_quant_decode: bool = False        # int8 KV for the huge caches
    shapes: LMShapes = dataclasses.field(default_factory=LMShapes)
    family: str = "lm"

    def shape_ids(self):
        return list(LM_SHAPES)

    def skip_reason(self, shape_id: str) -> Optional[str]:
        if shape_id == "long_500k" and not self.long_ok:
            return ("pure full-attention arch: 500k-token decode requires "
                    "sub-quadratic attention (assignment: skip + note)")
        return None

    # ------------------------------------------------------------------
    def _cfg(self, shape_id: str, reduced: bool,
             probe_layers: Optional[int] = None, multipod: bool = False,
             optimized: bool = False) -> T.LMConfig:
        cfg = self.smoke_cfg if reduced else self.base_cfg
        kw = {}
        if optimized:
            kw["dp_axes"] = dp(multipod)
        if shape_id in ("train_4k", "prefill_32k"):
            kw["attn_chunk"] = 8 if reduced else \
                (2048 if shape_id == "prefill_32k" else 1024)
        if shape_id in ("decode_32k", "long_500k"):
            kw["decode_chunk"] = 16 if reduced else 2048
            if self.kv_quant_decode and shape_id == "decode_32k":
                kw["kv_quant_int8"] = True
        if probe_layers is not None:
            kw["n_layers"] = probe_layers
            kw["unroll"] = True
        return dataclasses.replace(cfg, **kw)

    def _dims(self, shape_id: str, reduced: bool) -> Dict[str, int]:
        if reduced:
            return dict(train_seq=32, train_batch=8, grad_accum=2,
                        prefill_seq=64, prefill_batch=2, decode_seq=64,
                        decode_batch=4, long_seq=128, long_batch=1)
        return dataclasses.asdict(self.shapes)

    # ------------------------------------------------------------------
    def build(self, shape_id: str, multipod: bool = False,
              reduced: bool = False,
              probe_layers: Optional[int] = None,
              optimized: bool = False) -> CellProgram:
        """probe_layers: the reference's loop-free cost probe at that
        layer count (for train, one microbatch with cost_scale =
        grad_accum).  optimized: the mesh hints (``dp_axes``)."""
        cfg = self._cfg(shape_id, reduced, probe_layers, multipod, optimized)
        d = self._dims(shape_id, reduced)
        params_abs = T.init_params(cfg, None, device="meta")
        pspec = spec_tree(params_abs,
                          lambda path, leaf: _lm_param_spec(cfg, path, leaf))
        dpx = dp(multipod)
        i32 = torch.int32

        if shape_id == "train_4k":
            A, B, S = d["grad_accum"], d["train_batch"], d["train_seq"]
            mb = B // A

            def loss(p, tok, tgt):
                return T.lm_loss(cfg, p, tok, tgt)

            m, v, st = opt_state_like(params_abs)
            if probe_layers is not None:
                step = make_train_step(loss, accum=False)
                tok = sds((mb, S), i32)
                tok_spec = P(dpx, None)
                scale = float(A)
            else:
                step = make_train_step(loss, accum=True)
                tok = sds((A, mb, S), i32)
                tok_spec = P(None, dpx, None)
                scale = 1.0
            args = (params_abs, m, v, st, tok, tok)
            specs = (pspec, pspec, pspec, P(), tok_spec, tok_spec)
            n = self.base_cfg.n_active_params()
            flops = 6.0 * n * B * S
            return CellProgram(self.arch_id, shape_id, "train", step, args,
                               specs, flops, 10.0 * self.base_cfg.n_params(),
                               cost_scale=scale, loss_fn=loss)

        mf_cfg = cfg if reduced else self.base_cfg   # model-flops reference

        if shape_id == "prefill_32k":
            B, S = d["prefill_batch"], d["prefill_seq"]

            def step(p, tok):
                logits, _ = T.forward(cfg, p, tok)
                return logits

            args = (params_abs, sds((B, S), i32))
            specs = (pspec, P(dpx, None))
            flops = 2.0 * mf_cfg.n_active_params() * B * S
            return CellProgram(self.arch_id, shape_id, "prefill", step, args,
                               specs, flops, 2.0 * mf_cfg.n_params())

        # decode cells run decode_step: one token against the KV cache
        B = d["decode_batch"] if shape_id == "decode_32k" else d["long_batch"]
        S = d["decode_seq"] if shape_id == "decode_32k" else d["long_seq"]
        cache_abs = T.init_cache(cfg, B, S, device="meta")
        cache_spec = spec_tree(
            cache_abs, lambda path, leaf: _cache_spec(path, leaf, dpx, B))

        def step(p, cache, token, pos):
            return T.decode_step(cfg, p, cache, token, pos)

        args = (params_abs, cache_abs, sds((B,), i32), sds((B,), i32))
        bspec = P(dpx) if B > 1 else P()
        specs = (pspec, cache_spec, bspec, bspec)
        flops = 2.0 * mf_cfg.n_active_params() * B + \
            2.0 * 2 * mf_cfg.n_layers * mf_cfg.n_kv_heads * mf_cfg.d_head * \
            B * min(S, T.cache_len(mf_cfg, S)) * \
            (mf_cfg.n_heads // mf_cfg.n_kv_heads)
        kind = "decode" if shape_id == "decode_32k" else "long_decode"
        return CellProgram(self.arch_id, shape_id, kind, step, args, specs,
                           flops, 2.0 * cfg.n_params())


def _lm_param_spec(cfg: T.LMConfig, path: str, leaf) -> P:
    """FSDP (d_model on data) x TP (heads, ffn, vocab on model); MoE
    experts on model when 16 divides their count.  The pod dim is left
    out: pure data parallelism across pods.  The reference's rule on this
    package's layout (one dict per layer, no layer axis), name first:
    ``embed [V, d]`` and ``lm_head [d, V]``, norms and biases ``[d]``,
    the router ``[d, E]``, experts ``[E, d, ffe]`` / ``[E, ffe, d]`` and
    projections ``[d, out]`` / ``[out, d]``."""
    nd = len(leaf.shape)
    if "embed" in path or "lm_head" in path:
        return P("model", None) if nd == 2 else P()
    if nd <= 1:                    # norm scales, biases
        return P()
    if "router" in path:
        return P("data", None)
    if nd == 3:                    # experts
        if cfg.n_experts % 16 == 0:
            return P("model", "data", None)
        return P(None, "data", "model") if "w2" not in path else \
            P(None, "model", "data")
    if "wo" in path or "w2" in path:
        return P("model", "data")
    return P("data", "model")


def _cache_spec(path: str, leaf, dpx, batch: int) -> P:
    bs = dpx if batch > 1 else None
    nd = len(leaf.shape)
    if nd == 5:                    # k/v [L, B, T, H, dh]
        return P(None, bs, "model", None, None)
    if nd == 4:                    # scales [L, B, T, H]
        return P(None, bs, "model", None)
    if nd == 3:                    # pos [L, B, T]
        return P(None, bs, "model")
    return P()
