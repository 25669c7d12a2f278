"""Decoder-only LM family in PyTorch: dense and MoE, GQA, RoPE (also
partial, chatglm3's "2d"), QKV bias, sliding-window attention, SwiGLU;
layer-by-layer remat, KV-cache prefill and decode.

One parameterized implementation covers the five LM architectures of
``repro_torch.configs`` (olmoe-1b-7b, mixtral-8x7b, qwen1.5-32b,
qwen2-1.5b, chatglm3-6b).  It computes what ``repro.models.transformer``
computes, step for step in the same dtypes (scores in the activation
dtype, softmax in f32, the cache attention in f32), with plain PyTorch
ops; no fused library attention stands in, as its masking and rounding
would differ.

Parameters are a dict of tensors: ``embed [V, d]``, ``ln_f [d]``,
``lm_head [d, V]`` (untied only) and ``layers``, a list of one dict per
layer.  Weights are ``[in, out]`` and applied as ``x @ W``, as in the
reference; :func:`params_from_jax` unstacks the reference's layer axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from torch.utils.checkpoint import checkpoint

from ..core.session import _resolve_device
from ..launch.collective_stats import departure
from ..launch.constraints import batch_sharded, hint
from ..tree import tensor_from_numpy

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 32
    d_ff: int = 256
    vocab: int = 256
    qkv_bias: bool = False
    rope_pct: float = 1.0          # chatglm3 uses 0.5 ("2d" rotary)
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # mixtral SWA
    # MoE (dense model when n_experts == 0)
    n_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    tie_embeddings: bool = True
    dtype: Any = torch.float32     # activation/param dtype (bf16 on the card)
    remat: bool = True             # recompute each layer in the backward
    # serving-path options:
    kv_quant_int8: bool = False    # int8 KV cache + per-(slot,head) scales
    decode_chunk: Optional[int] = None  # online-softmax chunked cache attn
    # blockwise (flash-style) attention for long prefill/train; only
    # causal (i, j<=i) and, with SWA, in-window block pairs are computed
    attn_chunk: Optional[int] = None
    # The reference unrolls its scans for cost probes; eager PyTorch has
    # no scan to unroll, so this field does nothing here.
    unroll: bool = False
    # distribution hints: pin q/k/v and the attention accumulators to
    # batch-sharded, otherwise replicated layouts on these mesh dims
    # (``launch.constraints.hint``; nothing without a DTensor mesh)
    dp_axes: tuple = ()

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Total parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, dh = self.d_model, self.d_head
        attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.is_moe:
            mlp = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
        else:
            mlp = 3 * d * self.d_ff
        per_layer = attn + mlp + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def n_active_params(self) -> int:
        """Activated params per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        attn = d * self.d_head * (self.n_heads * 2 + self.n_kv_heads * 2)
        mlp = self.top_k * 3 * d * self.d_ff_expert + d * self.n_experts
        per_layer = attn + mlp + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _dense_init(generator, shape, dtype, device, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def init_layer(cfg: LMConfig, generator: torch.Generator,
               device) -> Params:
    """One layer's parameters, with the reference's shapes and scales."""
    d, dh = cfg.d_model, cfg.d_head
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    def dense(shape):
        return _dense_init(generator, shape, cfg.dtype, device)

    p = dict(
        ln1=torch.ones((d,), dtype=cfg.dtype, device=device),
        ln2=torch.ones((d,), dtype=cfg.dtype, device=device),
        wq=dense((d, hq * dh)), wk=dense((d, hkv * dh)),
        wv=dense((d, hkv * dh)), wo=dense((hq * dh, d)),
    )
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            p[name] = torch.zeros((width,), dtype=cfg.dtype, device=device)
    if cfg.is_moe:
        e, ffe = cfg.n_experts, cfg.d_ff_expert
        p["router"] = dense((d, e))
        p["w1"] = dense((e, d, ffe))
        p["w3"] = dense((e, d, ffe))
        p["w2"] = dense((e, ffe, d))
    else:
        p["w1"] = dense((d, cfg.d_ff))
        p["w3"] = dense((d, cfg.d_ff))
        p["w2"] = dense((cfg.d_ff, d))
    return p


def init_params(cfg: LMConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters drawn from ``generator`` on ``device`` (``None``:
    the CUDA device, raising :class:`~repro_torch.errors.NoCudaDevice`
    without one); the generator must live on that device."""
    dev = _resolve_device(device)
    p = dict(
        embed=_dense_init(generator, (cfg.vocab, cfg.d_model), cfg.dtype,
                          dev, 0.02),
        ln_f=torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
        layers=[init_layer(cfg, generator, dev)
                for _ in range(cfg.n_layers)],
    )
    if not cfg.tie_embeddings:
        p["lm_head"] = _dense_init(generator, (cfg.d_model, cfg.vocab),
                                   cfg.dtype, dev)
    return p


def params_from_jax(cfg: LMConfig, tree, device=None) -> Params:
    """The reference's parameter tree (numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``, layers stacked on axis 0) as this
    module's parameters on ``device``, value for value (bf16 exactly)."""
    dev = _resolve_device(device)
    stacked = tree["layers"]
    p = dict(
        embed=tensor_from_numpy(tree["embed"], dev),
        ln_f=tensor_from_numpy(tree["ln_f"], dev),
        layers=[{k: tensor_from_numpy(np.asarray(v)[i], dev)
                 for k, v in stacked.items()}
                for i in range(cfg.n_layers)],
    )
    if not cfg.tie_embeddings:
        p["lm_head"] = tensor_from_numpy(tree["lm_head"], dev)
    return p


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _sqrt_f32(n: int, device) -> torch.Tensor:
    """sqrt(n) rounded to f32, as a 0-d tensor made by a fill kernel: a
    tensor built from host data would be copied to the device, and that
    copy waits for every kernel queued before it."""
    return torch.full((), float(np.sqrt(np.float32(n))),
                      dtype=torch.float32, device=device)


def rms_norm(x, scale, eps=1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _rope_tables(positions, cfg: LMConfig, dtype):
    """cos and sin [..., S, 1, half] of the rotary embedding at
    ``positions`` [..., S], in ``dtype``; None when no dim rotates."""
    rot = int(cfg.d_head * cfg.rope_pct)
    rot -= rot % 2
    if rot == 0:
        return None
    half = rot // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(cfg.rope_theta, -ar / half)
    ang = positions[..., None].float() * freqs              # [..., S, half]
    return (torch.cos(ang)[..., None, :].to(dtype),
            torch.sin(ang)[..., None, :].to(dtype))


def _apply_rope(x, tables):
    if tables is None:
        return x
    cos, sin = tables
    half = cos.shape[-1]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    x_rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if 2 * half == x.shape[-1]:
        return x_rot
    return torch.cat([x_rot, x[..., 2 * half:]], dim=-1)


def rope(x, positions, cfg: LMConfig):
    """Rotary embedding on the leading rope_pct fraction of head dims.

    x: [..., S, H, dh]; positions: [..., S] absolute positions.
    rope_pct=0.5 reproduces chatglm3's 2d/partial rotary.
    """
    return _apply_rope(x, _rope_tables(positions, cfg, x.dtype))


def _qkv(cfg: LMConfig, p: Params, x):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # heads whole on each rank, in the forward and (through the
    # redistributions' backward) in the backward
    q, k, v = (batch_sharded(t) for t in (q, k, v))
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def _online_step(m, l, acc, s, v):
    """One block of an online softmax: fold scores ``s`` (f32, ``-inf``
    where masked) and values ``v`` (laid out so that ``p @ v`` is the
    block's output) into the running max ``m``, sum ``l`` and output
    ``acc``.  An all-masked row keeps ``m == -inf``; the ``where``s keep
    its ``exp``s from turning into nan."""
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_new[..., None]), 0.0)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + p @ v
    return m_new, l_new, acc_new


def _blockwise_attention(cfg: LMConfig, q, k, v):
    """Flash-style causal attention over the live (q-block, kv-block)
    pairs with an online softmax, in f32.

    q [B, S, Hkv, G, dh]; k, v [B, S, Hkv, dh].  Positions are arange(S).
    Only blocks with j <= i (causal) and, under SWA, (i-j)*C < window + C
    are computed, in the reference's order.
    """
    B, S, H, G, dh = q.shape
    C = cfg.attn_chunk
    assert S % C == 0, (S, C)
    n = S // C
    dev = q.device
    inv_sqrt = 1.0 / _sqrt_f32(dh, dev)
    # [B, n, H, G*C, dh] queries, [B, n, H, dh, C] keys, [B, n, H, 1, C, dh]
    # values: each block's products are batched matmuls over (B, H)
    qc = q.reshape(B, n, C, H, G, dh).float().permute(0, 1, 3, 4, 2, 5) \
        .reshape(B, n, H, G * C, dh)
    kc = k.reshape(B, n, C, H, dh).float().permute(0, 1, 3, 4, 2)
    vc = v.reshape(B, n, C, H, dh).float().permute(0, 1, 3, 2, 4)[:, :, :,
                                                                 None]
    ar = torch.arange(C, device=dev)
    outs = []
    for i in range(n):
        m = _dp_hint(cfg, torch.full((B, H, G, C), -math.inf, device=dev))
        l = _dp_hint(cfg, torch.zeros((B, H, G, C), device=dev))
        acc = _dp_hint(cfg, torch.zeros((B, H, G, C, dh), device=dev))
        qpos = i * C + ar
        qb = _dp_hint(cfg, qc[:, i])
        for j in range(i + 1):
            if (cfg.sliding_window is not None
                    and (i - j) * C >= cfg.sliding_window + C):
                continue
            kb, vb = _dp_hint(cfg, kc[:, j]), _dp_hint(cfg, vc[:, j])
            s = (qb @ kb).reshape(B, H, G, C, C) * inv_sqrt
            kpos = j * C + ar
            mask = kpos[None, :] <= qpos[:, None]
            if cfg.sliding_window is not None:
                mask &= (qpos[:, None] - kpos[None, :]) < cfg.sliding_window
            s = torch.where(mask, s, -math.inf)
            m, l, acc = _online_step(m, l, acc, s, vb)
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs, dim=1)                  # [B,n,H,G,C,dh]
    out = out.permute(0, 1, 4, 2, 3, 5)             # [B,n,C,H,G,dh]
    return out.reshape(B, S, H * G * dh).to(q.dtype)


def _dp_hint(cfg: LMConfig, x):
    """Batch dim (dim 0) on ``cfg.dp_axes``, every other dim replicated."""
    if not cfg.dp_axes:
        return x
    return hint(x, cfg.dp_axes, *([None] * (x.ndim - 1)))


def attention(cfg: LMConfig, p: Params, x, positions):
    """Full (optionally sliding-window) causal self-attention, GQA."""
    B, S, _ = x.shape
    g = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(cfg, p, x)
    q = rope(q, positions, cfg)
    k = rope(k, positions, cfg)
    q, k, v = _dp_hint(cfg, q), _dp_hint(cfg, k), _dp_hint(cfg, v)
    K, dh = cfg.n_kv_heads, cfg.d_head
    q = q.reshape(B, S, K, g, dh)
    if cfg.attn_chunk is not None and S > cfg.attn_chunk:
        return batch_sharded(_blockwise_attention(cfg, q, k, v)) @ p["wo"]
    # scores [B, K, G, S, S] in the activation dtype, divided by sqrt(dh)
    # in that dtype
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, K, g * S, dh)
    scores = (qh @ k.permute(0, 2, 3, 1)).reshape(B, K, g, S, S) / \
        _sqrt_f32(dh, x.device).to(x.dtype)
    ti = positions[:, None, :]   # key positions   [B, 1, S]
    si = positions[:, :, None]   # query positions [B, S, 1]
    mask = ti <= si
    if cfg.sliding_window is not None:
        mask &= (si - ti) < cfg.sliding_window
    scores = torch.where(mask[:, None, None, :, :], scores.float(),
                         -math.inf)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = probs.reshape(B, K, g * S, S) @ v.permute(0, 2, 1, 3)
    out = out.reshape(B, K, g, S, dh).permute(0, 3, 1, 2, 4)
    out = out.reshape(B, S, cfg.n_heads * dh)
    return batch_sharded(out) @ p["wo"]


def _silu(x):
    return x * torch.sigmoid(x)          # jax.nn.silu's two roundings


def swiglu(p, x):
    return (_silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort), so routing does not depend on the device."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _capacity_slots(flat_e, n_experts: int, cap: int):
    """Arrival order of each (token, choice) pair in its expert's
    capacity buffer, and whether it fits (``pos < cap``)."""
    onehot = F.one_hot(flat_e, n_experts)                    # [T*k, E]
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    return pos, pos < cap


def _take(t, *index):
    """``t[index]`` for plain index tensors.  A DTensor ``t`` is gathered
    whole (a departure from GSPMD, labelled ``moe_routing``) and indexed
    on each rank's copy: torch 2.11's DTensor has no working rule for the
    gather's backward (an ``index_put``)."""
    if not isinstance(t, DTensor):
        return t[index]
    mesh = t.device_mesh
    whole = [Replicate()] * mesh.ndim
    local = departure("moe_routing", lambda: t.redistribute(
        mesh, whole)).to_local()
    return DTensor.from_local(local[index], mesh, whole, run_check=False)


def moe_block(cfg: LMConfig, p: Params, x) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Capacity-bucketed top-k MoE with index-based dispatch.

    Returns (output, aux_load_balance_loss).  Token ids are scattered into
    an [E, C] capacity grid (pairs past capacity are dropped), rows are
    gathered, the experts run as batched products, and each (token,
    choice) reads its expert's row back.  All intermediates are linear in
    the token count.
    """
    B, S, d = x.shape
    T = B * S
    e, k = cfg.n_experts, cfg.top_k
    cap = int(max(1, (k * T * cfg.capacity_factor) // e))
    xt = x.reshape(T, d)
    logits = (xt @ p["router"]).float()                      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = _top_k(probs, k)                        # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    if isinstance(idx, DTensor):
        # DTensor has no rule for the routing's writes by index: the
        # choices are gathered whole (a departure from GSPMD) and every
        # rank routes every token
        mesh = idx.device_mesh
        idx = departure("moe_routing", lambda: idx.redistribute(
            mesh, [Replicate()] * mesh.ndim)).to_local()

    flat_e = idx.reshape(-1)                                 # [T*k]
    pos, keep = _capacity_slots(flat_e, e, cap)

    # scatter kept pairs into the [E, C] grid; dropped pairs go to a
    # spare column C, cut off below (no host sync to select them)
    tok_ids = torch.arange(T * k, device=x.device) // k
    token_idx = torch.full((e, cap + 1), T, dtype=torch.long,
                           device=x.device)                  # T = pad row
    token_idx[flat_e, torch.where(keep, pos, cap)] = tok_ids
    token_idx = token_idx[:, :cap]

    x_pad = torch.cat([xt, xt.new_zeros((1, d))])
    expert_in = _take(x_pad, token_idx)                      # [E, C, d]
    h = _silu(torch.bmm(expert_in, p["w1"]))
    h = h * torch.bmm(expert_in, p["w3"])
    expert_out = torch.bmm(h, p["w2"])                       # [E, C, d]

    pos_c = torch.clamp_max(pos, cap - 1)
    vals = _take(expert_out, flat_e, pos_c)                  # [T*k, d]
    vals = vals * keep[:, None].to(vals.dtype)
    y = (vals.reshape(T, k, d) * gate_vals[..., None].to(vals.dtype)).sum(1)

    # load-balancing aux loss (Switch/GShard)
    frac_tokens = F.one_hot(idx[:, 0], e).float().mean(0)
    frac_probs = probs.mean(0)
    aux = (frac_tokens * frac_probs).sum() * e
    return y.reshape(B, S, d), aux


def block(cfg: LMConfig, p: Params, x, positions):
    h = x + attention(cfg, p, rms_norm(x, p["ln1"]), positions)
    if cfg.is_moe:
        y, aux = moe_block(cfg, p, rms_norm(h, p["ln2"]))
    else:
        y = swiglu(p, rms_norm(h, p["ln2"]))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return h + y, aux


def _embed(params: Params, tokens):
    """The token embeddings: a gather from the table.  A DTensor table is
    gathered whole first and read through the ``embedding`` op: a lookup
    into vocab shards gives a masked partial sum that DTensor fails to
    reduce (torch 2.13), and the plain gather's backward, an accumulating
    ``index_put``, has no working sharding rule (torch 2.11).  Both
    gathers of the vocab dim are departures from GSPMD, labelled
    ``vocab_gather``."""
    table = params["embed"]
    if isinstance(table, DTensor):
        mesh = table.device_mesh
        return F.embedding(tokens, departure("vocab_gather", lambda: (
            table.redistribute(mesh, [Replicate()] * mesh.ndim))))
    return table[tokens]


def _head(cfg: LMConfig, params: Params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def forward(cfg: LMConfig, params: Params, tokens):
    """tokens [B, S] -> (logits [B, S, V], aux_loss).

    With ``cfg.remat`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward."""
    B, S = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        if remat:
            x, a = checkpoint(block, cfg, lp, x, positions,
                              use_reentrant=False)
        else:
            x, a = block(cfg, lp, x, positions)
        aux = aux + a
    x = rms_norm(x, params["ln_f"])
    return x @ _head(cfg, params), aux


def lm_loss(cfg: LMConfig, params: Params, tokens, targets,
            aux_weight: float = 0.01):
    logits, aux = forward(cfg, params, tokens)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # a DTensor's gather along its vocab shards cannot be reduced (torch
    # 2.13 builds a mask of the wrong rank), so the vocab dim is gathered
    # whole first; plain tensors pass through
    gold = batch_sharded(logits, "vocab_gather").gather(
        -1, targets[..., None].long())[..., 0]
    nll = (logz - gold).mean()
    return nll + aux_weight * aux


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

def cache_len(cfg: LMConfig, max_len: int) -> int:
    """Ring-buffer length: SWA models only ever need `window` entries."""
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device=None) -> Params:
    """An empty cache on ``device`` (``None``: the CUDA device)."""
    dev = _resolve_device(device)
    L = cache_len(cfg, max_len)
    shape = (cfg.n_layers, batch, L, cfg.n_kv_heads, cfg.d_head)
    cache = dict(pos=torch.full((cfg.n_layers, batch, L), -1,
                                dtype=torch.int32, device=dev))
    if cfg.kv_quant_int8:
        cache["k"] = torch.zeros(shape, dtype=torch.int8, device=dev)
        cache["v"] = torch.zeros(shape, dtype=torch.int8, device=dev)
        cache["k_scale"] = torch.zeros(shape[:-1], device=dev)
        cache["v_scale"] = torch.zeros(shape[:-1], device=dev)
    else:
        cache["k"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    return cache


def _quantize_kv(x):
    """x [..., dh] -> (int8 values, per-vector f32 scale)."""
    x32 = x.float()
    scale = x32.abs().amax(-1) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _cache_attention(cfg: LMConfig, q, k_cache, v_cache, pos_cache, pos,
                     k_scale=None, v_scale=None):
    """Attention of one query token against the (ring) cache, in f32.

    q [B, Hkv, G, dh]; caches [B, T, Hkv, dh].  Two paths:
      * dense: one product over the full cache;
      * chunked (cfg.decode_chunk): an online softmax over cache chunks,
        int8 chunks dequantized one at a time.
    """
    T = k_cache.shape[1]
    inv_sqrt = 1.0 / _sqrt_f32(cfg.d_head, q.device)
    q32 = q.float()

    def score_block(kc, vc, pc, ks, vs):
        k = kc.float()
        v = vc.float()
        if ks is not None:
            k = k * ks[..., None]
            v = v * vs[..., None]
        s = (q32 @ k.permute(0, 2, 3, 1)) * inv_sqrt       # [B, K, G, T]
        valid = (pc >= 0) & (pc <= pos[:, None])
        if cfg.sliding_window is not None:
            valid &= (pos[:, None] - pc) < cfg.sliding_window
        s = torch.where(valid[:, None, None, :], s, -math.inf)
        return s, v.permute(0, 2, 1, 3)                   # [B, K, T, dh]

    if cfg.decode_chunk is None or cfg.decode_chunk >= T:
        s, v = score_block(k_cache, v_cache, pos_cache, k_scale, v_scale)
        p = torch.softmax(s, dim=-1)
        return (p @ v).to(cfg.dtype)

    C = cfg.decode_chunk
    assert T % C == 0, (T, C)
    B, H, G, dh = q.shape
    m = torch.full((B, H, G), -math.inf, device=q.device)
    l = torch.zeros((B, H, G), device=q.device)
    acc = torch.zeros((B, H, G, dh), device=q.device)
    for c0 in range(0, T, C):
        sl = slice(c0, c0 + C)
        s, v = score_block(
            k_cache[:, sl], v_cache[:, sl], pos_cache[:, sl],
            None if k_scale is None else k_scale[:, sl],
            None if v_scale is None else v_scale[:, sl])
        m, l, acc = _online_step(m, l, acc, s, v)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(cfg.dtype)


def _write_slots(buf, li: int, bidx, slot, value) -> None:
    """``buf[li, bidx, slot] = value`` in place (``bidx`` is
    ``arange(B)``): row ``b`` of layer ``li``'s cache gets ``value[b]`` at
    slot ``slot[b]``.

    DTensor cannot write by index into a sharded dim in place, so on a
    DTensor cache each rank writes the rows it holds: the written values
    and slots are gathered whole (a departure from GSPMD, labelled
    ``cache_write``), and each local row takes its value where its slot
    lies in the rank's shard and keeps its own elsewhere (static shapes,
    no host sync)."""
    if not isinstance(buf, DTensor):
        buf[li, bidx, slot] = value
        return
    mesh = buf.device_mesh
    whole = [Replicate()] * mesh.ndim
    value, slot = (departure("cache_write", lambda t=t: t.redistribute(
        mesh, whole)).to_local() if isinstance(t, DTensor) else t
        for t in (value, slot))
    local = buf.to_local()
    _, offset = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    n_rows, n_slots = local.shape[1], local.shape[2]
    rows = torch.arange(n_rows, device=local.device)
    at = slot[rows + offset[1]] - offset[2]
    mine = (at >= 0) & (at < n_slots)
    at = torch.clamp(at, 0, n_slots - 1)
    mine = mine.reshape((-1,) + (1,) * (local.dim() - 3))
    local[li, rows, at] = torch.where(mine, value[rows + offset[1]],
                                      local[li, rows, at])


def decode_step(cfg: LMConfig, params: Params, cache: Params, token,
                pos) -> Tuple[torch.Tensor, Params]:
    """One decoding step: token [B], pos [B] -> (logits [B, V], cache).

    The cache is a ring buffer of length cache_len (== window for SWA
    models); absolute positions ride along for masking and RoPE.  This
    step writes slot ``pos % cache_len`` of ``cache`` in place and returns
    the same dict.
    """
    B = token.shape[0]
    x = _embed(params, token[:, None])                   # [B, 1, d]
    pos = pos.long()
    slot = pos % cache["k"].shape[2]                     # ring index
    bidx = torch.arange(B, device=x.device)
    quant = cfg.kv_quant_int8
    g = cfg.n_heads // cfg.n_kv_heads
    rope_tables = _rope_tables(pos[:, None], cfg, x.dtype)  # every layer's
    for li, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["ln1"])
        q, knew, vnew = _qkv(cfg, lp, h)
        q = _apply_rope(q, rope_tables)
        knew = _apply_rope(knew, rope_tables)
        if quant:
            kq, ks = _quantize_kv(knew[:, 0])
            vq, vs = _quantize_kv(vnew[:, 0])
            for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                              ("v_scale", vs)):
                _write_slots(cache[name], li, bidx, slot, val)
            scales = (cache["k_scale"][li], cache["v_scale"][li])
        else:
            _write_slots(cache["k"], li, bidx, slot, knew[:, 0])
            _write_slots(cache["v"], li, bidx, slot, vnew[:, 0])
            scales = (None, None)
        _write_slots(cache["pos"], li, bidx, slot, pos.to(torch.int32))
        qh = q.reshape(B, cfg.n_kv_heads, g, cfg.d_head)
        out = _cache_attention(cfg, qh, cache["k"][li], cache["v"][li],
                               cache["pos"][li], pos, *scales)
        out = out.reshape(B, 1, cfg.n_heads * cfg.d_head) @ lp["wo"]
        h2 = x + out
        if cfg.is_moe:
            y, _ = moe_block(cfg, lp, rms_norm(h2, lp["ln2"]))
        else:
            y = swiglu(lp, rms_norm(h2, lp["ln2"]))
        x = h2 + y
    x = rms_norm(x, params["ln_f"])
    logits = (x @ _head(cfg, params))[:, 0, :]
    return logits, cache


def prefill(cfg: LMConfig, params: Params, tokens, max_len: int):
    """Prefill: full forward + cache construction for subsequent decode.

    As in the reference, the cache it builds is never quantized, even
    under ``cfg.kv_quant_int8``."""
    B, S = tokens.shape
    L = cache_len(cfg, max_len)
    x = _embed(params, tokens)
    dev = x.device
    positions = torch.arange(S, device=dev).expand(B, S)
    keep = min(L, S)
    slot = positions[:, -keep:] % L
    bidx = torch.arange(B, device=dev)[:, None]
    kcs: List[torch.Tensor] = []
    vcs: List[torch.Tensor] = []
    pcs: List[torch.Tensor] = []
    for lp in params["layers"]:
        h = rms_norm(x, lp["ln1"])
        _, k, v = _qkv(cfg, lp, h)
        x2, _ = block(cfg, lp, x, positions)
        k = rope(k, positions, cfg)
        shape = (B, L, cfg.n_kv_heads, cfg.d_head)
        k_cache = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        v_cache = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        pos_cache = torch.full((B, L), -1, dtype=torch.int32, device=dev)
        k_cache[bidx, slot] = k[:, -keep:]
        v_cache[bidx, slot] = v[:, -keep:]
        pos_cache[bidx, slot] = positions[:, -keep:].to(torch.int32)
        kcs.append(k_cache)
        vcs.append(v_cache)
        pcs.append(pos_cache)
        x = x2
    x = rms_norm(x, params["ln_f"])
    logits = x @ _head(cfg, params)
    return logits, dict(k=torch.stack(kcs), v=torch.stack(vcs),
                        pos=torch.stack(pcs))
