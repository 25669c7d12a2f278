"""BERT4Rec (arXiv:1904.06690): bidirectional transformer over item
sequences with a masked-item (Cloze) objective, plus the three serving
paths of the assigned shape set (online p99, offline bulk, retrieval
against ~1M candidates).

It computes what ``repro.models.bert4rec`` computes, in the same dtypes:
layer norm with the population variance, the scores' softmax in f32 with
the PAD mask applied to the exponent's input, GELU in its tanh form (JAX's
default), and top-k with ties to the lower index.  The blocks are a list
of dicts; :func:`params_from_jax` unstacks the reference's block axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..core.session import _resolve_device
from ..launch.constraints import P, hint, placements
from ..recsys.embedding import embedding_lookup
from ..tree import from_numpy, tree_map

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000     # embedding-table rows (incl. PAD=0, MASK=1)
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff_mult: int = 4
    dtype: Any = torch.float32
    # two-stage top-k: a top-k in each of ``topk_ways`` equal slices of the
    # item axis, then one over the ways * k survivors; the slices run on
    # the ranks of the "model" mesh dim when the scores are a DTensor
    topk_ways: int = 0

    MASK: int = 1
    PAD: int = 0

    def n_params(self) -> int:
        d = self.embed_dim
        per_block = 4 * d * d + 2 * d * (d * self.d_ff_mult) + 4 * d
        return self.n_items * d + self.seq_len * d + \
            self.n_blocks * per_block + 2 * d


def init_params(cfg: Bert4RecConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters at the reference's shapes and scales, drawn from
    ``generator`` on ``device`` (``None``: the CUDA device, raising
    :class:`~repro_torch.errors.NoCudaDevice` without one)."""
    dev = _resolve_device(device)
    d, ff = cfg.embed_dim, cfg.d_ff_mult * cfg.embed_dim

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(cfg.dtype)

    def ones():
        return torch.ones((d,), dtype=cfg.dtype, device=dev)

    return dict(
        item_embed=normal((cfg.n_items, d), 0.02),
        pos_embed=normal((cfg.seq_len, d), 0.02),
        ln_f=ones(),
        blocks=[dict(ln1=ones(), ln2=ones(),
                     wqkv=normal((d, 3 * d), 1 / np.sqrt(d)),
                     wo=normal((d, d), 1 / np.sqrt(d)),
                     w1=normal((d, ff), 1 / np.sqrt(d)),
                     w2=normal((ff, d), 1 / np.sqrt(ff)))
                for _ in range(cfg.n_blocks)],
    )


def params_from_jax(cfg: Bert4RecConfig, tree, device=None) -> Params:
    """The reference's parameters (numpy arrays, blocks stacked on axis 0)
    on ``device``, value for value."""
    p = from_numpy(tree, _resolve_device(device))
    p["blocks"] = [tree_map(lambda x: x[i], p["blocks"])
                   for i in range(cfg.n_blocks)]
    return p


def _ln(x, scale, eps=1e-6):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale


def encode(cfg: Bert4RecConfig, params: Params, items) -> torch.Tensor:
    """items [B, S] int -> hidden states [B, S, d].  Bidirectional
    attention with PAD masking (encoder-only: no causal mask, no decode)."""
    B, S = items.shape
    d, h = cfg.embed_dim, cfg.n_heads
    dh = d // h
    x = embedding_lookup(params["item_embed"], items)
    x = x + params["pos_embed"][None, :S, :]
    live = (items != cfg.PAD)[:, None, None, :]             # [B, 1, 1, S]
    scale = float(np.sqrt(np.float32(dh)))                  # as f32
    for p in params["blocks"]:
        hx = _ln(x, p["ln1"])
        qkv = hx @ p["wqkv"]
        q, k, v = [z.reshape(B, S, h, dh)
                   for z in torch.split(qkv, d, dim=-1)]
        scores = torch.einsum("bshd,bthd->bhst", q, k) / scale
        scores = scores.to(torch.float32)
        smax = torch.amax(torch.where(live, scores, -1e30), dim=-1,
                          keepdim=True)
        smax = torch.clamp(smax, min=-1e30)
        # clamp the exp *input* (not output): exp of the untaken branch
        # would compute inf and poison the backward with inf * 0 = nan
        ex = torch.exp(torch.where(live, scores - smax, -1e4))
        probs = (ex / torch.clamp(torch.sum(ex, dim=-1, keepdim=True),
                                  min=1e-9)).to(x.dtype)
        att = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, d)
        x = x + att @ p["wo"]
        hx = _ln(x, p["ln2"])
        x = x + F.gelu(hx @ p["w1"], approximate="tanh") @ p["w2"]
    return _ln(x, params["ln_f"])


def masked_item_loss(cfg: Bert4RecConfig, params: Params, items, targets,
                     mask) -> torch.Tensor:
    """Cloze objective: items with MASK tokens, targets the original ids,
    mask [B, S] bool marking positions to predict."""
    hidden = encode(cfg, params, items)                      # [B, S, d]
    logits = (hidden @ params["item_embed"].T).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].long(),
                                dim=-1)[..., 0]
    mask = mask.to(torch.float32)
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def sampled_masked_loss(cfg: Bert4RecConfig, params: Params, items,
                        mask_positions, targets, negatives) -> torch.Tensor:
    """Production-scale Cloze loss: gather the masked positions, score
    against (shared) sampled negatives + the gold item instead of the full
    1M-row softmax (sampled softmax a la Covington/Yi et al.).

    items [B, S]; mask_positions [B, M] (indices into S); targets [B, M];
    negatives [n_neg] shared item ids.
    """
    hidden = encode(cfg, params, items)                       # [B, S, d]
    h = torch.take_along_dim(hidden, mask_positions[..., None].long(), dim=1)
    neg_vecs = embedding_lookup(params["item_embed"], negatives)   # [n, d]
    pos_vecs = embedding_lookup(params["item_embed"], targets)     # [B, M, d]
    neg_logits = torch.einsum("bmd,nd->bmn", h, neg_vecs).to(torch.float32)
    pos_logit = torch.sum(h * pos_vecs, dim=-1).to(torch.float32)
    logits = torch.cat([pos_logit[..., None], neg_logits], dim=-1)
    logz = torch.logsumexp(logits, dim=-1)
    return torch.mean(logz - pos_logit)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` on the last axis: the k largest in descending order,
    equal values ordered by index, and where values equal to the k-th tie
    across the cut, the lower indices kept.  ``torch.topk`` promises
    neither; its picks are repaired, which reads ``x`` once more and
    waits for the device once.  A DTensor goes through
    :func:`_top_k_rows`; a meta tensor (the dry run) holds no values and
    so no tie to repair."""
    if isinstance(x, DTensor):
        return _top_k_rows(x, k)
    v, i = torch.topk(x, k, dim=-1)
    x2, v2, i2 = (t.reshape(-1, t.shape[-1]) for t in (x, v, i))
    kth = v2[:, -1:]
    n_in = (v2 == kth).sum(-1)
    cut = [] if x.is_meta else \
        torch.nonzero((x2 == kth).sum(-1) > n_in)[:, 0].tolist()
    for r in cut:                        # rare: a tie across the cut
        n = int(n_in[r])
        i2[r, k - n:] = torch.nonzero(x2[r] == kth[r])[:n, 0]
    i2, perm = torch.sort(i2, dim=-1)
    v2 = torch.gather(v2, -1, perm)
    v2, perm = torch.sort(v2, dim=-1, descending=True, stable=True)
    i2 = torch.gather(i2, -1, perm)
    return v2.reshape(v.shape), i2.reshape(i.shape)


def _top_k_rows(x: DTensor, k: int):
    """:func:`_top_k` of a DTensor: its rows stay where they lie, the last
    axis is gathered whole, and each rank repairs its own rows' picks
    (``local_map``).  DTensor has no sharding rule for the repair's
    ``nonzero``, whose size depends on the data."""
    mesh = x.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim < x.ndim - 1 else Replicate()
            for p in x.placements]
    return local_map(lambda block: _top_k(block, k),
                     out_placements=(rows, rows), in_placements=(rows,),
                     device_mesh=mesh)(x.redistribute(mesh, rows))


def _topk_ways_sharded(scores, k: int, W: int):
    """The two-stage top-k over a mesh: the ways' slices of the item axis
    sit on "model" and the rows on "data", each rank takes the top-k of
    the slices it holds (``local_map``: local by construction, as the
    reference's ``shard_map``), only the [rows, ways * k] survivors are
    gathered over "model", and each rank finishes its rows."""
    mesh = scores.device_mesh
    rows, V = scores.shape
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if W % sizes["model"] or rows % sizes["data"]:
        raise ValueError(f"{W} ways and {rows} rows do not split evenly "
                         f"over the mesh {sizes}")
    ways = placements(P("model", "data", None), mesh)
    s3 = hint(scores.reshape(rows, W, V // W).transpose(0, 1),
              "model", "data", None)                     # [W, rows, V/W]
    v_loc, i_loc = local_map(lambda block: _top_k(block, k),
                             out_placements=(ways, ways),
                             in_placements=(ways,), device_mesh=mesh)(s3)
    by_rows = placements(P(None, "data", None), mesh)

    def finish(v_l, i_l):                                # [W, rows', k]
        r = v_l.shape[1]
        i_l = i_l + (torch.arange(W, device=i_l.device) * (V // W)
                     )[:, None, None]
        v_all = v_l.transpose(0, 1).reshape(r, W * k)
        i_all = i_l.transpose(0, 1).reshape(r, W * k)
        v, j = _top_k(v_all, k)                          # tiny global pass
        return v, torch.gather(i_all, 1, j)

    out = placements(P("data", None), mesh)
    return local_map(finish, out_placements=(out, out),
                     in_placements=(by_rows, by_rows), device_mesh=mesh)(
        v_loc.redistribute(mesh, by_rows), i_loc.redistribute(mesh, by_rows))


def _topk_scores(cfg: Bert4RecConfig, scores, k: int):
    """Exact top-k; with cfg.topk_ways, two-stage: a top-k in each of the
    ways' slices of the item axis, then one over the [rows, ways*k]
    survivors.  Both give ``lax.top_k``'s answer.  On a DTensor whose
    mesh has "model" and "data" dims the first stage runs where the
    slices live (:func:`_topk_ways_sharded`); otherwise on one device."""
    if not cfg.topk_ways:
        return _top_k(scores, k)
    rows, V = scores.shape
    W = cfg.topk_ways
    if V % W:
        raise ValueError(f"topk_ways {W} does not divide {V} items")
    if isinstance(scores, DTensor) and {"model", "data"} <= set(
            scores.device_mesh.mesh_dim_names or ()):
        return _topk_ways_sharded(scores, k, W)
    v_loc, i_loc = _top_k(scores.reshape(rows, W, V // W), k)  # [rows, W, k]
    i_loc = i_loc + (torch.arange(W, device=scores.device) * (V // W)
                     )[None, :, None]
    v_all = v_loc.reshape(rows, W * k)
    i_all = i_loc.reshape(rows, W * k)
    v, j = _top_k(v_all, k)                               # tiny global pass
    return v, torch.gather(i_all, 1, j)


def score_topk(cfg: Bert4RecConfig, params: Params, items, k: int = 100,
               chunk: int = 4096):
    """Offline bulk scoring: top-k items per row, the batch processed in
    chunks of rows so the [chunk, n_items] logits block — not
    [B, n_items] — is the peak intermediate.  items [B, S] -> (values
    [B, k], item ids [B, k] int64); the outputs are allocated once and
    filled chunk by chunk.  DTensor chunks are concatenated instead: a
    plain tensor cannot be written in place from a DTensor."""
    B = items.shape[0]
    if isinstance(items, DTensor):
        parts = [_topk_scores(cfg, score_next(cfg, params,
                                              items[lo:lo + chunk]), k)
                 for lo in range(0, B, chunk)]
        return tuple(torch.cat(t) for t in zip(*parts))
    vals = torch.empty((B, k), dtype=params["item_embed"].dtype,
                       device=items.device)
    idx = torch.empty((B, k), dtype=torch.int64, device=items.device)
    for lo in range(0, B, chunk):
        v, i = _topk_scores(cfg, score_next(cfg, params,
                                            items[lo:lo + chunk]), k)
        vals[lo:lo + chunk] = v
        idx[lo:lo + chunk] = i
    return vals, idx


def score_next(cfg: Bert4RecConfig, params: Params, items) -> torch.Tensor:
    """Serving: append MASK, score all items.  items [B, S] -> [B, n_items].
    Used by serve_p99 (B=512) and serve_bulk (B=262144)."""
    hidden = encode(cfg, params, items)
    last = hidden[:, -1, :]                                   # MASK position
    return last @ params["item_embed"].T


def score_candidates(cfg: Bert4RecConfig, params: Params, items,
                     candidates) -> torch.Tensor:
    """Retrieval: one query against a candidate set (batched dot, no loop).
    items [1, S]; candidates [n_cand] -> scores [n_cand]."""
    hidden = encode(cfg, params, items)
    q = hidden[:, -1, :]                                      # [1, d]
    cand_vecs = embedding_lookup(params["item_embed"], candidates)
    return (cand_vecs @ q[0]).to(torch.float32)
