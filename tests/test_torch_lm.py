"""The port's LM family (repro_torch.models.transformer) against the JAX
package's, on the same numpy inputs and the same weights (carried over by
``params_from_jax``): forward logits and aux, the loss and every
parameter's gradient, decode and prefill, the SWA ring, the blockwise and
chunked attention paths, MoE drops, int8 KV quantization, and the five
configurations with their parameter counts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as JT
from repro_torch.configs import LM_ARCHS
from repro_torch.errors import NoCudaDevice
from repro_torch.models import transformer as TT

ATOL, RTOL = 2e-4, 2e-3         # as tests/test_models_lm.py


def _tiny(**kw):
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                d_ff=128, vocab=97)
    base.update(kw)
    return TT.LMConfig(**base)


# the five configurations of tests/test_models_lm.py, then the five smoke
# configurations of the architectures
CFGS = {
    "dense": _tiny(),
    "dense_bias_partial_rope": _tiny(qkv_bias=True, rope_pct=0.5),
    "mha": _tiny(n_kv_heads=4),
    "swa": _tiny(sliding_window=6),
    "moe": _tiny(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=8.0),
    **{f"smoke:{aid}": arch.smoke_cfg for aid, arch in LM_ARCHS.items()},
}


def jax_cfg(cfg: TT.LMConfig) -> JT.LMConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["dtype"] = {torch.float32: jnp.float32,
                   torch.bfloat16: jnp.bfloat16}[cfg.dtype]
    return JT.LMConfig(**kw)


def reference_tree(jc: JT.LMConfig, seed: int):
    """Weights in the reference's parameter tree (layers stacked), made
    with numpy from ``seed``: normal at the reference init's scales
    (1/sqrt(fan-in), the embedding 0.02), and norm scales and biases
    around 1 and 0 so that they matter.  The shapes come from tracing
    ``init_params`` (no compile)."""
    shapes = jax.eval_shape(lambda: JT.init_params(jc, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    dtype = np.dtype(jc.dtype)

    def leaf(path, sds):
        name = path[-1].key
        if name in ("ln1", "ln2", "ln_f"):
            a = 1.0 + rng.normal(scale=0.1, size=sds.shape)
        elif name in ("bq", "bk", "bv"):
            a = rng.normal(scale=0.1, size=sds.shape)
        else:
            scale = 0.02 if name == "embed" else \
                1.0 / np.sqrt(sds.shape[1 if path[0].key == "layers" else 0])
            a = rng.normal(scale=scale, size=sds.shape)
        return a.astype(np.float32).astype(dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_params(cfg: TT.LMConfig, seed: int = 0):
    """(JAX params, port params): the same numpy weights in both."""
    jp = reference_tree(jax_cfg(cfg), seed)
    return (jax.tree.map(jnp.asarray, jp),
            TT.params_from_jax(cfg, jp, device="cpu"))


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def port_grads(cfg, tp, toks):
    """The port's loss on toks; its gradients land in each ``.grad``."""
    for k in ("embed", "ln_f", "lm_head"):
        if k in tp:
            tp[k].requires_grad_(True)
    for layer in tp["layers"]:
        for v in layer.values():
            v.requires_grad_(True)
    loss = TT.lm_loss(cfg, tp, torch.from_numpy(toks[:, :-1]),
                      torch.from_numpy(toks[:, 1:]))
    loss.backward()
    return loss


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

def _reference_run(jc, jp, toks):
    """JAX's forward on toks[:, :-1], and its loss and gradients against
    toks[:, 1:], as one compiled program."""
    def run(p):
        return (JT.forward(jc, p, toks[:, :-1]),
                jax.value_and_grad(lambda q: JT.lm_loss(
                    jc, q, toks[:, :-1], toks[:, 1:]))(p))
    return jax.jit(run)(jp)


@pytest.mark.parametrize("name", list(CFGS))
def test_forward_loss_and_grads_match_reference(name):
    cfg = CFGS[name]
    jc = jax_cfg(cfg)
    jp, tp = make_params(cfg)
    toks = tokens(cfg, (2, 12))

    (j_logits, j_aux), (j_loss, j_grads) = _reference_run(jc, jp, toks)
    with torch.no_grad():
        t_logits, t_aux = TT.forward(cfg, tp, torch.from_numpy(toks[:, :-1]))
    close(t_logits, j_logits)
    close(t_aux, j_aux)
    t_loss = port_grads(cfg, tp, toks)
    close(t_loss.detach(), j_loss)
    for k in ("embed", "ln_f", "lm_head"):
        if k in tp:
            close(tp[k].grad, j_grads[k])
    for k, stacked in j_grads["layers"].items():
        for i, layer in enumerate(tp["layers"]):
            close(layer[k].grad, stacked[i])


def test_remat_gives_the_same_gradients():
    cfg = dataclasses.replace(CFGS["moe"], remat=True)
    _, tp = make_params(cfg)
    _, tq = make_params(dataclasses.replace(cfg, remat=False))
    toks = tokens(cfg, (2, 12))
    port_grads(cfg, tp, toks)
    port_grads(dataclasses.replace(cfg, remat=False), tq, toks)
    for a, b in zip(tp["layers"], tq["layers"]):
        for k in a:
            assert torch.equal(a[k].grad, b[k].grad), k


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

def _decode_both(cfg, jp, tp, toks, max_len):
    jc = jax_cfg(cfg)
    B, S = toks.shape
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(jc, p, c, t, pos))
    jcache = JT.init_cache(jc, B, max_len)
    tcache = TT.init_cache(cfg, B, max_len, device="cpu")
    j_out, t_out = [], []
    with torch.no_grad():
        for i in range(S):
            pos = np.full((B,), i, np.int32)
            lg, jcache = step(jp, jcache, toks[:, i], pos)
            j_out.append(np.asarray(lg))
            lg, tcache = TT.decode_step(cfg, tp, tcache,
                                        torch.from_numpy(toks[:, i]),
                                        torch.from_numpy(pos))
            t_out.append(lg.numpy())
    return np.stack(j_out, 1), np.stack(t_out, 1), jcache, tcache


def _check_cache(jcache, tcache):
    assert set(jcache) == set(tcache)
    for k, v in jcache.items():
        if k == "pos" or np.asarray(v).dtype == np.int8:
            np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(v))
        else:
            close(tcache[k], v)


@pytest.mark.parametrize("name", list(CFGS))
def test_decode_steps_match_reference(name):
    cfg = CFGS[name]
    jp, tp = make_params(cfg)
    toks = tokens(cfg, (2, 10))
    j_dec, t_dec, jcache, tcache = _decode_both(cfg, jp, tp, toks, 16)
    close(t_dec, j_dec)
    _check_cache(jcache, tcache)
    if not cfg.is_moe or cfg.capacity_factor >= cfg.n_experts / cfg.top_k:
        with torch.no_grad():       # no drops: decode == forward
            full, _ = TT.forward(cfg, tp, torch.from_numpy(toks))
        close(t_dec, full)


@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_and_continuation_match_reference(name):
    cfg = CFGS[name]
    jc = jax_cfg(cfg)
    jp, tp = make_params(cfg)
    toks = tokens(cfg, (2, 12))
    pos = np.full((2,), 8, np.int32)

    @jax.jit
    def reference(p):
        lg, cache = JT.prefill(jc, p, toks[:, :8], 16)
        return lg, cache, JT.decode_step(jc, p, cache, toks[:, 8], pos)[0]

    j_lg, jcache, j_next = reference(jp)
    with torch.no_grad():
        t_lg, tcache = TT.prefill(cfg, tp, torch.from_numpy(toks[:, :8]), 16)
    close(t_lg, j_lg)
    _check_cache(jcache, tcache)
    with torch.no_grad():
        t_next, _ = TT.decode_step(cfg, tp, tcache,
                                   torch.from_numpy(toks[:, 8]),
                                   torch.from_numpy(pos))
    close(t_next, j_next)


def test_prefill_builds_a_plain_cache_under_int8():
    """A reference quirk kept: prefill's cache is never quantized."""
    cfg = _tiny(kv_quant_int8=True)
    _, tp = make_params(cfg)
    with torch.no_grad():
        _, cache = TT.prefill(cfg, tp, torch.from_numpy(tokens(cfg, (1, 4))),
                              8)
    assert cache["k"].dtype == torch.float32 and "k_scale" not in cache


def test_sliding_window_ring_at_window_4():
    cfg = _tiny(sliding_window=4)
    jp, tp = make_params(cfg)
    toks = tokens(cfg, (1, 12), seed=2)
    j_dec, t_dec, jcache, tcache = _decode_both(cfg, jp, tp, toks, 12)
    assert tcache["k"].shape[2] == 4
    close(t_dec, j_dec)
    _check_cache(jcache, tcache)
    with torch.no_grad():
        full, _ = TT.forward(cfg, tp, torch.from_numpy(toks))
    close(t_dec, full)


# blockwise attention: dense, GQA with partial rope, SWA (some block pairs
# skipped), MoE
CHUNKED = {
    "dense": _tiny(attn_chunk=4),
    "partial_rope": _tiny(qkv_bias=True, rope_pct=0.5, attn_chunk=4),
    "swa": _tiny(sliding_window=5, attn_chunk=4),
    "moe": _tiny(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=8.0,
                 attn_chunk=4),
}


@pytest.mark.parametrize("name", list(CHUNKED))
def test_blockwise_attention_matches_reference(name):
    cfg = CHUNKED[name]
    jc = jax_cfg(cfg)
    jp, tp = make_params(cfg)
    toks = tokens(cfg, (2, 17))
    (j_logits, _), (j_loss, j_grads) = _reference_run(jc, jp, toks)
    with torch.no_grad():
        t_logits, _ = TT.forward(cfg, tp, torch.from_numpy(toks[:, :-1]))
        plain, _ = TT.forward(dataclasses.replace(cfg, attn_chunk=None), tp,
                              torch.from_numpy(toks[:, :-1]))
    close(t_logits, j_logits)
    close(t_logits, plain)
    t_loss = port_grads(cfg, tp, toks)
    close(t_loss.detach(), j_loss)
    for k, stacked in j_grads["layers"].items():
        for i, layer in enumerate(tp["layers"]):
            close(layer[k].grad, stacked[i])


# chunked cache attention, plain and int8, dense and SWA
DECODE_CHUNKED = {
    "chunk": _tiny(decode_chunk=4),
    "chunk_int8": _tiny(decode_chunk=4, kv_quant_int8=True),
    "dense_int8": _tiny(kv_quant_int8=True),
    "swa_chunk_int8": _tiny(sliding_window=8, decode_chunk=4,
                            kv_quant_int8=True),
}


@pytest.mark.parametrize("name", list(DECODE_CHUNKED))
def test_chunked_and_int8_decode_match_reference(name):
    cfg = DECODE_CHUNKED[name]
    jp, tp = make_params(cfg)
    toks = tokens(cfg, (2, 14), seed=3)
    j_dec, t_dec, jcache, tcache = _decode_both(cfg, jp, tp, toks, 16)
    close(t_dec, j_dec)
    _check_cache(jcache, tcache)


def test_moe_capacity_drops_the_reference_pairs():
    """capacity_factor=1.0 drops pairs: the same pairs are kept as in JAX,
    and the block's output and aux loss agree."""
    cfg = _tiny(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=1.0)
    jc = jax_cfg(cfg)
    jp, tp = make_params(cfg)
    x = np.random.default_rng(4).normal(size=(3, 8, cfg.d_model)).astype(
        np.float32)
    lp_j = jax.tree.map(lambda a: a[0], jp["layers"])
    y_j, aux_j = JT.moe_block(jc, lp_j, jnp.asarray(x))
    with torch.no_grad():
        y_t, aux_t = TT.moe_block(cfg, tp["layers"][0], torch.from_numpy(x))
    close(y_t, y_j)
    close(aux_t, aux_j)
    # the kept pairs, by the reference's own formula on its own routing
    T, k, e = 24, cfg.top_k, cfg.n_experts
    cap = int(max(1, (k * T * cfg.capacity_factor) // e))
    probs = jax.nn.softmax((jnp.asarray(x).reshape(T, -1)
                            @ lp_j["router"]).astype(jnp.float32))
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx.reshape(-1), e, dtype=jnp.float32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1.0
    keep_j = np.asarray(pos.astype(jnp.int32) < cap)
    with torch.no_grad():
        logits = torch.from_numpy(x).reshape(T, -1) @ tp["layers"][0]["router"]
        _, idx_t = TT._top_k(torch.softmax(logits.float(), -1), k)
        _, keep_t = TT._capacity_slots(idx_t.reshape(-1), e, cap)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    assert not keep_j.all()


def test_top_k_ties_go_to_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]],
                     np.float32)
    _, idx_j = jax.lax.top_k(jnp.asarray(probs), 2)
    _, idx_t = TT._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


def test_quantize_kv_is_bit_equal():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 5, 4, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                                 # all-zero vector
    x[1, 0, 0] = np.arange(16) - 7.5                 # halves after scaling
    x[2, 0, 0, :] = 1.0
    x[2, 0, 0, 3] = 127.0 / 2.5                      # exact .5 quotients
    for arr in (x, x.astype(jnp.bfloat16)):
        q_j, s_j = JT._quantize_kv(jnp.asarray(arr))
        t_in = (torch.from_numpy(x).to(torch.bfloat16)
                if arr.dtype != np.float32 else torch.from_numpy(x))
        q_t, s_t = TT._quantize_kv(t_in)
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", list(LM_ARCHS))
def test_configs_equal_the_reference(arch_id):
    ours, ref = LM_ARCHS[arch_id], jconfigs.get_arch(arch_id)
    assert ours.long_ok == ref.long_ok
    assert ours.kv_quant_decode == ref.kv_quant_decode
    for which in ("base_cfg", "smoke_cfg"):
        a, b = getattr(ours, which), getattr(ref, which)
        assert dataclasses.asdict(jax_cfg(a)) == dataclasses.asdict(b)
        assert a.n_params() == b.n_params()
        assert a.n_active_params() == b.n_active_params()
    # parameter tree: the reference's shapes, unstacked
    cfg = ours.smoke_cfg
    shapes = jax.eval_shape(lambda: JT.init_params(jax_cfg(cfg),
                                                   jax.random.key(0)))
    tp = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(tp) == set(shapes)
    assert tuple(tp["embed"].shape) == shapes["embed"].shape
    for k, s in shapes["layers"].items():
        assert len(tp["layers"]) == s.shape[0]
        assert all(tuple(layer[k].shape) == s.shape[1:]
                   for layer in tp["layers"])


def test_params_from_jax_carries_bf16_exactly():
    cfg = dataclasses.replace(CFGS["moe"], dtype=torch.bfloat16)
    jp = reference_tree(jax_cfg(cfg), 3)
    tp = TT.params_from_jax(cfg, jp, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["layers"][1]["w2"].float().numpy(),
        np.asarray(jp["layers"]["w2"][1]).astype(np.float32))


def test_bf16_forward_close_to_reference():
    """The mixed-precision order, in bf16: within a few bf16 ulps."""
    cfg = dataclasses.replace(CFGS["dense_bias_partial_rope"],
                              dtype=torch.bfloat16)
    jc = jax_cfg(cfg)
    jp = reference_tree(jc, 0)
    tp = TT.params_from_jax(cfg, jp, device="cpu")
    toks = tokens(cfg, (2, 12))
    j_logits, _ = JT.forward(jc, jp, toks)
    with torch.no_grad():
        t_logits, _ = TT.forward(cfg, tp, torch.from_numpy(toks))
    close(t_logits.float(), np.asarray(j_logits).astype(np.float32),
          atol=3e-2, rtol=3e-2)


def test_mesh_hints_and_missing_card_raise():
    """The mesh hints (``dp_axes``) are accepted and change nothing on
    plain tensors; without a card the entry points raise."""
    cfg = dataclasses.replace(CFGS["dense"], attn_chunk=4)
    hinted = dataclasses.replace(cfg, dp_axes=("data",))
    tp = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(tokens(cfg, (2, 12)))
    with torch.no_grad():
        assert torch.equal(TT.forward(cfg, tp, toks)[0],
                           TT.forward(hinted, tp, toks)[0])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = CFGS["dense"]
    with pytest.raises(NoCudaDevice):
        TT.init_params(cfg, torch.Generator())
    with pytest.raises(NoCudaDevice):
        TT.init_cache(cfg, 1, 8)
