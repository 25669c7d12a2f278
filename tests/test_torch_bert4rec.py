"""The port's bert4rec and embedding substrate (repro_torch.models.bert4rec,
repro_torch.recsys) against the JAX package's, on the same numpy inputs and
the same weights (carried over by ``params_from_jax``): the lookups and
every ``embedding_bag`` mode with empty bags; ``encode``, both losses and
their gradients; ``score_next``, ``score_candidates`` and ``score_topk``
(one-stage and two-stage, with ties); the configurations and registry.
Then the reference's property test of the PAD mask, on the port.

Tolerances: indices bit-equal; f32 values within rtol 1e-4 and atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.families import recsys as jfam
from repro.models import bert4rec as JB
from repro.recsys import embedding as jemb
from repro_torch.configs import RECSYS_ARCHS
from repro_torch.configs.families import recsys as tfam
from repro_torch.errors import NoCudaDevice
from repro_torch.models import bert4rec as TB
from repro_torch.recsys import embedding as temb
from repro_torch.train.trainer import _value_and_grad
from repro_torch.tree import flatten

RTOL, ATOL = 1e-4, 1e-5          # f32
SMOKE = RECSYS_ARCHS["bert4rec"].smoke_cfg
JSMOKE = jconfigs.ARCHS["bert4rec"].smoke_cfg
DIMS = tfam.REDUCED


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def trees_close(got, want):
    gp, gl = flatten(got)
    wp, wl = flatten(want)
    assert gp == wp
    for path, g, w in zip(gp, gl, wl):
        try:
            close(g, w)
        except AssertionError as e:
            raise AssertionError(f"leaf {path}: {e}") from None


def jax_cfg(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["dtype"] = jnp.float32
    return JB.Bert4RecConfig(**kw)


def weights(cfg, seed=0):
    """The reference's initial tree as numpy, with the norm scales moved
    off 1 so that they matter."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        JB.init_params(jax_cfg(cfg), jax.random.key(seed)))
    for name in ("ln1", "ln2"):
        tree["blocks"][name] = tree["blocks"][name] + rng.normal(
            scale=0.1, size=tree["blocks"][name].shape).astype(np.float32)
    tree["ln_f"] = tree["ln_f"] + rng.normal(
        scale=0.1, size=tree["ln_f"].shape).astype(np.float32)
    return tree


def both(cfg, seed=0):
    tree = weights(cfg, seed)
    return (jax_cfg(cfg), jax.tree.map(jnp.asarray, tree),
            TB.params_from_jax(cfg, tree, device="cpu"))


def sequences(cfg, batch, seed, n_pad=3):
    """Item sequences with ``n_pad`` leading PADs in every other row and
    MASK last, as the serving paths see them."""
    rng = np.random.default_rng(seed)
    items = rng.integers(2, cfg.n_items, (batch, cfg.seq_len)).astype(
        np.int64)
    items[::2, :n_pad] = cfg.PAD
    items[:, -1] = cfg.MASK
    return items


# --- the embedding substrate ---------------------------------------------------

def _bags():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = np.asarray([1, 2, 3, 10, 10, 49, 7], np.int64)
    offsets = np.asarray([0, 0, 0, 2, 2, 4, 4], np.int64)  # bags 1, 3 empty
    w = rng.normal(size=len(ids)).astype(np.float32)
    return table, ids, offsets, w


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "weighted"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode, weighted):
    table, ids, offsets, w = _bags()
    want = jemb.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              jnp.asarray(offsets), 5, mode,
                              weights=jnp.asarray(w) if weighted else None)
    got = temb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(offsets), 5, mode,
                             weights=torch.from_numpy(w) if weighted
                             else None)
    close(got, want)
    empty = got[[1, 3]].numpy()
    assert (np.isneginf(empty) if mode == "max" else empty == 0).all()


def test_lookups_match_reference():
    table, _, _, _ = _bags()
    ids = np.random.default_rng(3).integers(0, 50, (4, 5))
    want = jemb.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))
    close(temb.embedding_lookup(torch.from_numpy(table),
                                torch.from_numpy(ids)), want)
    flat = ids.reshape(-1)
    close(temb.onehot_lookup(torch.from_numpy(table), torch.from_numpy(flat)),
          jemb.onehot_lookup(jnp.asarray(table), jnp.asarray(flat)))


# --- encode and the losses --------------------------------------------------------

def test_encode_matches_reference():
    jc, jp, tp = both(SMOKE)
    items = sequences(SMOKE, 4, seed=4)
    want = jax.jit(lambda p: JB.encode(jc, p, jnp.asarray(items)))(jp)
    with torch.no_grad():
        close(TB.encode(SMOKE, tp, torch.from_numpy(items)), want)


def test_masked_item_loss_and_grads_match_reference():
    jc, jp, tp = both(SMOKE, seed=5)
    rng = np.random.default_rng(5)
    targets = sequences(SMOKE, 4, seed=6)
    mask = rng.random(targets.shape) < 0.2
    mask[:, 0] = True
    items = np.where(mask, SMOKE.MASK, targets)

    def jloss(p):
        return JB.masked_item_loss(jc, p, jnp.asarray(items),
                                   jnp.asarray(targets), jnp.asarray(mask))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tl, tg = _value_and_grad(
        lambda p, b: TB.masked_item_loss(SMOKE, p, b["items"], b["targets"],
                                         b["mask"]),
        tp, dict(items=torch.from_numpy(items),
                 targets=torch.from_numpy(targets),
                 mask=torch.from_numpy(mask)))
    close(tl, jl)
    trees_close(tg, TB.params_from_jax(SMOKE, jax.tree.map(np.asarray, jg),
                                       device="cpu"))


def test_sampled_masked_loss_and_grads_match_reference():
    """The train_batch cell's loss at its REDUCED dims: masked positions,
    their targets and shared negatives."""
    d = DIMS["train_batch"]
    jc, jp, tp = both(SMOKE, seed=7)
    rng = np.random.default_rng(7)
    targets = sequences(SMOKE, d["batch"], seed=8)
    pos = np.stack([rng.choice(SMOKE.seq_len, d["n_mask"], replace=False)
                    for _ in range(d["batch"])])
    tgt = np.take_along_axis(targets, pos, axis=1)
    items = targets.copy()
    np.put_along_axis(items, pos, SMOKE.MASK, axis=1)
    neg = rng.integers(2, SMOKE.n_items, d["n_neg"])

    def jloss(p):
        return JB.sampled_masked_loss(jc, p, jnp.asarray(items),
                                      jnp.asarray(pos), jnp.asarray(tgt),
                                      jnp.asarray(neg))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tl, tg = _value_and_grad(
        lambda p, b: TB.sampled_masked_loss(SMOKE, p, b["items"], b["pos"],
                                            b["tgt"], b["neg"]),
        tp, {k: torch.from_numpy(v) for k, v in
             dict(items=items, pos=pos, tgt=tgt, neg=neg).items()})
    close(tl, jl)
    trees_close(tg, TB.params_from_jax(SMOKE, jax.tree.map(np.asarray, jg),
                                       device="cpu"))


# --- the serving paths --------------------------------------------------------------

def test_score_next_and_candidates_match_reference():
    jc, jp, tp = both(SMOKE, seed=9)
    items = sequences(SMOKE, DIMS["serve_p99"]["batch"], seed=10)
    cands = np.random.default_rng(11).integers(
        0, SMOKE.n_items, DIMS["retrieval_cand"]["n_cand"])
    want = jax.jit(lambda p: JB.score_next(jc, p, jnp.asarray(items)))(jp)
    want_c = jax.jit(lambda p: JB.score_candidates(
        jc, p, jnp.asarray(items[:1]), jnp.asarray(cands)))(jp)
    with torch.no_grad():
        got = TB.score_next(SMOKE, tp, torch.from_numpy(items))
        got_c = TB.score_candidates(SMOKE, tp, torch.from_numpy(items[:1]),
                                    torch.from_numpy(cands))
    assert got.shape == (len(items), SMOKE.n_items)
    close(got, want)
    close(got_c, want_c)
    close(got_c, got[0, cands].numpy())


def _tied_params(cfg, seed):
    """Weights whose item table mirrors its first half into its second
    (item 511 - i repeats item i), so that every score ties with another's
    and an odd k cuts a tied pair."""
    tree = weights(cfg, seed)
    emb = tree["item_embed"] = tree["item_embed"].copy()
    emb[cfg.n_items // 2:] = emb[:cfg.n_items // 2][::-1]
    return (jax.tree.map(jnp.asarray, tree),
            TB.params_from_jax(cfg, tree, device="cpu"))


@pytest.mark.parametrize("ways", [0, 4, 16], ids=["one-stage", "ways4",
                                                  "ways16"])
def test_score_topk_matches_reference_with_ties(ways):
    d = DIMS["serve_bulk"]
    cfg = dataclasses.replace(SMOKE, topk_ways=ways)
    jc = jax_cfg(cfg)
    jp, tp = _tied_params(cfg, seed=12)
    items = sequences(cfg, d["batch"], seed=13)
    with torch.no_grad():
        scores = TB.score_next(cfg, tp, torch.from_numpy(items))
    for k in (d["topk"] - 1, d["topk"]):
        jv, ji = jax.jit(lambda p: JB.score_topk(
            jc, p, jnp.asarray(items), k=k, chunk=d["chunk"]))(jp)
        with torch.no_grad():
            tv, ti = TB.score_topk(cfg, tp, torch.from_numpy(items), k=k,
                                   chunk=d["chunk"])
        assert (tv[:, 1:] == tv[:, :-1]).any()          # ties are real
        if k % 2:                            # and cross the cut at odd k
            assert torch.equal(torch.topk(scores, k + 1).values[:, -1],
                               tv[:, -1])
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        close(tv, jv)
        np.testing.assert_array_equal(
            tv.numpy(), torch.gather(scores, 1, ti).numpy())


def test_top_k_ties_across_the_cut_take_lower_indices():
    rng = np.random.default_rng(14)
    x = rng.integers(0, 6, (9, 50)).astype(np.float32)
    for k in (1, 7, 20, 50):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = TB._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# --- configurations ------------------------------------------------------------------

def test_config_registry_and_n_params_match_reference():
    jarch, tarch = jconfigs.ARCHS["bert4rec"], RECSYS_ARCHS["bert4rec"]
    assert (tarch.arch_id, tarch.family) == (jarch.arch_id, jarch.family)
    assert list(tfam.RECSYS_SHAPES) == jarch.shape_ids()
    for name in ("full_cfg", "smoke_cfg"):
        tc, jc = getattr(tarch, name), getattr(jarch, name)
        assert dataclasses.replace(jax_cfg(tc)) == jc
        assert tc.dtype == torch.float32
        assert tc.n_params() == jc.n_params()
    assert tfam.RECSYS_SHAPES == jfam.RECSYS_SHAPES
    assert tfam.FULL == jfam.FULL and tfam.REDUCED == jfam.REDUCED
    assert set(RECSYS_ARCHS) == {a for a, arch in jconfigs.ARCHS.items()
                                 if arch.family == "recsys"}


def test_init_params_shapes_match_reference():
    want = TB.params_from_jax(SMOKE, weights(SMOKE), device="cpu")
    got = TB.init_params(SMOKE, torch.Generator().manual_seed(0),
                         device="cpu")
    gp, gl = flatten(got)
    wp, wl = flatten(want)
    assert gp == wp
    assert [tuple(x.shape) for x in gl] == [tuple(x.shape) for x in wl]


def test_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoCudaDevice):
        TB.init_params(SMOKE, torch.Generator())
    with pytest.raises(NoCudaDevice):
        TB.params_from_jax(SMOKE, weights(SMOKE))


# --- the reference's property test of the PAD mask, on the port ------------------

def test_pad_masking_blocks_attention():
    """Live positions do not see PAD keys: changing the PAD row of the item
    table leaves their states exactly as they were; a sequence of PADs
    only still has a finite gradient (the mask clamps the exponent's
    input, not its output)."""
    cfg = JSMOKE
    _, _, tp = both(SMOKE, seed=15)
    items = torch.tensor([[7, 9, 11, 0, 0] + [13] * (cfg.seq_len - 5)])
    live = items[0] != SMOKE.PAD
    with torch.no_grad():
        h1 = TB.encode(SMOKE, tp, items)
        tp["item_embed"][SMOKE.PAD] += 3.0
        h2 = TB.encode(SMOKE, tp, items)
    assert torch.equal(h1[0, live], h2[0, live])
    assert not torch.equal(h1[0, ~live], h2[0, ~live])
    pads = torch.zeros((2, cfg.seq_len), dtype=torch.long)
    pads[1, -1] = SMOKE.MASK
    _, grads = _value_and_grad(
        lambda p, b: TB.encode(SMOKE, p, b).square().mean(), tp, pads)
    assert all(torch.isfinite(g).all() for g in flatten(grads)[1])
