"""The port's training substrate against the JAX package's: AdamW, its
schedule and clipping; int8 gradient compression (bit-equal) and its
all-reduce; the three data streams (array-equal); checkpoints; and the
Trainer (losses against JAX's, gradient accumulation, failure replay)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.data import GraphEpochStream as JGraphEpochStream
from repro.data import MaskedItemStream as JMaskedItemStream
from repro.data import TokenStream as JTokenStream
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import compression as jcompression
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import GraphEpochStream, MaskedItemStream, TokenStream
from repro_torch.errors import NoCudaDevice
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig, compression
from repro_torch.tree import leaves
from test_torch_lm import jax_cfg, reference_tree

RTOL = 1e-6


def _tree(seed, dtype=np.float32):
    """A nested dict/list tree of arrays, the same as numpy for both."""
    rng = np.random.default_rng(seed)
    return dict(w=rng.normal(size=(8, 5)).astype(dtype),
                blocks=[dict(a=rng.normal(size=(3,)).astype(np.float32),
                             b=rng.normal(size=(4, 2)).astype(dtype))
                        for _ in range(2)])


def _jax_tree(t):
    return dict(w=jnp.asarray(t["w"]),
                blocks={str(i): dict(a=jnp.asarray(b["a"]),
                                     b=jnp.asarray(b["b"]))
                        for i, b in enumerate(t["blocks"])})


def _torch_tree(t):
    return dict(w=torch.from_numpy(t["w"]),
                blocks=[dict(a=torch.from_numpy(b["a"]),
                             b=torch.from_numpy(b["b"]))
                        for b in t["blocks"]])


def _pairs(jtree, ttree):
    """Matching leaves of a JAX tree (blocks keyed "0", "1") and a port
    tree (blocks as a list)."""
    yield jtree["w"], ttree["w"]
    for i, b in enumerate(ttree["blocks"]):
        for k in ("a", "b"):
            yield jtree["blocks"][str(i)][k], b[k]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip_norm", [1.0, 1e9], ids=["clipped", "free"])
def test_adamw_updates_match_reference(clip_norm):
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                            clip_norm=clip_norm)
    jcfg = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    params = _tree(0)
    jp, tp = _jax_tree(params), _torch_tree(params)
    js, ts = jadamw.init(jp), adamw.init(tp)
    for step in range(5):
        g = _tree(10 + step)
        jp, js, jm = jadamw.update(jcfg, _jax_tree(g), js, jp)
        tp, ts, tm = adamw.update(cfg, _torch_tree(g), ts, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=RTOL)
        for tree_j, tree_t in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            for a, b in _pairs(tree_j, tree_t):
                np.testing.assert_allclose(_np(b), _np(a), rtol=RTOL,
                                           atol=1e-7)
        assert int(ts.step) == int(js.step) == step + 1


def test_adamw_keeps_bf16_params_bf16_with_f32_moments():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    jcfg = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    p = _tree(1)
    g = _tree(2)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), _jax_tree(p))
    tp = {"w": torch.from_numpy(p["w"]).to(torch.bfloat16),
          "blocks": [{k: torch.from_numpy(v).to(torch.bfloat16)
                      for k, v in b.items()} for b in p["blocks"]]}
    jg = jax.tree.map(lambda x: x.astype(jnp.bfloat16), _jax_tree(g))
    tg = {"w": torch.from_numpy(g["w"]).to(torch.bfloat16),
          "blocks": [{k: torch.from_numpy(v).to(torch.bfloat16)
                      for k, v in b.items()} for b in g["blocks"]]}
    jp2, js2, _ = jadamw.update(jcfg, jg, jadamw.init(jp), jp)
    tp2, ts2, _ = adamw.update(cfg, tg, adamw.init(tp), tp)
    assert all(x.dtype == torch.bfloat16 for x in leaves(tp2))
    assert all(x.dtype == torch.float32 for x in leaves(ts2.m))
    for a, b in _pairs(jp2, tp2):
        np.testing.assert_array_equal(_np(b), _np(a.astype(jnp.float32)))


def test_schedule_matches_reference():
    cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    jcfg = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            _np(adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))),
            _np(jadamw.schedule(jcfg, jnp.int32(step))), rtol=RTOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    t = _tree(3)
    jt, jn = jadamw.clip_by_global_norm(_jax_tree(t), max_norm)
    tt, tn = adamw.clip_by_global_norm(_torch_tree(t), max_norm)
    np.testing.assert_allclose(_np(tn), _np(jn), rtol=RTOL)
    for a, b in _pairs(jt, tt):
        np.testing.assert_allclose(_np(b), _np(a), rtol=RTOL)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=str)
def test_compress_decompress_is_bit_equal(dtype):
    jerr = jcompression.init_error(_jax_tree(_tree(0)))
    terr = compression.init_error(_torch_tree(_tree(0)))
    for step in range(4):
        g = _tree(20 + step)
        g["w"][0, :3] = [0.0, 1e-30, 5.0]           # tiny and exact values
        jg = jax.tree.map(lambda x: x.astype(dtype), _jax_tree(g))
        tg = _torch_tree(g)
        if dtype != np.float32:
            tg = {"w": tg["w"].to(torch.bfloat16),
                  "blocks": [{k: v.to(torch.bfloat16) for k, v in b.items()}
                             for b in tg["blocks"]]}
        jdeq, jerr = jcompression.compress_decompress(jg, jerr)
        tdeq, terr = compression.compress_decompress(tg, terr)
        for a, b in list(_pairs(jdeq, tdeq)) + list(_pairs(jerr, terr)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.fixture
def gloo_rank(tmp_path):
    """A one-rank gloo process group on a FileStore, destroyed after."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_compressed_all_reduce_matches_compressed_psum(gloo_rank):
    g = np.random.default_rng(6).normal(size=(16, 8)).astype(np.float32)
    err = np.random.default_rng(7).normal(scale=1e-3, size=(16, 8)).astype(
        np.float32)
    mesh = jax.make_mesh((1,), ("data",))
    psum = jax.shard_map(
        lambda a, e: jcompression.compressed_psum(a, "data", e),
        mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))
    j_total, j_err = psum(jnp.asarray(g), jnp.asarray(err))
    t_total, t_err = compression.compressed_all_reduce(
        torch.from_numpy(g), torch.from_numpy(err))
    np.testing.assert_array_equal(t_total.numpy(), np.asarray(j_total))
    np.testing.assert_array_equal(t_err.numpy(), np.asarray(j_err))


# ---------------------------------------------------------------------------
# data streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (5, 1 << 10)])
def test_data_streams_equal_the_reference(seed, step):
    ours = TokenStream(vocab=100, batch=4, seq_len=9, seed=seed,
                       device="cpu").batch_at(step)
    ref = JTokenStream(vocab=100, batch=4, seq_len=9, seed=seed).batch_at(
        step)
    ours_m = MaskedItemStream(n_items=50, batch=3, seq_len=12, seed=seed,
                              device="cpu").batch_at(step)
    ref_m = JMaskedItemStream(n_items=50, batch=3, seq_len=12,
                              seed=seed).batch_at(step)
    for a, b in list(zip(ours.values(), ref.values())) + \
            list(zip(ours_m.values(), ref_m.values())):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert set(ours) == set(ref) and set(ours_m) == set(ref_m)
    np.testing.assert_array_equal(
        GraphEpochStream(n_nodes=200, batch_nodes=16, seed=seed,
                         device="cpu").seeds_at(step).numpy(),
        JGraphEpochStream(n_nodes=200, batch_nodes=16,
                          seed=seed).seeds_at(step))


def test_streams_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoCudaDevice):
        TokenStream(vocab=10, batch=1, seq_len=4).batch_at(0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree():
    return dict(a=torch.arange(5), b=[torch.ones((2, 3)), torch.tensor(7.0)],
                c=dict(d=torch.zeros(1, dtype=torch.int32),
                       e=torch.linspace(-1, 1, 7).to(torch.bfloat16)))


def _assert_trees_equal(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_ckpt_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    tree = _ckpt_tree()
    for step in (3, 9, 12):
        mgr.save(step, tree)
    assert mgr.latest_step() == 12
    _assert_trees_equal(tree, mgr.restore())
    _assert_trees_equal(tree, mgr.restore(9))
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_0000000009", "step_0000000012"]


def test_crash_mid_save_leaves_latest_intact(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    tree = _ckpt_tree()
    mgr.save(5, tree)
    real_savez = np.savez

    def crash(*a, **k):
        real_savez(*a, **k)
        raise OSError("disk lost mid-save")
    monkeypatch.setattr(np, "savez", crash)
    bumped = dict(tree, a=tree["a"] + 1)
    with pytest.raises(OSError):
        mgr.save(6, bumped)
    monkeypatch.setattr(np, "savez", real_savez)
    assert mgr.latest_step() == 5
    _assert_trees_equal(tree, mgr.restore())
    assert not os.path.exists(tmp_path / "step_0000000006")
    mgr.save(6, bumped)                               # the retry lands
    _assert_trees_equal(bumped, mgr.restore())


def test_async_save_holds_the_step_it_was_handed(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    tree = _ckpt_tree()
    want = {k: v for k, v in tree.items()}
    snapshot = tree["a"].clone()
    mgr.save(1, tree, blocking=False)
    tree["a"].add_(100)                              # in place, at once
    mgr.save(2, tree, blocking=False)                # waits for the first
    mgr.wait()
    assert torch.equal(mgr.restore(1)["a"], snapshot)
    assert torch.equal(mgr.restore(2)["a"], want["a"])


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _small_cfg():
    return TT.LMConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                       d_head=16, d_ff=64, vocab=64, remat=False)


def _loss_fns(cfg):
    jc = jax_cfg(cfg)
    return (lambda p, b: JT.lm_loss(jc, p, b["tokens"], b["targets"]),
            lambda p, b: TT.lm_loss(cfg, p, b["tokens"], b["targets"]))


def _both_params(cfg, seed=0):
    jp = reference_tree(jax_cfg(cfg), seed)
    return jp, TT.params_from_jax(cfg, jp, device="cpu")


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
def test_trainer_losses_match_reference(tmp_path, compress):
    cfg = _small_cfg()
    jp, tp = _both_params(cfg)
    jloss, tloss = _loss_fns(cfg)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=20)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(opt))
    jt = JTrainer(JTrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                 compress_grads=compress), jopt, jloss, jp)
    tt = Trainer(TrainerConfig(ckpt_dir=str(tmp_path / "t"),
                               compress_grads=compress), opt, tloss, tp,
                 device="cpu")
    jstream = JTokenStream(vocab=64, batch=8, seq_len=16)
    tstream = TokenStream(vocab=64, batch=8, seq_len=16, device="cpu")
    # With int8 compression, f32 gradients ~1e-7 apart can round to
    # different int8 quanta (compress_decompress itself is bit-equal,
    # above), after which the two runs take slightly different paths: the
    # losses then stay within 5e-4 instead of 1e-4.
    tol = 5e-4 if compress else 1e-4
    for step in range(10):
        jt.state, jm = jt._step_fn(jt.state, jstream.batch_at(step))
        tm = tt.step(tstream.batch_at(step))
        assert abs(float(tm["loss"]) - float(jm["loss"])) < tol, step
    assert int(tt.state["step"]) == 10


def test_grad_accum_equivalence(tmp_path):
    """grad_accum=4 over microbatches == one big batch, and == JAX's."""
    cfg = _small_cfg()
    jp, tp = _both_params(cfg, seed=1)
    jloss, tloss = _loss_fns(cfg)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                            clip_norm=1e9)
    big = TokenStream(vocab=64, batch=8, seq_len=12,
                      device="cpu").batch_at(0)
    micro = {k: v.reshape(4, 2, *v.shape[1:]) for k, v in big.items()}
    t1 = Trainer(TrainerConfig(ckpt_dir=str(tmp_path / "a")), opt, tloss, tp,
                 device="cpu")
    t1.step(big)
    t2 = Trainer(TrainerConfig(ckpt_dir=str(tmp_path / "b"), grad_accum=4),
                 opt, tloss, tp, device="cpu")
    t2.step(micro)
    jt = JTrainer(JTrainerConfig(ckpt_dir=str(tmp_path / "c"), grad_accum=4),
                  jadamw.AdamWConfig(**dataclasses.asdict(opt)), jloss, jp)
    js, _ = jt._step_fn(jt.state, {k: jnp.asarray(v.numpy())
                                   for k, v in micro.items()})
    for a, b in zip(leaves(t1.state["params"]), leaves(t2.state["params"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                   rtol=1e-4)
    for k, stacked in js["params"]["layers"].items():
        for i, layer in enumerate(t2.state["params"]["layers"]):
            np.testing.assert_allclose(layer[k].numpy(),
                                       np.asarray(stacked[i]),
                                       atol=1e-5, rtol=1e-4)


def test_trainer_recovers_from_failure_bitwise(tmp_path):
    """Crash at step 7, restore from the checkpoint at 5, replay: the same
    parameters, bit for bit."""
    cfg = _small_cfg()
    _, params = _both_params(cfg)
    stream = TokenStream(vocab=64, batch=4, seq_len=12, device="cpu")
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)

    def make(path, fail):
        tr = Trainer(TrainerConfig(ckpt_dir=path, ckpt_every=5,
                                   ckpt_async=False, max_restarts=2),
                     opt, _loss_fns(cfg)[1], params, device="cpu")
        fired = {"done": False}

        def hook(step):
            if fail and step == 7 and not fired["done"]:
                fired["done"] = True
                raise RuntimeError("simulated node failure")
        metrics = tr.run(stream.batch_at, 10,
                         fail_hook=hook if fail else None)
        return tr, metrics

    t_clean, m_clean = make(str(tmp_path / "clean"), fail=False)
    t_fail, m_fail = make(str(tmp_path / "fail"), fail=True)
    assert (m_clean["restarts"], m_fail["restarts"]) == (0, 1)
    _assert_trees_equal(t_clean.state["params"], t_fail.state["params"])
    _assert_trees_equal(t_clean.state["opt"].m, t_fail.state["opt"].m)
    assert int(t_fail.state["step"]) == 10


def test_a_failing_step_leaves_the_state_as_it_was(tmp_path):
    cfg = _small_cfg()
    _, params = _both_params(cfg)
    tloss = _loss_fns(cfg)[1]
    calls = {"n": 0}

    def flaky(p, b):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("fault in the third microbatch")
        return tloss(p, b)
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), grad_accum=2,
                               compress_grads=True),
                 adamw.AdamWConfig(warmup_steps=0), flaky, params,
                 device="cpu")
    batch = TokenStream(vocab=64, batch=4, seq_len=8,
                        device="cpu").batch_at(0)
    micro = {k: v.reshape(2, 2, -1) for k, v in batch.items()}
    tr.step(micro)
    before = {k: [x.clone() for x in leaves(v)] for k, v in tr.state.items()}
    with pytest.raises(RuntimeError):
        tr.step(micro)
    for k, v in tr.state.items():
        for x, y in zip(leaves(v), before[k]):
            assert torch.equal(x, y), k
