"""The port's GNN family (repro_torch.models.gnn) against the JAX
package's, on the same numpy inputs and the same weights (carried over by
``params_from_jax``): the segment ops, padding and readout; GAT's forward,
loss and gradients; EGNN, NequIP and MACE energies and forces (NequIP and
MACE also on the bf16 ``fused_agg`` path) and the gradient of the
molecule loss, which differentiates the forces again; the samplers; the
Clebsch-Gordan tables, harmonics and tensor products; the configurations
and registries.  Then the reference's property tests, run on the port:
CG invariance and selection rules, energy invariance and force
equivariance.

Tolerances: integer arrays and the host samplers bit-equal; the CG tables
to float64 precision (1e-12); f32 values within rtol 1e-4 and atol 1e-5;
the bf16 ``fused_agg`` path within 3e-2 of the largest magnitude of the
reference's output (two bf16 programs that round in different places
differ by ~1 % of the scale in an element near zero, so the bound is
relative to the output's scale, not to each element).  The reference's
functions run under ``jax.jit``: eagerly, its second-order gradients
take tens of seconds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import repro.configs as jconfigs
from repro.configs.families import gnn as jfam
from repro.models.gnn import common as jcommon
from repro.models.gnn import e3 as je3
from repro.models.gnn import egnn as jegnn
from repro.models.gnn import equivariant as jeq
from repro.models.gnn import gat as jgat
from repro.models.gnn import sampler as jsampler
from repro_torch.configs import GNN_ARCHS
from repro_torch.configs.families import gnn as tfam
from repro_torch.errors import NoCudaDevice
from repro_torch.graph import csr_from_coo, erdos_renyi
from repro_torch.models.gnn import common, e3, egnn, equivariant, gat, sampler
from repro_torch.train.trainer import _value_and_grad
from repro_torch.tree import flatten

RTOL, ATOL = 1e-4, 1e-5          # f32
BF16_TOL = 3e-2                  # the bf16 fused_agg path
CG_TOL = 1e-12                   # float64 tables
DIMS = tfam.REDUCED_DIMS


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def bf16_close(got, want):
    """max |got - want| <= BF16_TOL * max |want|."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= BF16_TOL * scale, (err, scale)


def trees_close(got, want, rtol=RTOL, atol=ATOL):
    gp, gl = flatten(got)
    wp, wl = flatten(want)
    assert gp == wp
    for path, g, w in zip(gp, gl, wl):
        try:
            close(g, w, rtol, atol)
        except AssertionError as e:
            raise AssertionError(f"leaf {path}: {e}") from None


def jax_np(tree):
    return jax.tree.map(np.asarray, tree)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def both_graphs(senders, receivers, n, e_max, n_max, graph_ids=None,
                n_graphs=1):
    """(JAX GraphData, port GraphData) of one padded graph."""
    return (jcommon.pad_graph(senders, receivers, n, e_max, n_max,
                              graph_ids=graph_ids, n_graphs=n_graphs),
            common.pad_graph(senders, receivers, n, e_max, n_max,
                             graph_ids=graph_ids, n_graphs=n_graphs,
                             device="cpu"))


def random_graph(seed, shape="full_graph_sm", used=None):
    """A random graph at a REDUCED shape: ``used`` nodes (the rest pad),
    3/4 of the edge slots (the rest pad), node ``used - 1`` isolated."""
    d = DIMS[shape]
    rng = np.random.default_rng(seed)
    n = used or d["N"] - 8
    e = d["E"] * 3 // 4
    s = rng.integers(0, n - 1, e)
    r = rng.integers(0, n - 1, e)
    return both_graphs(s, r, n, d["E"], d["N"])


def molecules(seed, n_mol=None, atoms=7, edges=14, box=2.0):
    """``n_mol`` molecules of ``atoms`` atoms in a box, each with its
    ``edges`` shortest directed pairs, batched as one padded graph at the
    REDUCED molecule shape (pad nodes and pad edges remain)."""
    d = DIMS["molecule"]
    n_mol = n_mol or d["n_graphs"]
    rng = np.random.default_rng(seed)
    coords = np.zeros((d["N"], 3), np.float32)
    s_all, r_all = [], []
    for m in range(n_mol):
        x = rng.uniform(0, box, (atoms, 3))
        dist = np.linalg.norm(x[:, None] - x[None], axis=-1)
        dist[np.diag_indices(atoms)] = np.inf
        flat = np.argsort(dist, axis=None, kind="stable")[:edges]
        s, r = np.unravel_index(flat, dist.shape)
        s_all.append(s + m * atoms)
        r_all.append(r + m * atoms)
        coords[m * atoms:(m + 1) * atoms] = x
    n = n_mol * atoms
    gi = np.repeat(np.arange(n_mol), atoms)
    jg, tg = both_graphs(np.concatenate(s_all), np.concatenate(r_all), n,
                         d["E"], d["N"], graph_ids=gi, n_graphs=n_mol)
    return jg, tg, coords


def rotation(seed):
    return Rotation.random(random_state=seed).as_matrix().astype(np.float32)


# --- padding and the segment ops -------------------------------------------

def test_pad_graph_matches_reference():
    jg, tg = random_graph(0)
    for f in ("senders", "receivers", "node_mask", "edge_mask", "graph_ids"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)))
    assert tg.n_graphs == jg.n_graphs
    with pytest.raises(ValueError):
        common.pad_graph([0, 1, 2], [1, 2, 0], 3, 2, 4, device="cpu")


@pytest.mark.parametrize("reduce", ["sum", "max", "mean"])
def test_segment_mp_matches_reference(reduce):
    jg, tg = random_graph(1)
    n = DIMS["full_graph_sm"]["N"]
    msgs = np.random.default_rng(2).normal(
        size=(DIMS["full_graph_sm"]["E"], 5)).astype(np.float32)
    want = np.asarray(jcommon.segment_mp(jnp.asarray(msgs), jg.receivers, n,
                                         reduce))
    got = common.segment_mp(torch.from_numpy(msgs), tg.receivers, n, reduce)
    if reduce == "max":              # empty segments are -inf in both
        assert np.isneginf(want).any()
    close(got, want)


def test_edge_softmax_matches_reference_with_isolated_node():
    jg, tg = random_graph(3)
    n, e = DIMS["full_graph_sm"]["N"], DIMS["full_graph_sm"]["E"]
    scores = np.random.default_rng(4).normal(size=(e, 3)).astype(np.float32)
    want = jcommon.edge_softmax(jnp.asarray(scores), jg.receivers,
                                jg.edge_mask, n)
    got = common.edge_softmax(torch.from_numpy(scores), tg.receivers,
                              tg.edge_mask, n)
    close(got, want)
    sums = common.segment_mp(got, tg.receivers, n)
    has_in = common.segment_mp(tg.edge_mask.float()[:, None], tg.receivers,
                               n)[:, 0] > 0
    close(sums[has_in], np.ones((int(has_in.sum()), 3)), atol=1e-5)
    isolated = n - 9                 # node used - 1 of random_graph
    assert not has_in[isolated] and float(sums[isolated].abs().max()) == 0


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_graph_readout_matches_reference(reduce):
    jg, tg, _ = molecules(5)
    vals = np.random.default_rng(6).normal(
        size=(DIMS["molecule"]["N"], 4)).astype(np.float32)
    want = jcommon.graph_readout(jnp.asarray(vals), jg.graph_ids,
                                 jg.n_graphs, jg.node_mask, reduce)
    got = common.graph_readout(torch.from_numpy(vals), tg.graph_ids,
                               tg.n_graphs, tg.node_mask, reduce)
    close(got, want)


# --- GAT ----------------------------------------------------------------------

def _gat_case(seed=7):
    d = DIMS["full_graph_sm"]
    jc = jconfigs.ARCHS["gat-cora"].smoke_cfg_fn(d["d"])
    tc = GNN_ARCHS["gat-cora"].smoke_cfg_fn(d["d"])
    tree = jax_np(jgat.init_params(jc, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(d["N"], d["d"])).astype(np.float32)
    labels = rng.integers(0, tc.n_classes, d["N"]).astype(np.int32)
    mask = (rng.random(d["N"]) < 0.75).astype(np.float32)
    return jc, tc, tree, x, labels, mask


def test_gat_forward_loss_and_grads_match_reference():
    jc, tc, tree, x, labels, mask = _gat_case()
    jg, tg = random_graph(8)
    tp = gat.params_from_jax(tc, tree, device="cpu")
    close(gat.forward(tc, tp, torch.from_numpy(x), tg),
          jax.jit(lambda p: jgat.forward(jc, p, jnp.asarray(x), jg))(
              to_jax(tree)))

    def jloss(p):
        return jgat.loss(jc, p, jnp.asarray(x), jg, jnp.asarray(labels),
                         jnp.asarray(mask))

    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(to_jax(tree))
    tl, tgrad = _value_and_grad(
        lambda p, b: gat.loss(tc, p, b["x"], tg, b["labels"], b["mask"]),
        tp, dict(x=torch.from_numpy(x), labels=torch.from_numpy(labels),
                 mask=torch.from_numpy(mask)))
    close(tl, jl)
    trees_close(tgrad, gat.params_from_jax(tc, jax_np(jgrad), device="cpu"))


# --- EGNN, NequIP, MACE: energies, forces, the molecule loss -----------------

MODELS = {"egnn": (jegnn, egnn), "nequip": (jeq, equivariant),
          "mace": (jeq, equivariant)}


def _mol_case(arch_id, seed=9, **changes):
    """(JAX module, port module, JAX config, port config, reference tree,
    node inputs): the architecture's smoke config at the REDUCED
    molecule shape, weights drawn by the reference, biases moved off 0."""
    d = DIMS["molecule"]
    jm, tm = MODELS[arch_id]
    jc = dataclasses.replace(jconfigs.ARCHS[arch_id].smoke_cfg_fn(d["d"]),
                             **changes)
    tc = dataclasses.replace(GNN_ARCHS[arch_id].smoke_cfg_fn(d["d"]),
                             **changes)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: a + rng.normal(scale=0.1, size=a.shape).astype(
            a.dtype) if path[-1].key == "b" else a,
        jax_np(jm.init_params(jc, jax.random.key(seed))))
    if arch_id == "egnn":
        x = rng.normal(size=(d["N"], d["d"])).astype(np.float32)
    else:
        x = rng.integers(0, tc.n_species, d["N"]).astype(np.int64)
    return jm, tm, jc, tc, tree, x


def _energy(mod, cfg, p, x, c, g):
    out = mod.forward(cfg, p, x, c, g)
    return out[0] if isinstance(out, tuple) else out


CASES = [("egnn", {}), ("nequip", {}), ("mace", {}),
         ("nequip", {"fused_agg": True}), ("mace", {"fused_agg": True})]


@pytest.mark.parametrize("arch_id,changes", CASES,
                         ids=["egnn", "nequip", "mace", "nequip-fused",
                              "mace-fused"])
def test_energy_and_forces_match_reference(arch_id, changes):
    jm, tm, jc, tc, tree, x = _mol_case(arch_id, **changes)
    jg, tg, coords = molecules(10)
    cmp = bf16_close if changes else close

    @jax.jit
    def ref(p, c):
        return (_energy(jm, jc, p, jnp.asarray(x), c, jg),
                jm.energy_and_forces(jc, p, jnp.asarray(x), c, jg))

    want_g, (je, jf) = ref(to_jax(tree), jnp.asarray(coords))
    tp = tm.params_from_jax(tc, tree, device="cpu")
    with torch.no_grad():
        got_g = _energy(tm, tc, tp, torch.from_numpy(x),
                        torch.from_numpy(coords), tg)
        e, f = tm.energy_and_forces(tc, tp, torch.from_numpy(x),
                                    torch.from_numpy(coords), tg)
    assert not e.requires_grad and not f.requires_grad
    cmp(got_g, want_g)
    cmp(e, je)
    cmp(f, jf)
    assert np.isfinite(f.numpy()).all()


@pytest.mark.parametrize("arch_id", ["egnn", "nequip", "mace"])
def test_molecule_loss_gradient_matches_reference(arch_id):
    """The loss of the molecule cell (energy + 0.1 x force MSE, the
    port's ``configs/families/gnn.py`` against the reference's formula):
    its gradient differentiates the forces again, through the pad edges'
    zero vectors too."""
    jm, tm, jc, tc, tree, x = _mol_case(arch_id)
    jg, tg, coords = molecules(11)
    rng = np.random.default_rng(12)
    e_tgt = rng.normal(size=jg.n_graphs).astype(np.float32)
    f_tgt = rng.normal(size=coords.shape).astype(np.float32)

    def jloss(p):
        def efn(c):
            return jnp.sum(_energy(jm, jc, p, jnp.asarray(x), c, jg))
        _, negf = jax.value_and_grad(efn)(jnp.asarray(coords))
        e_all = _energy(jm, jc, p, jnp.asarray(x), jnp.asarray(coords), jg)
        return jnp.mean((e_all - e_tgt) ** 2) + \
            0.1 * jnp.mean((-negf - f_tgt) ** 2)

    cell = GNN_ARCHS[arch_id].build("molecule", reduced=True)
    g = {f: getattr(tg, f) for f in ("senders", "receivers", "node_mask",
                                     "edge_mask", "graph_ids")}

    def tloss(p, b):
        return cell.loss_fn(p, b["x"], b["coords"], g, b["e"], b["f"])

    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(to_jax(tree))
    tl, tgrad = _value_and_grad(
        tloss, tm.params_from_jax(tc, tree, device="cpu"),
        dict(x=torch.from_numpy(x), coords=torch.from_numpy(coords),
             e=torch.from_numpy(e_tgt), f=torch.from_numpy(f_tgt)))
    close(tl, jl)
    trees_close(tgrad, tm.params_from_jax(tc, jax_np(jgrad), device="cpu"))


def test_egnn_coords_and_features_match_reference():
    jm, tm, jc, tc, tree, x = _mol_case("egnn")
    jg, tg, coords = molecules(13)
    je, jh, jx = jax.jit(lambda p: jegnn.forward(
        jc, p, jnp.asarray(x), jnp.asarray(coords), jg))(to_jax(tree))
    with torch.no_grad():
        te, th, tx = egnn.forward(tc, egnn.params_from_jax(tc, tree,
                                                           device="cpu"),
                                  torch.from_numpy(x),
                                  torch.from_numpy(coords), tg)
    close(te, je)
    close(th, jh)
    close(tx, jx)


# --- samplers -------------------------------------------------------------------

def _csr(n=300, m=1500, seed=0):
    g = erdos_renyi(n, m, seed=seed)
    return csr_from_coo(g.n, g.src, g.dst)


def test_host_block_sampler_bit_equal():
    indptr, indices = _csr()
    seeds = np.array([3, 77, 150, 299])
    got = sampler.sample_block_host(indptr, indices, seeds, 6,
                                    np.random.default_rng(4))
    want = jsampler.sample_block_host(indptr, indices, seeds, 6,
                                      np.random.default_rng(4))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("fanouts", [[5, 3], [15, 10]])
def test_host_subgraph_sampler_bit_equal(fanouts):
    indptr, indices = _csr(n=400, m=1200, seed=1)   # some nodes of degree 0
    seeds = np.random.default_rng(2).choice(400, 24, replace=False)
    got = sampler.sample_subgraph_host(indptr, indices, seeds, fanouts,
                                       seed=7)
    want = jsampler.sample_subgraph_host(indptr, indices, seeds, fanouts,
                                         seed=7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert (got[0][:len(seeds)] == seeds).all()


def test_device_sampler_arithmetic_matches_reference():
    """The reference's draws through the port's arithmetic after the draw
    give the reference's senders and receivers."""
    indptr, indices = _csr(n=100, m=300, seed=3)
    seeds = np.array([0, 5, 9, 99, 98], np.int32)
    key = jax.random.key(5)
    js, jr = jsampler.sample_fanout_device(
        key, jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(seeds), 4)
    u = jax.random.randint(key, (len(seeds), 4), 0, 1 << 30)
    ts, tr = sampler._fanout_from_draws(
        torch.from_numpy(np.array(u)).long(), torch.from_numpy(indptr),
        torch.from_numpy(indices), torch.from_numpy(seeds).long(), 4)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_device_sampler_draws_neighbours():
    indptr, indices = _csr(n=100, m=300, seed=3)
    deg = np.diff(indptr)
    seeds = np.concatenate([np.nonzero(deg == 0)[0][:2], [5, 9]])
    s, r = sampler.sample_fanout_device(torch.Generator().manual_seed(0),
                                        indptr, indices, seeds, 8,
                                        device="cpu")
    assert s.shape == r.shape == (len(seeds) * 8,)
    for si, ri in zip(s.tolist(), r.tolist()):
        nbrs = indices[indptr[ri]:indptr[ri + 1]]
        assert si in nbrs if len(nbrs) else si == ri


# --- the e3 library ---------------------------------------------------------------

def test_cg_tables_equal_reference():
    for l1 in range(4):
        for l2 in range(4):
            for l3 in range(4):
                np.testing.assert_allclose(
                    e3.su2_clebsch_gordan(l1, l2, l3),
                    je3.su2_clebsch_gordan(l1, l2, l3), rtol=0, atol=CG_TOL)
                if abs(l1 - l2) <= l3 <= l1 + l2:
                    np.testing.assert_allclose(
                        e3.real_clebsch_gordan(l1, l2, l3),
                        je3.real_clebsch_gordan(l1, l2, l3), rtol=0,
                        atol=CG_TOL)


def test_harmonics_and_radial_basis_match_reference():
    rng = np.random.default_rng(14)
    vec = rng.normal(size=(40, 3)).astype(np.float32)
    vec[0] = 0.0                                   # a pad edge's vector
    want = je3.spherical_harmonics(jnp.asarray(vec), 3)
    got = e3.spherical_harmonics(torch.from_numpy(vec), 3)
    assert sorted(got) == sorted(want)
    for l in want:
        close(got[l], want[l])
    assert float(got[2][0].abs().max()) == 0.0
    r = np.asarray([0.0, 1e-12, 0.1, 2.5, 4.99, 5.0, 7.0], np.float32)
    close(e3.bessel_rbf(torch.from_numpy(r), 8, 5.0),
          je3.bessel_rbf(jnp.asarray(r), 8, 5.0))


def test_tensor_products_and_mix_match_reference():
    rng = np.random.default_rng(15)
    a = {l: rng.normal(size=(6, 4, 2 * l + 1)).astype(np.float32)
         for l in range(3)}
    b = {l: rng.normal(size=(6, 2 * l + 1)).astype(np.float32)
         for l in range(3)}
    ta = {l: torch.from_numpy(v) for l, v in a.items()}
    ja = {l: jnp.asarray(v) for l, v in a.items()}
    tp = e3.tensor_product(ta, {l: torch.from_numpy(v) for l, v in b.items()},
                           2)
    jp = je3.tensor_product(ja, {l: jnp.asarray(v) for l, v in b.items()}, 2)
    st, sj = e3.self_tensor_product(ta, ta, 2), je3.self_tensor_product(
        ja, ja, 2)
    for l in range(3):
        close(tp[l], jp[l])
        close(st[l], sj[l])
    w = {l: rng.normal(size=(4 * jp[l].shape[2], 5)).astype(np.float32)
         for l in range(3)}
    got = e3.linear_mix(tp, {l: torch.from_numpy(v) for l, v in w.items()})
    want = je3.linear_mix(jp, {l: jnp.asarray(v) for l, v in w.items()})
    for l in range(3):
        close(got[l], want[l])
    zeros = e3.irreps_zeros(3, 4, 2, device="cpu")
    assert [tuple(zeros[l].shape) for l in range(3)] == \
        [(3, 4, 1), (3, 4, 3), (3, 4, 5)]


# --- configurations ------------------------------------------------------------

def _jax_dtype_free(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}


@pytest.mark.parametrize("arch_id", ["gat-cora", "egnn", "nequip", "mace"])
def test_configs_and_n_params_match_reference(arch_id):
    jarch, tarch = jconfigs.ARCHS[arch_id], GNN_ARCHS[arch_id]
    assert (tarch.arch_id, tarch.kind, tarch.family) == \
        (jarch.arch_id, jarch.kind, jarch.family)
    assert list(tfam.GNN_SHAPES) == jarch.shape_ids()
    for dims in (tfam.FULL_DIMS, tfam.REDUCED_DIMS):
        for shape, d in dims.items():
            for fn in ("full_cfg_fn", "smoke_cfg_fn"):
                jc = getattr(jarch, fn)(d["d"])
                tc = getattr(tarch, fn)(d["d"])
                assert _jax_dtype_free(tc) == _jax_dtype_free(jc)
                assert tc.dtype == torch.float32
                assert tc.n_params() == jc.n_params()


def test_shapes_and_dims_match_reference():
    assert tfam.GNN_SHAPES == jfam.GNN_SHAPES
    assert tfam.FULL_DIMS == jfam.FULL_DIMS
    assert tfam.REDUCED_DIMS == jfam.REDUCED_DIMS
    assert tfam._pad(1) == jfam._pad(1) == 512
    assert tfam.FULL_DIMS["molecule"] == dict(N=4096, E=8192, d=16,
                                              seeds=3840, n_graphs=128)
    assert set(GNN_ARCHS) == {a for a, arch in jconfigs.ARCHS.items()
                              if arch.family == "gnn"}


@pytest.mark.parametrize("arch_id", ["gat-cora", "egnn", "nequip", "mace"])
def test_init_params_shapes_match_reference(arch_id):
    d = DIMS["molecule"]["d"]
    jarch, tarch = jconfigs.ARCHS[arch_id], GNN_ARCHS[arch_id]
    jc, tc = jarch.smoke_cfg_fn(d), tarch.smoke_cfg_fn(d)
    mod = {"gat": (jgat, gat), "egnn": (jegnn, egnn)}.get(
        tarch.kind, (jeq, equivariant))
    want = mod[1].params_from_jax(
        tc, jax_np(mod[0].init_params(jc, jax.random.key(0))), device="cpu")
    got = mod[1].init_params(tc, torch.Generator().manual_seed(0),
                             device="cpu")
    gp, gl = flatten(got)
    wp, wl = flatten(want)
    assert gp == wp
    assert [tuple(x.shape) for x in gl] == [tuple(x.shape) for x in wl]
    assert all(x.dtype == torch.float32 for x in gl)
    assert sum(x.numel() for x in gl) > 0


def test_mesh_hints_and_missing_card_raise():
    """The mesh hints (``shard_axes``) are accepted and change nothing on
    plain tensors; without a card the entry points raise."""
    _, tm, _, tc, tree, x = _mol_case("nequip", fused_agg=True)
    _, tg, coords = molecules(10)
    hinted = dataclasses.replace(tc, shard_axes=("data", "model"))
    tp = tm.params_from_jax(tc, tree, device="cpu")
    with torch.no_grad():
        assert torch.equal(
            tm.forward(tc, tp, torch.from_numpy(x),
                       torch.from_numpy(coords), tg),
            tm.forward(hinted, tp, torch.from_numpy(x),
                       torch.from_numpy(coords), tg))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = GNN_ARCHS["nequip"].smoke_cfg_fn(8)
    with pytest.raises(NoCudaDevice):
        equivariant.init_params(cfg, torch.Generator())
    with pytest.raises(NoCudaDevice):
        common.pad_graph([0], [1], 2, 4, 4)
    with pytest.raises(NoCudaDevice):
        sampler.sample_fanout_device(torch.Generator(), [0, 1], [0], [0], 2)
    with pytest.raises(NoCudaDevice):
        gat.params_from_jax(None, {})


# --- the reference's property tests, on the port --------------------------------

def test_cg_invariance_under_rotation():
    rng = np.random.default_rng(0)
    R = rotation(3).astype(np.float64)

    def wigner_from_sh(l):
        X = rng.normal(size=(80, 3)).astype(np.float32)
        Y = e3.spherical_harmonics(torch.from_numpy(X), 3)[l].double()
        YR = e3.spherical_harmonics(torch.from_numpy(
            (X @ R.T).astype(np.float32)), 3)[l].double()
        D, *_ = np.linalg.lstsq(Y.numpy(), YR.numpy(), rcond=None)
        return D.T

    D = {l: wigner_from_sh(l) for l in range(4)}
    for l in range(4):
        assert np.allclose(D[l] @ D[l].T, np.eye(2 * l + 1), atol=2e-4)
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(abs(l1 - l2), min(l1 + l2, 3) + 1):
                cg = e3.real_clebsch_gordan(l1, l2, l3)
                rot = np.einsum("ai,bj,ck,ijk->abc", D[l1], D[l2], D[l3], cg)
                assert np.allclose(rot, cg, atol=2e-3), (l1, l2, l3)


def test_cg_nonzero_and_selection_rules():
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(4):
                cg = e3.su2_clebsch_gordan(l1, l2, l3)
                if abs(l1 - l2) <= l3 <= l1 + l2:
                    assert np.abs(cg).max() > 0
                else:
                    assert np.abs(cg).max() == 0


@pytest.mark.parametrize("arch_id", ["egnn", "nequip", "mace"])
def test_energy_invariant_and_forces_equivariant(arch_id):
    _, tm, _, tc, tree, x = _mol_case(arch_id, seed=16)
    _, tg, coords = molecules(17)
    tp = tm.params_from_jax(tc, tree, device="cpu")
    R = rotation(1)
    shift = np.asarray([0.3, -1.2, 2.0], np.float32)
    moved = coords @ R.T + shift
    with torch.no_grad():
        e1, f1 = tm.energy_and_forces(tc, tp, torch.from_numpy(x),
                                      torch.from_numpy(coords), tg)
        e2, f2 = tm.energy_and_forces(tc, tp, torch.from_numpy(x),
                                      torch.from_numpy(moved), tg)
        g1 = _energy(tm, tc, tp, torch.from_numpy(x),
                     torch.from_numpy(coords), tg)
        g2 = _energy(tm, tc, tp, torch.from_numpy(x),
                     torch.from_numpy(moved), tg)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(float(e2), float(e1), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(f2.numpy(), f1.numpy() @ R.T, atol=2e-3,
                               rtol=1e-3)
