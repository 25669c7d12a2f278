"""Helpers of the tests/test_torch_cells_*.py files: the port's cell
programs (repro_torch.configs) against the JAX package's
(repro.configs), cell by cell.

* At full size, abstractly: kind, model FLOPs and bytes, cost scale, the
  arguments' shapes and dtypes and their partition specs, leaf for leaf.
  The reference stacks the LM's layers and bert4rec's blocks on a
  leading axis where the port keeps a list of per-layer dicts, so such a
  leaf is matched to the stacked one with the layer axis (and its spec
  entry) dropped.
* At ``reduced=True``, concretely: the reference's ``zeros_from_abstract``
  arguments are carried across to the port (:func:`carry`, which unstacks
  as ``params_from_jax`` does), one step runs through the reference's
  jitted ``step_fn`` and through the port's, and every output is held
  equal: floats within :data:`RTOL` / :data:`ATOL` (f32), or, on the
  bf16 ``fused_agg`` path, within :data:`BF16_SCALE` of the output's
  largest magnitude (tests/test_torch_gnn.py's bound); integers exactly.
  A GNN cell's integer arguments are drawn in range (:func:`draw_graph`):
  all-zero ones mask every node and edge out, and its gradients vanish.
  A train cell steps at ``torch_update.STEP``, past the optimizer's
  warm-up, and its update (new minus old params, ``m`` and ``v``) is also
  held to the reference's within ``torch_update.UPDATE_TOL`` of the
  update's own scale (the bf16 path: :data:`BF16_SCALE`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec

import repro.configs as jconfigs
from repro.configs.families.base import zeros_from_abstract as j_zeros
import repro_torch.configs as tconfigs
from repro_torch.tree import flatten, keystr, tensor_from_numpy
from torch_update import STEP, UPDATE_TOL, update_errors

RTOL, ATOL = 1e-4, 1e-5            # f32
BF16_SCALE = 3e-2                  # bf16 fused_agg: of the output's scale
SEED = 3

OPTIMIZED = [("bert4rec", "serve_bulk"), ("mace", "molecule"),
             ("qwen2-1.5b", "train_4k")]


def runnable(family):
    """(arch, shape) of every non-skipped cell of ``family``."""
    return [(a, s) for a, s in tconfigs.all_cells()
            if tconfigs.ARCHS[a].family == family
            and tconfigs.ARCHS[a].skip_reason(s) is None]


def cells(family):
    return [(a, s) for a, s in tconfigs.all_cells()
            if tconfigs.ARCHS[a].family == family]


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _index(tree, i):
    """Layer ``i`` of a tree stacked on its leading axis."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, i) for v in tree]
    return np.asarray(tree)[i]


def carry(port, ref):
    """The reference's numpy tree ``ref`` as tensors in the structure of
    the port's tree ``port`` (abstract or concrete): where the port holds
    a list and the reference a dict of stacked arrays, the layer axis is
    unstacked.  Shapes must agree leaf for leaf."""
    if isinstance(port, dict):
        assert set(port) == set(ref), (sorted(port), sorted(ref))
        return {k: carry(port[k], ref[k]) for k in port}
    if isinstance(port, (list, tuple)):
        if isinstance(ref, dict):
            return [carry(p, _index(ref, i)) for i, p in enumerate(port)]
        assert len(port) == len(ref)
        return type(port)(carry(p, r) for p, r in zip(port, ref))
    t = tensor_from_numpy(ref, "cpu")
    assert tuple(t.shape) == tuple(port.shape), (t.shape, port.shape)
    return t


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {jax.tree_util.keystr(p): x for p, x in flat}


STACKED = ("layers", "blocks")     # the reference's stacked containers


def _unstacked(path):
    """The reference's path of a port leaf inside a per-layer list:
    ``[0]['layers'][3]['wq']`` -> ``[0]['layers']['wq']``."""
    return keystr(tuple(k for i, k in enumerate(path)
                        if not (isinstance(k, int) and i > 0
                                and path[i - 1] in STACKED)))


def match_leaves(port_tree, ref_tree):
    """[(port leaf, reference leaf, stacked)] over every leaf of both
    trees; every reference leaf is matched."""
    ref = _ref_leaves(ref_tree)
    paths, leaves = flatten(port_tree)
    out, seen = [], set()
    for path, leaf in zip(paths, leaves):
        key = keystr(path)
        stacked = key not in ref
        if stacked:
            key = _unstacked(path)
        assert key in ref, key
        seen.add(key)
        out.append((key, leaf, ref[key], stacked))
    assert seen == set(ref), sorted(set(ref) - seen)
    return out


def check_abstract(aid, sid, multipod):
    """The full-size cell's program equal to the reference's."""
    jp = jconfigs.get_arch(aid).build(sid, multipod=multipod)
    tp = tconfigs.get_arch(aid).build(sid, multipod=multipod)
    assert (tp.arch_id, tp.shape_id, tp.kind) == (jp.arch_id, jp.shape_id,
                                                  jp.kind)
    assert tp.model_flops == jp.model_flops
    assert tp.model_bytes == jp.model_bytes
    assert tp.cost_scale == jp.cost_scale
    assert len(tp.abstract_args) == len(jp.abstract_args)
    for key, leaf, ref, stacked in match_leaves(tp.abstract_args,
                                                jp.abstract_args):
        shape = tuple(ref.shape[1:] if stacked else ref.shape)
        assert leaf.device.type == "meta", key
        assert tuple(leaf.shape) == shape, (key, leaf.shape, shape)
        assert _dtype_name(leaf.dtype) == _dtype_name(ref.dtype), key
    for key, spec, ref, stacked in match_leaves(tp.arg_specs, jp.arg_specs):
        want = tuple(ref)[1:] if stacked and len(ref) else tuple(ref)
        assert tuple(spec) == want, (key, spec, ref)


def draw_graph(aid, sid, args):
    """A reduced GNN cell's arguments with the graph drawn in range:
    senders and receivers (no self-loops) over the N nodes, graph ids over
    the graphs, masks half set, and GAT's labels and the equivariant nets'
    species ids within their counts.  Other archs' ``args`` as they are."""
    arch = tconfigs.ARCHS[aid]
    if arch.family != "gnn":
        return args
    from repro_torch.configs.families.gnn import REDUCED_DIMS
    dims = REDUCED_DIMS[sid]
    N, E = dims["N"], dims["E"]
    cfg = arch.smoke_cfg_fn(dims["d"])
    rng = np.random.default_rng(SEED)
    receivers = rng.integers(0, N, E)
    graph = dict(senders=(receivers + rng.integers(1, N, E)) % N,
                 receivers=receivers,
                 node_mask=rng.random(N) < 0.5, edge_mask=rng.random(E) < 0.5,
                 graph_ids=rng.integers(0, dims["n_graphs"], N))
    at = 5 if arch.kind == "gat" else 6           # the graph's argument
    new = {at: graph}
    if arch.kind == "gat":
        new[6] = rng.integers(0, cfg.n_classes, args[6].shape)
    elif arch.kind != "egnn":
        new[4] = rng.integers(0, cfg.n_species, args[4].shape)
    return tuple(jax.tree.map(lambda n, o: jnp.asarray(n, o.dtype),
                              new[i], a) if i in new else a
                 for i, a in enumerate(args))


def reference_outputs(cases, optimized=False):
    """{(arch, shape): (numpy args, numpy outputs)} of the reference's
    reduced cells, one jitted step each."""
    out = {}
    for aid, sid in cases:
        jp = jconfigs.get_arch(aid).build(sid, reduced=True,
                                          optimized=optimized)
        args = draw_graph(aid, sid, j_zeros(jp.abstract_args, seed=SEED))
        if jp.kind == "train":
            args = (*args[:3], np.int32(STEP), *args[4:])
        res = jax.jit(jp.step_fn)(*args)
        out[aid, sid] = (jax.tree.map(np.asarray, args),
                         jax.tree.map(np.asarray, res))
    return out


def check_reduced(aid, sid, ref, optimized=False, bf16=False):
    """One port step on the reference's arguments, every output held to
    the reference's."""
    jargs, jout = ref
    tp = tconfigs.get_arch(aid).build(sid, reduced=True, optimized=optimized)
    args = carry(tp.abstract_args, jargs)
    for a, t in zip(flatten(tp.abstract_args)[1], flatten(args)[1]):
        assert a.dtype == t.dtype, (aid, sid, a.dtype, t.dtype)
    got = tp.step_fn(*args)
    want = carry(got, jout)
    n = 0
    for (path, g), w in zip(zip(*flatten(got)), flatten(want)[1]):
        g, w = g.detach(), w
        if g.dtype.is_floating_point:
            g, w = g.float().numpy(), w.float().numpy()
            assert np.isfinite(g).all(), (aid, sid, path)
            if bf16:
                scale = max(np.abs(w).max(), 1e-30)
                assert np.abs(g - w).max() <= BF16_SCALE * scale, \
                    (aid, sid, path)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{aid} {sid} {path}")
        else:
            np.testing.assert_array_equal(g.long().numpy(),
                                          w.long().numpy(),
                                          err_msg=f"{aid} {sid} {path}")
        n += 1
    assert n > 0
    if tp.kind == "train":
        assert int(args[3]) == STEP
        tol = BF16_SCALE if bf16 else UPDATE_TOL
        for path, err in update_errors(args, got, want).items():
            assert err <= tol, (aid, sid, path, err)
    return n
