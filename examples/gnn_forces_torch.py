"""Molecular-dynamics-style training on the PyTorch/CUDA package (the
counterpart of ``examples/gnn_forces.py``): train EGNN and MACE on
batched small molecules with an energy objective (the `molecule` shape
cell).

    PYTHONPATH=src python examples/gnn_forces_torch.py                # H100
    PYTHONPATH=src python examples/gnn_forces_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np                                      # noqa: E402
import torch                                            # noqa: E402
import torch.nn.functional as F                         # noqa: E402

from repro_torch.models.gnn import common, egnn, equivariant  # noqa: E402
from repro_torch.optim import adamw                     # noqa: E402
from repro_torch.train.trainer import _value_and_grad   # noqa: E402


def make_batch(rng, device, n_mol=8, n_atoms=6):
    """Toy target: energy = sum of pairwise LJ-ish terms (rotation
    invariant), forces = -grad."""
    N = n_mol * n_atoms
    coords = rng.normal(size=(N, 3)).astype(np.float32)
    species = rng.integers(0, 4, N).astype(np.int32)
    gi = np.repeat(np.arange(n_mol), n_atoms).astype(np.int32)
    send, recv = [], []
    for m in range(n_mol):
        for i in range(n_atoms):
            for j in range(n_atoms):
                if i != j:
                    send.append(m * n_atoms + i)
                    recv.append(m * n_atoms + j)
    g = common.pad_graph(np.array(send), np.array(recv), N,
                         len(send), N, graph_ids=gi, n_graphs=n_mol,
                         device=device)

    def true_energy(c):
        d2 = np.sum((c[send] - c[recv]) ** 2, -1) + 0.5
        e_edge = 1.0 / d2 - 1.0 / d2 ** 0.5
        out = np.zeros(n_mol)
        np.add.at(out, gi[np.array(send)], e_edge / 2)
        return out.astype(np.float32)

    def on(a):
        return torch.from_numpy(a).to(device)

    return g, on(species).long(), on(coords), on(true_energy(coords))


def train(model_name: str, steps: int = 60, device: str = "cuda"):
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    if model_name == "egnn":
        cfg = egnn.EGNNConfig(n_layers=3, d_hidden=32, d_in=4)
        params = egnn.init_params(cfg, gen, device=device)

        def energy_fn(p, species, coords, g):
            feats = F.one_hot(species, 4).float()
            return egnn.forward(cfg, p, feats, coords, g)[0]
    else:
        cfg = equivariant.EquivariantConfig(arch=model_name, n_layers=2,
                                            channels=16, l_max=2,
                                            correlation=3, n_species=4,
                                            cutoff=4.0)
        params = equivariant.init_params(cfg, gen, device=device)

        def energy_fn(p, species, coords, g):
            return equivariant.forward(cfg, p, species, coords, g)

    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=steps,
                                weight_decay=0.0)
    state = adamw.init(params)

    def loss_fn(p, batch):
        g, species, coords, e_tgt = batch
        return torch.mean((energy_fn(p, species, coords, g) - e_tgt) ** 2)

    def step(params, state, batch):
        loss, grads = _value_and_grad(loss_fn, params, batch)
        params, state, _ = adamw.update(opt_cfg, grads, state, params)
        return params, state, loss

    # one batch's loss swings by orders of magnitude from batch to batch
    # (MACE's products of close atoms), so the progress check reads a
    # held-out batch before and after training
    held_out = make_batch(np.random.default_rng(1), device)
    with torch.no_grad():
        before = float(loss_fn(params, held_out))
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, make_batch(rng, device))
        losses.append(float(loss))
    with torch.no_grad():
        after = float(loss_fn(params, held_out))
    print(f"{model_name:7s} loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(held-out {before:.4f} -> {after:.4f})")
    assert after < before


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the models train (default: the card)")
    dev = ap.parse_args().device
    train("egnn", device=dev)
    train("mace", steps=30, device=dev)
