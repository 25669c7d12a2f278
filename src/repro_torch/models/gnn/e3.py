"""Minimal E(3)-equivariance library: real spherical harmonics (l <= 3),
Clebsch-Gordan coupling in the real basis, Bessel radial basis.

Self-contained (no e3nn): complex-basis CG from the Racah closed form,
transformed to the real SH basis with the standard unitary change of basis
(the (-1j)**l phase makes the real-basis coefficients real).  The tables
are numpy (float64) and equal the reference's; the functions on features
are PyTorch.  Correctness is *property-tested*: the CG tables are
invariant under the Wigner matrices the harmonics give, and the models
built on top are tested for rotation equivariance
(tests/test_torch_gnn.py).

Forces differentiate through these functions and training differentiates
the forces again, so each has finite second derivatives at ``r = 0``
(pad edges are self-loops).
"""
from __future__ import annotations

import functools
from math import factorial, sqrt

import numpy as np
import torch


# ---------------------------------------------------------------------------
# complex-basis (su2) Clebsch-Gordan, Racah closed form
# ---------------------------------------------------------------------------

def _su2_cg_coeff(j1, m1, j2, m2, j3, m3) -> float:
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    f = factorial
    pref = (2 * j3 + 1) * f(j1 + j2 - j3) * f(j1 - j2 + j3) * \
        f(-j1 + j2 + j3) / f(j1 + j2 + j3 + 1)
    pref *= f(j3 + m3) * f(j3 - m3) * f(j1 - m1) * f(j1 + m1) * \
        f(j2 - m2) * f(j2 + m2)
    s = 0.0
    for k in range(0, j1 + j2 - j3 + 1):
        denom_terms = [k, j1 + j2 - j3 - k, j1 - m1 - k, j2 + m2 - k,
                       j3 - j2 + m1 + k, j3 - j1 - m2 + k]
        if any(d < 0 for d in denom_terms):
            continue
        denom = 1
        for d in denom_terms:
            denom *= f(d)
        s += (-1) ** k / denom
    return sqrt(pref) * s


@functools.lru_cache(maxsize=None)
def su2_clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    C = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            for m3 in range(-l3, l3 + 1):
                C[m1 + l1, m2 + l2, m3 + l3] = _su2_cg_coeff(
                    l1, m1, l2, m2, l3, m3)
    return C


@functools.lru_cache(maxsize=None)
def _real_to_complex(l: int) -> np.ndarray:
    """Unitary Q with v_complex = Q @ v_real (e3nn convention; the
    (-1j)**l global phase makes the real-basis CG real)."""
    q = np.zeros((2 * l + 1, 2 * l + 1), dtype=complex)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = 1 / sqrt(2)
        q[l + m, l - abs(m)] = -1j / sqrt(2)
    q[l, l] = 1.0
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = (-1) ** m / sqrt(2)
        q[l + m, l - abs(m)] = 1j * (-1) ** m / sqrt(2)
    return (-1j) ** l * q


@functools.lru_cache(maxsize=None)
def real_clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """CG coupling tensor in the real SH basis, [2l1+1, 2l2+1, 2l3+1]."""
    C = su2_clebsch_gordan(l1, l2, l3).astype(complex)
    Q1, Q2, Q3 = _real_to_complex(l1), _real_to_complex(l2), _real_to_complex(l3)
    # real tensor: contract the complex CG with Q1, Q2 and conj(Q3)
    # (sum over the complex index of each factor)
    Cr = np.einsum("ai,bj,abc,ck->ijk", Q1, Q2, C, np.conj(Q3))
    assert np.abs(Cr.imag).max() < 1e-9, (l1, l2, l3, np.abs(Cr.imag).max())
    return np.ascontiguousarray(Cr.real)


@functools.lru_cache(maxsize=None)
def cg_tensor(l1: int, l2: int, l3: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """:func:`real_clebsch_gordan` as a tensor, made once per dtype and
    device: copying host data to the card waits for its stream."""
    return torch.as_tensor(real_clebsch_gordan(l1, l2, l3), dtype=dtype,
                           device=device)


# ---------------------------------------------------------------------------
# real spherical harmonics (component-normalized), l <= 3
# ---------------------------------------------------------------------------

def spherical_harmonics(vec: torch.Tensor, l_max: int, eps: float = 1e-9):
    """vec [..., 3] -> dict {l: [..., 2l+1]} of real SH of the direction.

    Normalization: Y_0 = 1; higher l carry the standard sqrt((2l+1))
    component normalization (constant factors are absorbed by the learned
    radial weights downstream, so only ratios matter).
    """
    # safe norm: sqrt(max(r2, eps^2)) has zero (not NaN) gradient at r=0 —
    # required because forces differentiate through here (grad-of-grad)
    r2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    r = torch.sqrt(torch.clamp(r2, min=eps * eps))
    u = vec / torch.clamp(r, min=eps)
    # zero vectors have no direction: l >= 1 harmonics must vanish there
    # (self-loop / padding edges), else they inject a constant
    # non-transforming component that breaks equivariance.
    valid = (r > eps).to(vec.dtype)
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    out = {0: torch.ones(vec.shape[:-1] + (1,), dtype=vec.dtype,
                         device=vec.device)}
    if l_max >= 1:
        out[1] = torch.stack([y, z, x], dim=-1) * sqrt(3.0) * valid
    if l_max >= 2:
        out[2] = torch.stack([
            sqrt(15.0) * x * y,
            sqrt(15.0) * y * z,
            sqrt(5.0) / 2.0 * (3 * z * z - 1.0),
            sqrt(15.0) * x * z,
            sqrt(15.0) / 2.0 * (x * x - y * y),
        ], dim=-1) * valid
    if l_max >= 3:
        out[3] = torch.stack([
            sqrt(35.0 / 8.0) * y * (3 * x * x - y * y),
            sqrt(105.0) * x * y * z,
            sqrt(21.0 / 8.0) * y * (5 * z * z - 1.0),
            sqrt(7.0) / 2.0 * z * (5 * z * z - 3.0),
            sqrt(21.0 / 8.0) * x * (5 * z * z - 1.0),
            sqrt(105.0) / 2.0 * z * (x * x - y * y),
            sqrt(35.0 / 8.0) * x * (x * x - 3 * y * y),
        ], dim=-1) * valid
    return out


# ---------------------------------------------------------------------------
# radial basis
# ---------------------------------------------------------------------------

def bessel_rbf(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """Sine-Bessel radial basis with smooth polynomial cutoff (NequIP)."""
    r = torch.clamp(r, min=1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = torch.sin(n * np.pi * r[..., None] / r_cut) / r[..., None]
    # p=6 polynomial cutoff envelope
    u = torch.clamp(r / r_cut, 0.0, 1.0)
    env = 1.0 - 10.0 * u**3 + 15.0 * u**4 - 6.0 * u**5
    return basis * env[..., None]


# ---------------------------------------------------------------------------
# irreps feature dict helpers: feats = {l: [N, C, 2l+1]}
# ---------------------------------------------------------------------------

def irreps_zeros(n: int, channels: int, l_max: int, dtype=torch.float32,
                 device=None):
    return {l: torch.zeros((n, channels, 2 * l + 1), dtype=dtype,
                           device=device)
            for l in range(l_max + 1)}


def tensor_product(a, b_sh, l_max: int):
    """Channel-wise tensor product of node irreps ``a`` {l1: [E, C, m1]}
    with edge SH ``b_sh`` {l2: [E, m2]} -> {l3: [E, C, P_l3, m3]} where
    P_l3 enumerates contributing (l1, l2) paths."""
    out = {l: [] for l in range(l_max + 1)}
    for l1, fa in a.items():
        for l2, fb in b_sh.items():
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                cg = cg_tensor(l1, l2, l3, fa.dtype, fa.device)
                out[l3].append(torch.einsum("eci,ej,ijk->eck", fa, fb, cg))
    return {l: torch.stack(v, dim=2) for l, v in out.items() if v}


def self_tensor_product(a, b, l_max: int):
    """Channel-wise product of two irreps dicts {l: [N, C, m]} (MACE
    symmetric contractions) -> {l3: [N, C, P, m3]}."""
    out = {l: [] for l in range(l_max + 1)}
    for l1, fa in a.items():
        for l2, fb in b.items():
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                cg = cg_tensor(l1, l2, l3, fa.dtype, fa.device)
                out[l3].append(torch.einsum("nci,ncj,ijk->nck", fa, fb, cg))
    return {l: torch.stack(v, dim=2) for l, v in out.items() if v}


def linear_mix(feats, weights):
    """Per-l channel mixing: feats {l: [N, C_in(, P), m]} with weights
    {l: [C_in*P, C_out]} -> {l: [N, C_out, m]}."""
    out = {}
    for l, f in feats.items():
        if f.dim() == 4:
            n, c, p, m = f.shape
            f = f.permute(0, 3, 1, 2).reshape(n, m, c * p)
        else:
            f = f.permute(0, 2, 1)
        out[l] = torch.einsum("nmc,cd->ndm", f, weights[l])
    return out
