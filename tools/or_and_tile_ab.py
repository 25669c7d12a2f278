#!/usr/bin/env python3
"""Time the or-and kernel's tile route at the paths' shapes with the
package of one or more source trees, each in a child process, in the order
given (``tools/_ab.py``):

    git archive <commit> src | tar -x -C build/parent
    python3 tools/or_and_tile_ab.py build/parent . . build/parent

(``build/`` is ignored by git; one CUDA device.)  Each child imports
``repro_torch`` from ``<tree>/src``, builds its kernels there, makes its
operands with its own ``kmajor_copy`` (so at its own row pitch), and
prints one JSON line with the card's name and power limit and, for each
shape, the median of 5 runs of ``REPS`` calls (CUDA events after a
warm-up), each product first checked against the plain version:

- ``T_ms``: the rank update's T, ``or_and_matmul_nt(rows, C^T)`` at
  [64, 16103] x [16103, 16103], with ``rows`` as the repair handed it
  before it was gathered into padded storage (not K-major, so each call
  copies it), and ``T_kmajor_rows_ms`` with ``rows`` copied K-major once;
- ``squaring_ms``: the closure squaring's product, ``or_and_matmul_nt(C,
  C^T)`` at [16039]^2 (5 runs of 3 calls), and ``compose_ms``: the batched
  compose, ``or_and_matmul_nt(sb, C^T)`` at [256, 16039] x [16039, 16039];
- ``pitch``: the row pitch (bytes) of the tree's padded [*, 16039] and
  [*, 16103] matrices;
- ``floor_pair_ms``, for a tree that has ``or_and_floor_pair``: that call
  on the dynamic phase's P shape, [16103, K] x [K, 16103] with a floor
  pair at density 0.3, for K = 0 (no product: the floor tiles go through
  shared memory and back) and 64, with every matrix at the tree's pitch
  (16128) and at the 16-byte pitch (16112, ``ops.LINE_MIN`` set past the
  width for the call), each with ``tb_per_s``, the rate over the bytes it
  moves (both floors read, both outputs written, at the pitch).

The operands are seeded random matrices: C at density 0.3, rows and the
compose's sb at 0.01.
"""
import statistics
import sys
from pathlib import Path

import _ab

NB, NB_SQ, R, BATCH, REPS = 16103, 16039, 64, 256, 20
FLOOR_KS = (0, 64)


def timed(fn, reps=REPS):
    """The median of 5 runs of ``reps`` calls, after a warm-up (ms)."""
    import torch
    fn()
    torch.cuda.synchronize()
    return statistics.median(_ab.events_ms(fn, reps)[0] for _ in range(5))


def checked(what, got, want):
    import torch
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: the kernel disagrees with its plain "
                             "version")


def floor_pairs(out: dict, bops, C, g) -> None:
    """The floor-pair call at the P shape for each K of ``FLOOR_KS``, every
    matrix at the pitch ``bops.pitch`` gives now."""
    import torch
    F, Ft = bops.kmajor_copy(C), bops.kmajor_copy(C.T)
    for k in FLOOR_KS:
        left, Tt = (bops.kmajor_copy(torch.rand((NB, k), device=C.device,
                                                generator=g) < 0.01)
                    for _ in range(2))
        got = bops.or_and_floor_pair(left, Tt, F, Ft)
        want = bops.or_and_floor_pair_ref(left, Tt, F, Ft)
        checked(f"floor pair K {k}", got[0], want[0])
        checked(f"floor pair K {k} C^T", got[1], want[1])
        del got, want
        key = f"pitch {F.stride(0)}, K {k}"
        ms = timed(lambda: bops.or_and_floor_pair(left, Tt, F, Ft))
        out["floor_pair_ms"][key] = ms
        out["tb_per_s"][key] = 4 * NB * F.stride(0) / ms / 1e9


def child(tree: Path) -> dict:
    import torch
    from repro_torch.kernels.bool_matmul import ops as bops
    from repro_torch.kernels.bool_matmul import (kmajor, kmajor_copy,
                                                 or_and_matmul_nt,
                                                 or_and_matmul_ref)
    _ab.from_tree(bops, tree)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    out = {"pitch": {str(n): bops.pitch(n) for n in (NB_SQ, NB)}}
    C = torch.rand((NB, NB), device=dev, generator=g) < 0.3
    Ct = kmajor_copy(C.T)
    rows = torch.rand((R, NB), device=dev, generator=g) < 0.01
    rows_k = kmajor(rows)
    checked("T", or_and_matmul_nt(rows, Ct), or_and_matmul_ref(rows, C))
    out["T_ms"] = timed(lambda: or_and_matmul_nt(rows, Ct))
    out["T_kmajor_rows_ms"] = timed(lambda: or_and_matmul_nt(rows_k, Ct))

    if hasattr(bops, "or_and_floor_pair"):
        out["floor_pair_ms"], out["tb_per_s"] = {}, {}
        line_min = bops.LINE_MIN
        try:
            floor_pairs(out, bops, C, g)        # rows on 128-byte lines
            bops.LINE_MIN = 1 << 30             # rows 16 bytes apart
            floor_pairs(out, bops, C, g)
        finally:
            bops.LINE_MIN = line_min
    del C, Ct, rows, rows_k
    torch.cuda.empty_cache()

    C = torch.rand((NB_SQ, NB_SQ), device=dev, generator=g) < 0.3
    Ck, Ct = kmajor_copy(C), kmajor_copy(C.T)
    sb = kmajor_copy(torch.rand((BATCH, NB_SQ), device=dev,
                                generator=g) < 0.01)
    checked("squaring", or_and_matmul_nt(Ck, Ct), or_and_matmul_ref(C, C))
    checked("compose", or_and_matmul_nt(sb, Ct), or_and_matmul_ref(sb, C))
    out["squaring_ms"] = timed(lambda: or_and_matmul_nt(Ck, Ct), reps=3)
    out["compose_ms"] = timed(lambda: or_and_matmul_nt(sb, Ct))
    return out


if __name__ == "__main__":
    sys.exit(_ab.main(sys.argv[1:], __file__, __doc__, child))
