#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on any failure (the script then exits
non-zero and prints no result line):

1. build   — compile every CUDA kernel from ``src/repro_torch/kernels/*/
             csrc/*.cu`` with nvcc for sm_90a (one nvcc per source, all at
             once) into ``build/repro_torch/``; print the card's name and
             power limit, the compiler's register report and each
             library's most frequent SASS opcodes; the or-and kernel's
             SASS must hold a warpgroup MMA opcode (*GMMA).
2. parity  — hold each kernel bit-equal to its plain PyTorch version on the
             card over a sweep of shapes and densities (and K = 0), the
             or-and kernel also through its K-major entry with C^T written
             by the same launch; the bit-packed product also against the
             or-and kernel, with K = 31, 32, 33 and words whose bit 31 is
             set.
3. main    — the query path at full size: an Erdos-Renyi graph of 16384
             nodes and 65536 edges over 8 labels, randomly cut into 16
             fragments; ``repro_torch.connect(fr)``, ``warm(with_dist=True)``,
             then one ``run`` of 256 Reach + 256 Dist (half bounded at 6).
             64 sampled answers per kind are checked against a host BFS, and
             both kernels must have launched during the run.  The kernels
             are then held against their plain versions on the full
             closure squarings and batch composes of the real operands,
             and timed at those shapes; the or-and squaring also beside
             its operand preparation, the former route (pack + bit-packed
             kernel) and two library calls (cuBLAS fp16, torch._int_mm).
4. sharded — the same graph and queries through the sharded backend,
             ``connect(fr, backend="shard_map")`` on a one-rank NCCL group
             (d = 1, all 16 fragments packed on the card): one timed ``run``
             of the 256 Reach and one of the 256 Dist, each checked against
             the host BFS and the vmap session's answers, with exactly one
             collective per group of ``traffic_bits`` bits; the per-batch
             time split into local stage, collective, closure and combine.
             The bit-packed kernel is held against its plain version and
             the or-and kernel on ``D0 | I`` taken from the merged wire.
5. rpq     — regular path queries at a reduced size (2048 nodes, 8
             fragments), through the vmap session and then the sharded
             one: the product closure has side nb * |Q|, which at full size
             is a 6.4 GB matrix whose squaring would outlast a smoke run.
             Answers are checked against a host product-graph BFS.

The second-to-last line of output is a JSON object with one entry per
kernel; the last is ``{"ok": true, "device": {...}}``.  Times come from
CUDA events after a warm-up; bounds are reckoned from the H100 SXM data
sheet (3.35 TB/s, 1979 TOPS int8, 64 int32 operations per clock per SM
at the card's maximum SM clock) and, for the SIMT min-plus, from the DPX
rate that the probe ``csrc/dpx_rate.cu`` measures in the same run.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT8_TENSOR_OPS_PER_S = 1979e12    # H100 SXM data sheet, dense
INT32_OPS_PER_CLOCK_PER_SM = 64    # H100 SXM data sheet (LOP3 included)


def _require_repo():
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py must run from a checkout of the repo "
                         f"(no src/repro_torch beside {__file__})")
    sys.path.insert(0, str(src))


def _nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _bound(ops, ops_rate, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``ops`` operations at ``ops_rate`` and ``nbytes`` moved once."""
    t_ops, t_bytes = ops / ops_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def cuda_timed(fn, reps: int, warmup: bool = True):
    """Milliseconds per call of ``fn`` on the card (CUDA events, after one
    warm-up call unless ``warmup`` is False) and the last call's result."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        result = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, result


def dpx_rate() -> float:
    """__viaddmin_s32 operations per second over the whole card, from the
    probe ``csrc/dpx_rate.cu``: 8 blocks of 256 threads per SM (full
    occupancy), 2^16 rounds of 8 DPX instructions per thread."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    lib = _build.library("dpx_rate")
    fn = lib.dpx_rate
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(0).multi_processor_count * 8
    iters = 1 << 16
    seed = torch.tensor([1, 9, 8, 7, 6, 5, 4, 3, 2], dtype=torch.int32,
                        device="cuda")
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _build.check(lib, "dpx_rate", fn(seed.data_ptr(), out.data_ptr(),
                                         blocks, iters, stream))
    ms, _ = cuda_timed(launch, 3)
    return blocks * 256 * iters * 8 / (ms * 1e-3)


def _sass_opcodes(lib: Path):
    """SASS opcode counts of a built library (cuobjdump), a Counter."""
    from collections import Counter
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    ops = Counter()
    for line in sass.splitlines():
        # "/*0080*/  @P0 VIADDMNMX R3, R4, ... ;  /* 0x... */"
        if not line.strip().startswith("/*") or "*/" not in line:
            continue
        words = [w for w in line.split("*/", 1)[1].split()
                 if not w.startswith("@")]
        if words and not words[0].startswith("/*"):
            ops[words[0].rstrip(";").split(".")[0]] += 1
    return ops


def _top(ops, top: int = 6) -> str:
    return ", ".join(f"{op} {n}" for op, n in ops.most_common(top))


def _counted():
    from repro_torch.kernels.bitpack_ops import ops as pops
    from repro_torch.kernels.bool_matmul import ops as bops
    from repro_torch.kernels.tropical_matmul import ops as tops
    return {"or_and_matmul": bops, "min_plus_matmul": tops,
            "bitpack_matmul": pops}


def _reset_launches():
    for ops in _counted().values():
        ops.launches = 0


def _launches():
    return {name: ops.launches for name, ops in _counted().items()}


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    import ctypes
    import torch
    from repro_torch.kernels import _build
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc {_build.nvcc()}")
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"build: {len(paths)} libraries in "
          f"{time.perf_counter() - t0:.1f} s -> {_build.BUILD_DIR}")
    report = {}
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text()
        ptxas = [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line]
        for line in ptxas:
            print(f"  {name}: {line}")
        ops = _sass_opcodes(path)
        print(f"  {name} SASS: {_top(ops)}")
        report[name] = {"ptxas": ptxas,
                        "gmma": {op: n for op, n in ops.items() if "GMMA" in op}}
    # the or-and kernel runs on the tensor cores: its SASS must hold the
    # warpgroup MMA (IGMMA for 8-bit integers on sm_90a)
    gmma = report["or_and_matmul"]["gmma"]
    if not gmma:
        raise AssertionError("no warpgroup MMA opcode (*GMMA) in the or-and "
                             "kernel's SASS")
    smem_bytes = _build.library("or_and_matmul").or_and_matmul_smem_bytes
    smem_bytes.argtypes, smem_bytes.restype = [], ctypes.c_int
    smem = smem_bytes()
    report["or_and_matmul"]["dynamic_smem_bytes"] = smem
    print(f"  or_and_matmul warpgroup MMA opcodes {gmma}; {smem} bytes of "
          "dynamic shared memory per block")
    card = _nvidia_smi("name,power.limit")
    print(f"card: {card}")
    return {"card": card, "build": report}


# ---------------------------------------------------------------------------
# 2. parity sweep
# ---------------------------------------------------------------------------

SHAPES = [(128, 128, 128), (7, 200, 33), (256, 64, 128), (1, 1, 1),
          (130, 257, 5), (64, 512, 64), (5, 0, 7)]
DENSITIES = [0.0, 0.02, 0.3, 1.0]


def _check_equal(name, got, want):
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({bad} entries differ)")


def _max_abs_err(got, want) -> float:
    return float((got.long() - want.long()).abs().max()) if got.numel() else 0.0


def phase_parity() -> None:
    import torch
    from repro_torch.kernels.bool_matmul import (or_and_matmul,
                                                 or_and_matmul_nt,
                                                 or_and_matmul_ref)
    from repro_torch.kernels.tropical_matmul import (INF, min_plus_matmul,
                                                     min_plus_matmul_ref)
    dev = torch.device("cuda")
    n = 0
    for si, (m, k, n_) in enumerate(SHAPES):
        for density in DENSITIES:
            rng = np.random.default_rng([SEED, si, int(density * 100)])
            a = torch.tensor(rng.random((m, k)) < density, device=dev)
            b = torch.tensor(rng.random((k, n_)) < density, device=dev)
            want = or_and_matmul_ref(a, b)
            _check_equal(f"or_and {m}x{k}x{n_} d={density}",
                         or_and_matmul(a, b), want)
            # the K-major entry with the dual-write epilogue: C and C^T
            c, ct = or_and_matmul_nt(a, b.T, with_transpose=True)
            _check_equal(f"or_and_nt {m}x{k}x{n_} d={density}", c, want)
            _check_equal(f"or_and_nt C^T {m}x{k}x{n_} d={density}", ct, want.T)
            # strided operands: a transposed view and a column slice
            at = torch.tensor(rng.random((k, m)) < density, device=dev).T
            _check_equal(f"or_and strided {m}x{k}x{n_}",
                         or_and_matmul(at, b[:, ::2]),
                         or_and_matmul_ref(at, b[:, ::2]))
            n += 3
        rng = np.random.default_rng([SEED, si, 7])
        a = rng.integers(0, 50, (m, k)).astype(np.int32)
        b = rng.integers(0, 50, (k, n_)).astype(np.int32)
        a[rng.random((m, k)) < 0.3] = INF
        b[rng.random((k, n_)) < 0.3] = INF
        a, b = torch.tensor(a, device=dev), torch.tensor(b, device=dev)
        _check_equal(f"min_plus {m}x{k}x{n_}", min_plus_matmul(a, b),
                     min_plus_matmul_ref(a, b))
        _check_equal(f"min_plus strided {m}x{k}x{n_}",
                     min_plus_matmul(a, b[:, ::2]),
                     min_plus_matmul_ref(a, b[:, ::2]))
        n += 2
    n += _parity_bitpack(dev)
    print(f"parity: {n} kernel calls bit-equal to their plain versions")


def _parity_bitpack(dev) -> int:
    """The bit-packed product on pre-packed words, against its plain
    version and the or-and kernel on the unpacked operands, over the
    sweep and K = 31, 32, 33; row 0 is all ones, so bit 31 is set in
    every one of its words."""
    import torch
    from repro_torch.kernels.bitpack_ops import (bitpack_matmul,
                                                 bitpack_matmul_ref,
                                                 pack_cols, pack_rows,
                                                 pack_rows_ref)
    from repro_torch.kernels.bool_matmul import or_and_matmul
    n = 0
    shapes = SHAPES + [(9, 31, 9), (9, 32, 9), (9, 33, 9)]
    for si, (m, k, n_) in enumerate(shapes):
        for density in DENSITIES:
            rng = np.random.default_rng([SEED, si, int(density * 100), 3])
            a = torch.tensor(rng.random((m, k)) < density, device=dev)
            b = torch.tensor(rng.random((k, n_)) < density, device=dev)
            a[0] = True
            ap, bp = pack_rows(a), pack_cols(b)
            _check_equal(f"pack_rows {m}x{k}", ap, pack_rows_ref(a))
            got = bitpack_matmul(ap, bp, k)
            _check_equal(f"bitpack {m}x{k}x{n_} d={density}", got,
                         bitpack_matmul_ref(ap, bp, k))
            _check_equal(f"bitpack vs or_and {m}x{k}x{n_} d={density}", got,
                         or_and_matmul(a, b))
            n += 1
    return n


# ---------------------------------------------------------------------------
# 3. main path at full size
# ---------------------------------------------------------------------------

N_NODES, N_EDGES, N_LABELS, N_FRAGS = 16384, 65536, 8, 16
N_PER_KIND, N_CHECK = 256, 64


def _check_reach_dist(g, queries, results, n_check):
    from repro_torch import Dist, Reach
    from repro_torch.graph import bfs_distances, bfs_reachable
    idx = {"reach": [i for i, q in enumerate(queries) if isinstance(q, Reach)],
           "dist": [i for i, q in enumerate(queries) if isinstance(q, Dist)]}
    for kind, ids in idx.items():
        for i in ids[:n_check]:
            q, r = queries[i], results[i]
            if kind == "reach":
                want = bool(bfs_reachable(g, q.s)[q.t])
                if r.answer != want:
                    raise AssertionError(f"{q}: got {r.answer}, BFS {want}")
            else:
                d = int(bfs_distances(g, q.s)[q.t])
                dist = None if d < 0 else d
                want = dist is not None and (q.bound is None or dist <= q.bound)
                want_d = dist if want else None
                if (r.answer, r.distance) != (want, want_d):
                    raise AssertionError(f"{q}: got {(r.answer, r.distance)},"
                                         f" BFS {(want, want_d)}")
    return {k: min(len(v), n_check) for k, v in idx.items()}


def _int_mm_ms(A, want):
    """``torch._int_mm`` as a second yardstick for the or-and squaring:
    int8 copies of A zero-padded to multiples of 8 (its shape rule), B
    column-major (cuBLASLt's int8 layout), the int32 product thresholded
    at > 0.  Returns (ms, None), or (None, the reason) when it refuses;
    the result must equal ``want``."""
    import torch
    n = A.shape[0]
    n8 = -(-n // 8) * 8
    a8 = torch.zeros((n, n8), dtype=torch.int8, device=A.device)
    a8[:, :n] = A
    bt8 = torch.zeros((n8, n8), dtype=torch.int8, device=A.device)
    bt8[:n, :n] = A.T
    try:
        ms, got = cuda_timed(lambda: torch._int_mm(a8, bt8.T) > 0, 3)
    except RuntimeError as e:
        return None, "refused: " + str(e).splitlines()[0]
    _check_equal("torch._int_mm squaring", got[:, :n], want)
    return ms, None


def phase_main(out: dict):
    import torch
    import repro_torch
    from repro_torch import Dist, Reach
    from repro_torch.core.cache import _gather_boundary_matrix
    from repro_torch.core.fragments import fragment_graph
    from repro_torch.graph import erdos_renyi, random_partition
    from repro_torch.kernels.bitpack_ops import (bitpack_bool_matmul,
                                                 bitpack_matmul, pack_cols,
                                                 pack_rows)
    from repro_torch.kernels.bool_matmul import (kmajor, kmajor_copy,
                                                 or_and_matmul_nt,
                                                 or_and_matmul_ref)
    from repro_torch.kernels.tropical_matmul import (min_plus_matmul,
                                                     min_plus_matmul_ref)

    t0 = time.perf_counter()
    g = erdos_renyi(N_NODES, N_EDGES, n_labels=N_LABELS, seed=SEED)
    fr = fragment_graph(g, random_partition(g, N_FRAGS, seed=SEED), N_FRAGS)
    nb = fr.n_boundary
    print(f"main: n={g.n} m={g.m} k={fr.k} nb={nb} n_max={fr.n_max} "
          f"e_max={fr.e_max} s_max={fr.s_max} (host fragmentation "
          f"{time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(SEED)
    pairs = rng.integers(0, g.n, size=(2 * N_PER_KIND, 2))
    queries = [Reach(int(s), int(t)) for s, t in pairs[:N_PER_KIND]]
    queries += [Dist(int(s), int(t), bound=6 if i % 2 else None)
                for i, (s, t) in enumerate(pairs[N_PER_KIND:])]

    sess = repro_torch.connect(fr)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    sess.warm(with_dist=True)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    squarings = _launches()
    t0 = time.perf_counter()
    results = sess.run(queries)
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = _launches()
    for name in ("or_and_matmul", "min_plus_matmul"):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
    checked = _check_reach_dist(g, queries, results, N_CHECK)
    print(f"main: cache build (warm, reach + dist) {warm_ms:.1f} ms; "
          f"closure squarings or-and {squarings['or_and_matmul']}, "
          f"min-plus {squarings['min_plus_matmul']}")
    print(f"main: run of {len(queries)} mixed queries {run_ms:.1f} ms; "
          f"launches {launches}; checked against BFS {checked}")

    # warm per-query cost, one kind per run
    per_query_us = {}
    for kind, qs in (("reach", queries[:N_PER_KIND]),
                     ("dist", queries[N_PER_KIND:])):
        sess.run(qs)
        t0 = time.perf_counter()
        sess.run(qs)
        per_query_us[kind] = (time.perf_counter() - t0) * 1e6 / len(qs)
    print(f"main: warm per-query us {per_query_us}")

    # Each kernel against its plain version at the main path's shapes, on
    # real operands: the first squaring of each closure, of D0 | I and of
    # W0 with its zero diagonal (a later squaring of a closed matrix would
    # give back its input), and the compose of one batch, [256, nb] x
    # [nb, nb].  nb = 16039 = 62 * 256 + 167 = 125 * 128 + 39, so the last
    # row and column tiles are ragged.  The or-and kernel runs as the
    # closure and the compose call it: on K-major operands (the closure's
    # copy C^T), the squaring writing C and C^T.  The plain min-plus
    # squaring goes one [1, nb, nb] broadcast per row, so it is timed once,
    # without warm-up.
    cache = fr.rvset_cache
    C, Ct, Cd = cache.closure, cache.closure_t, cache.dist_closure
    eye = torch.eye(nb, dtype=torch.bool, device="cuda")
    A0 = _gather_boundary_matrix(fr, cache.bl_frontier, cache.part_b) | eye
    W0 = torch.where(eye, 0, _gather_boundary_matrix(fr, cache.bl_dist,
                                                     cache.part_b))
    del eye
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sb = torch.rand((N_PER_KIND, nb), device="cuda", generator=gen) < 0.01
    sbd = W0[torch.randint(0, nb, (N_PER_KIND,), device="cuda",
                           generator=gen)]
    # operand preparation on its own: the closure's one transposition of
    # D0 | I, a padded copy, and the compose's copy of a batch's sb
    prep_ms = {}
    prep_ms["transpose_a0"], A0t = cuda_timed(lambda: kmajor_copy(A0.T), 5)
    prep_ms["copy_a0"], A0k = cuda_timed(lambda: kmajor_copy(A0), 5)
    prep_ms["copy_sb"], _ = cuda_timed(lambda: kmajor(sb), 20)
    t_or_plain, want = cuda_timed(lambda: or_and_matmul_ref(A0, A0), 2)
    t_or_sq, (got, got_t) = cuda_timed(
        lambda: or_and_matmul_nt(A0k, A0t, with_transpose=True), 5)
    _check_equal("or_and squaring", got, want)
    _check_equal("or_and squaring C^T", got_t, want.T)
    err_or = _max_abs_err(got, want)
    del got_t
    t_or_sq_c, got = cuda_timed(lambda: or_and_matmul_nt(A0k, A0t), 5)
    _check_equal("or_and squaring, C only", got, want)
    # the former or-and route on the same A0 as a yardstick: pack both
    # operands into words, then the bit-packed kernel
    t_or_old, got = cuda_timed(lambda: bitpack_bool_matmul(A0, A0), 5)
    _check_equal("pack + bitpack_matmul squaring", got, want)
    ap, bp = pack_rows(A0), pack_cols(A0)
    t_or_old_b3, got = cuda_timed(lambda: bitpack_matmul(ap, bp, nb), 5)
    _check_equal("bitpack_matmul squaring on packed words", got, want)
    del ap, bp, A0k
    t_int_mm, int_mm_note = _int_mm_ms(A0, want)
    del got
    t_or_cp_plain, want = cuda_timed(lambda: or_and_matmul_ref(sb, C), 5)
    t_or_cp, got = cuda_timed(lambda: or_and_matmul_nt(sb, Ct), 20)
    _check_equal("or_and compose", got, want)
    err_or = max(err_or, _max_abs_err(got, want))
    del got, want
    Ch = A0.half()
    t_or_lib, _ = cuda_timed(lambda: (Ch @ Ch) > 0, 3)
    del Ch
    t_mp_plain, want = cuda_timed(lambda: min_plus_matmul_ref(W0, W0), 1,
                                  warmup=False)
    t_mp_sq, got = cuda_timed(lambda: min_plus_matmul(W0, W0), 2)
    _check_equal("min_plus squaring", got, want)
    err_mp = _max_abs_err(got, want)
    t_mp_cp_plain, want = cuda_timed(lambda: min_plus_matmul_ref(sbd, Cd), 1)
    t_mp_cp, got = cuda_timed(lambda: min_plus_matmul(sbd, Cd), 5)
    _check_equal("min_plus compose", got, want)
    err_mp = max(err_mp, _max_abs_err(got, want))
    del got, want
    print("main: both kernels bit-equal to their plain versions on the "
          "full squarings and composes")

    props = torch.cuda.get_device_properties(0)
    sm_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    dpx_nominal = props.multi_processor_count * 64 * sm_mhz * 1e6
    dpx_per_s = dpx_rate()
    print(f"dpx: measured {dpx_per_s:.4e} __viaddmin_s32/s over the card "
          f"(probe csrc/dpx_rate.cu); {props.multi_processor_count} SMs x 64 "
          f"lanes x {sm_mhz:.0f} MHz would give {dpx_nominal:.4e}")

    b_or, by_or = _bound(2 * nb ** 3, INT8_TENSOR_OPS_PER_S, 3 * nb * nb)
    b_or_cp, _ = _bound(2 * N_PER_KIND * nb * nb, INT8_TENSOR_OPS_PER_S,
                        nb * nb + 2 * N_PER_KIND * nb)
    b_mp, by_mp = _bound(nb ** 3, dpx_per_s, 3 * 4 * nb * nb)
    b_mp_cp, _ = _bound(N_PER_KIND * nb * nb, dpx_per_s,
                        4 * (nb * nb + 2 * N_PER_KIND * nb))
    print(f"time or_and_matmul: squaring [{nb}]^2 writing C and C^T "
          f"{t_or_sq:.3f} ms ({100 * b_or / t_or_sq:.1f} % of the bound "
          f"{b_or:.3f} ms, {by_or}), C only {t_or_sq_c:.3f} ms, plain "
          f"{t_or_plain:.3f} ms, cuBLAS fp16 {t_or_lib:.3f} ms, torch._int_mm "
          f"{int_mm_note if t_int_mm is None else f'{t_int_mm:.3f} ms'}; "
          f"old route (pack + bitpack_matmul) {t_or_old:.3f} ms, of which "
          f"bitpack_matmul {t_or_old_b3:.3f} ms; compose [{N_PER_KIND},{nb}]x"
          f"[{nb},{nb}] through C^T {t_or_cp:.3f} ms (bound {b_or_cp:.3f} ms),"
          f" plain {t_or_cp_plain:.3f} ms; operand preparation (ms) "
          f"{prep_ms}")
    print(f"time min_plus_matmul: squaring [{nb}]^2 {t_mp_sq:.3f} ms "
          f"(bound {b_mp:.3f} ms, {by_mp}, at the measured DPX rate), plain "
          f"{t_mp_plain:.3f} ms; compose [{N_PER_KIND},{nb}]x[{nb},{nb}] "
          f"{t_mp_cp:.3f} ms (bound {b_mp_cp:.3f} ms), plain "
          f"{t_mp_cp_plain:.3f} ms")
    out["kernels"] = [
        {"name": "or_and_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/bool_matmul/csrc/or_and_matmul.cu",
         "replaces": "src/repro/kernels/bool_matmul/bool_matmul.py:42",
         "launches": launches["or_and_matmul"], "max_abs_err": err_or,
         "ms": t_or_sq, "plain_ms": t_or_plain, "bound_ms": b_or,
         "bound_by": by_or, "library_ms": t_or_lib,
         "shape": f"[{nb},{nb}]x[{nb},{nb}], C and C^T",
         "c_only_ms": t_or_sq_c, "int_mm_ms": t_int_mm,
         "int_mm_note": int_mm_note, "old_route_ms": t_or_old,
         "old_route_bitpack_ms": t_or_old_b3, "prep_ms": prep_ms,
         "compose_ms": t_or_cp, "compose_plain_ms": t_or_cp_plain,
         "compose_bound_ms": b_or_cp,
         "squarings": squarings["or_and_matmul"],
         **out["build"]["or_and_matmul"]},
        {"name": "min_plus_matmul", "route": "cuda",
         "source": ("src/repro_torch/kernels/tropical_matmul/csrc/"
                    "min_plus_matmul.cu"),
         "replaces": "src/repro/kernels/tropical_matmul/tropical_matmul.py:51",
         "launches": launches["min_plus_matmul"], "max_abs_err": err_mp,
         "ms": t_mp_sq, "plain_ms": t_mp_plain, "bound_ms": b_mp,
         "bound_by": by_mp, "library_ms": None,
         "shape": f"[{nb},{nb}]x[{nb},{nb}]",
         "compose_ms": t_mp_cp, "compose_plain_ms": t_mp_cp_plain,
         "compose_bound_ms": b_mp_cp, "dpx_ops_per_s": dpx_per_s,
         "squarings": squarings["min_plus_matmul"]},
    ]
    out["main"] = {"warm_ms": warm_ms, "run_ms": run_ms,
                   "per_query_us": per_query_us, "nb": nb}
    return g, fr, queries, results


# ---------------------------------------------------------------------------
# 4. the sharded backend at full size, on a one-rank NCCL group
# ---------------------------------------------------------------------------

def _nccl_rank() -> None:
    """A one-rank NCCL process group on the card (d = 1), its store file
    under ``build/`` in the checkout."""
    import torch
    import torch.distributed as dist
    store = ROOT / "build" / "nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    print(f"sharded: NCCL {torch.cuda.nccl.version()}, "
          f"one rank on {torch.cuda.get_device_name(0)}")


class _PhaseClock:
    """The ``mark`` callback of the sharded batch programs: a CUDA event as
    each phase begins, so :meth:`ms` gives each phase's time."""

    def __init__(self):
        self.events = []

    def __call__(self, phase: str) -> None:
        import torch
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append((phase, event))

    def ms(self) -> dict:
        self.events[-1][1].synchronize()
        return {p: a.elapsed_time(b) for (p, a), (_, b)
                in zip(self.events, self.events[1:])}


def _sharded_split(fr, pairs, kind, qa=None, keep_wire=None) -> dict:
    """One fused sharded batch with the time of each phase (local stage,
    collective, closure, combine), outside any counted run.  With
    ``keep_wire`` (a dict) the merged payload words are kept there."""
    from repro_torch.core import distributed as D
    run, args = D._batch_sharded_program(fr, np.asarray(pairs), kind, qa=qa)
    clock = _PhaseClock()
    all_reduce = D._all_reduce
    if keep_wire is not None:
        def keep(x, op, group):
            keep_wire["wire"] = all_reduce(x, op, group)
            return keep_wire["wire"]
        D._all_reduce = keep
    try:
        run(*args, mark=clock)
    finally:
        D._all_reduce = all_reduce
    ms = clock.ms()
    ms["total"] = sum(ms.values())
    return ms


def _sharded_run(sess, fr, queries) -> dict:
    """One timed ``run`` of one kind through the sharded session after a
    warm-up, with every count set to 0 just before it and read just
    after; exactly one collective of ``traffic_bits`` bits must ride it."""
    import torch
    from repro_torch.core import distributed as D
    sess.run(queries)
    torch.cuda.synchronize()
    _reset_launches()
    D.collectives = D.payload_bits = 0
    t0 = time.perf_counter()
    results = sess.run(queries)
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = _launches()
    collectives, bits = D.collectives, D.payload_bits
    groups = sess.last_plan.groups
    want_bits = sum(fr.traffic_bits(
        gr.kind, states=1 if gr.automaton is None else gr.automaton.n_states,
        batch=gr.padded_size) for gr in groups)
    if collectives != len(groups) or bits != want_bits:
        raise AssertionError(f"{collectives} collectives of {bits} bits for "
                             f"{len(groups)} groups of {want_bits} bits")
    return {"results": results, "run_ms": run_ms, "launches": launches,
            "collectives": collectives, "payload_bits": bits}


def phase_sharded(out: dict, g, fr, queries, vmap_results) -> None:
    import torch
    import repro_torch
    from repro_torch.kernels.bitpack_ops import (bitpack_matmul,
                                                 bitpack_matmul_ref,
                                                 pack_cols, pack_rows,
                                                 unpack_rows)
    from repro_torch.kernels.bool_matmul import or_and_matmul

    sess = repro_torch.connect(fr, backend="shard_map")
    pl = sess.placement
    if (sess.backend, pl.d, pl.fpd) != ("shard_map", 1, fr.k):
        raise AssertionError(f"sharded session {sess.backend} d={pl.d} "
                             f"fpd={pl.fpd}")
    nb = fr.n_boundary
    kinds = {"reach": (slice(0, N_PER_KIND), "or_and_matmul"),
             "dist": (slice(N_PER_KIND, None), "min_plus_matmul")}
    report, launches = {}, {}
    for kind, (part, kernel) in kinds.items():
        qs = queries[part]
        r = _sharded_run(sess, fr, qs)
        if r["launches"][kernel] == 0:
            raise AssertionError(f"{kernel} never launched on the sharded "
                                 f"{kind} path")
        got = [(x.answer, x.distance) for x in r["results"]]
        if got != [(x.answer, x.distance) for x in vmap_results[part]]:
            raise AssertionError(f"sharded {kind} answers differ from the "
                                 "vmap session's")
        checked = _check_reach_dist(g, qs, r["results"], N_CHECK)
        launches[kind] = r["launches"]
        report[kind] = {k: r[k] for k in ("run_ms", "collectives",
                                           "payload_bits", "launches")}
        print(f"sharded: {kind} run of {len(qs)} {r['run_ms']:.1f} ms; "
              f"{r['collectives']} collective of {r['payload_bits']} bits "
              f"(traffic_bits); launches {r['launches']}; equal to the vmap "
              f"session, checked against BFS {checked}")

    # each batch again, its time split by phase; the reach batch keeps its
    # merged wire, whose first nb rows are D0 packed into words
    wire = {}
    for kind, (part, _) in kinds.items():
        pairs = [(q.s, q.t) for q in queries[part]]
        report[kind]["split_ms"] = _sharded_split(
            fr, pairs, kind, keep_wire=wire if kind == "reach" else None)
        print(f"sharded: {kind} batch split (ms) {report[kind]['split_ms']}")

    # the bit-packed kernel on the wire's operands: A = D0 | I
    words = wire.pop("wire")[:nb]
    A = unpack_rows(words, nb) | torch.eye(nb, dtype=torch.bool,
                                           device="cuda")
    ap, bp = pack_rows(A), pack_cols(A)
    n_launched = _launches()["bitpack_matmul"]
    t_b3, got = cuda_timed(lambda: bitpack_matmul(ap, bp, nb), 5)
    t_b3_plain, want = cuda_timed(lambda: bitpack_matmul_ref(ap, bp, nb), 2)
    _check_equal("bitpack squaring", got, want)
    err = _max_abs_err(got, want)
    _check_equal("bitpack vs or_and squaring", got, or_and_matmul(A, A))
    del got, want
    Ah = A.half()
    t_b3_lib, _ = cuda_timed(lambda: (Ah @ Ah) > 0, 3)
    del Ah
    n_launched = _launches()["bitpack_matmul"] - n_launched
    W = ap.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    int32_rate = sms * INT32_OPS_PER_CLOCK_PER_SM * sm_mhz * 1e6
    b_b3, by_b3 = _bound(nb * nb * W, int32_rate, 2 * 4 * nb * W + nb * nb)
    print(f"time bitpack_matmul: squaring [{nb},{W}]x[{W},{nb}] words "
          f"{t_b3:.3f} ms (bound {b_b3:.3f} ms, {by_b3}: {nb}^2 x {W} LOP3 "
          f"at {sms} SMs x {INT32_OPS_PER_CLOCK_PER_SM} x {sm_mhz:.0f} MHz), "
          f"plain {t_b3_plain:.3f} ms, cuBLAS fp16 {t_b3_lib:.3f} ms; "
          "bit-equal to its plain version and to or_and_matmul")
    out["kernels"].append(
        {"name": "bitpack_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/bitpack_ops/csrc/bitpack_matmul.cu",
         "replaces": "src/repro/kernels/bitpack_ops/bitpack_ops.py:74",
         "launches": launches["reach"]["bitpack_matmul"]
         + launches["dist"]["bitpack_matmul"],
         "max_abs_err": err, "ms": t_b3, "plain_ms": t_b3_plain,
         "bound_ms": b_b3, "bound_by": by_b3, "library_ms": t_b3_lib,
         "shape": f"[{nb},{W}]x[{W},{nb}] words",
         "wire_operand_launches": n_launched})
    for k in out["kernels"]:
        k["sharded_launches"] = {kind: launches[kind][k["name"]]
                                 for kind in kinds}
    out["sharded"] = report


# ---------------------------------------------------------------------------
# 5. regular path queries at reduced size
# ---------------------------------------------------------------------------

RPQ_NODES, RPQ_EDGES, RPQ_FRAGS = 2048, 8192, 8
RPQ_REGEXES = ["(0|1)* 2", "0* 1"]
N_RPQ = 64


def _rpq_oracle(g, s: int, t: int, qa) -> bool:
    """Product-graph BFS over (node, state), vectorized over the graph."""
    if s == t:
        return bool(qa.nullable)
    lq = qa.state_labels
    nodes = np.arange(g.n)
    match = ((lq[None, :] >= 0) & (g.labels[:, None] == lq[None, :])) \
        | (lq[None, :] == -3) \
        | ((lq[None, :] == -1) & (nodes[:, None] == s)) \
        | ((lq[None, :] == -2) & (nodes[:, None] == t))
    trans = qa.trans.astype(np.int64)
    seen = np.zeros((g.n, qa.n_states), dtype=bool)
    seen[s, 0] = True
    frontier = seen.copy()
    while frontier.any():
        adv = (frontier.astype(np.int64) @ trans) > 0          # [n, Q]
        nxt = np.zeros_like(seen)
        hit = adv[g.src]                                         # [m, Q]
        rows, qs = np.nonzero(hit)
        nxt[g.dst[rows], qs] = True
        nxt &= match
        if nxt[t, qa.final]:
            return True
        frontier = nxt & ~seen
        seen |= nxt
    return False


def phase_rpq(out: dict) -> None:
    import torch
    import repro_torch
    from repro_torch import Reach, Rpq
    from repro_torch.core.fragments import fragment_graph
    from repro_torch.graph import bfs_reachable, erdos_renyi, random_partition

    g = erdos_renyi(RPQ_NODES, RPQ_EDGES, n_labels=N_LABELS, seed=SEED)
    fr = fragment_graph(g, random_partition(g, RPQ_FRAGS, seed=SEED),
                        RPQ_FRAGS)
    print(f"rpq: REDUCED size n={g.n} m={g.m} k={fr.k} nb={fr.n_boundary}: "
          "the product closure has side nb*|Q|, a 6.4 GB matrix at the full "
          "size, and its squarings would outlast a smoke run")
    rng = np.random.default_rng(SEED + 1)
    pairs = rng.integers(0, g.n, size=(3 * N_RPQ, 2))
    queries = []
    for i, (s, t) in enumerate(pairs):
        s, t = int(s), int(t)
        if i % 3 == 2:
            queries.append(Reach(s, t))
        else:
            queries.append(Rpq(s, t, regex=RPQ_REGEXES[i % 3]))
    sess = repro_torch.connect(fr)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    results = sess.run(queries)
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = _launches()
    if launches["or_and_matmul"] == 0:
        raise AssertionError("or_and_matmul never launched on the RPQ path")
    t0 = time.perf_counter()
    sess.run(queries)
    warm_ms = (time.perf_counter() - t0) * 1e3
    n_checked = 0
    want = {}
    for i, (q, r) in enumerate(zip(queries, results)):
        if isinstance(q, Rpq):
            want[i] = _rpq_oracle(g, q.s, q.t, sess._resolve_automaton(q))
        else:
            want[i] = bool(bfs_reachable(g, q.s)[q.t])
        if r.answer != want[i]:
            raise AssertionError(f"{q}: got {r.answer}, oracle {want[i]}")
        n_checked += 1
    n_rpq = sum(isinstance(q, Rpq) for q in queries)
    sides = {rx: fr.n_boundary * sess._resolve_automaton(
        Rpq(0, 0, regex=rx)).n_states for rx in RPQ_REGEXES}
    print(f"rpq: product closure sides {sides}; first run (builds caches) "
          f"{cold_ms:.1f} ms, warm run {warm_ms:.1f} ms "
          f"({warm_ms * 1e3 / len(queries):.1f} us/query, {n_rpq} Rpq); "
          f"launches {launches}; {n_checked} answers match the oracles")
    out["rpq"] = {"cold_ms": cold_ms, "warm_ms": warm_ms,
                  "launches": launches, "sides": sides}

    # the same Rpq queries through the sharded backend (d = 1, fpd = 8):
    # one collective per automaton group
    rpq_ids = [i for i, q in enumerate(queries) if isinstance(q, Rpq)]
    sharded = repro_torch.connect(fr, backend="shard_map")
    r = _sharded_run(sharded, fr, [queries[i] for i in rpq_ids])
    if r["launches"]["or_and_matmul"] == 0:
        raise AssertionError("or_and_matmul never launched on the sharded "
                             "RPQ path")
    for i, res in zip(rpq_ids, r["results"]):
        if res.answer != want[i]:
            raise AssertionError(f"sharded {queries[i]}: got {res.answer}, "
                                 f"oracle {want[i]}")
    qa = sharded._resolve_automaton(queries[rpq_ids[0]])
    pairs = [(queries[i].s, queries[i].t) for i in rpq_ids
             if queries[i].regex == queries[rpq_ids[0]].regex]
    split = _sharded_split(fr, pairs, "rpq", qa=qa)
    print(f"rpq: sharded run of {len(rpq_ids)} Rpq (fpd "
          f"{sharded.placement.fpd}) {r['run_ms']:.1f} ms; "
          f"{r['collectives']} collectives of {r['payload_bits']} bits for "
          f"{sharded.last_plan.n_groups} groups (traffic_bits); launches "
          f"{r['launches']}; {len(rpq_ids)} answers match the oracle; "
          f"{qa.n_states}-state batch of {len(pairs)} split (ms) {split}")
    out["rpq"]["sharded"] = {k: r[k] for k in ("run_ms", "collectives",
                                               "payload_bits", "launches")}
    out["rpq"]["sharded"]["split_ms"] = split


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    _require_repo()
    import torch.distributed as dist
    out: dict = {}
    out.update(phase_build())
    phase_parity()
    g, fr, queries, results = phase_main(out)
    _nccl_rank()
    try:
        phase_sharded(out, g, fr, queries, results)
        del g, fr, queries, results
        phase_rpq(out)
    finally:
        dist.destroy_process_group()
    kernels = out["kernels"]
    for k in kernels:
        k["rpq_launches"] = out["rpq"]["launches"][k["name"]]
        k["rpq_sharded_launches"] = out["rpq"]["sharded"]["launches"][k["name"]]
    print(out["card"])            # nvidia-smi: name, power.limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
