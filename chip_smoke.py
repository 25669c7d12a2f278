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
             by the same launch; the min-plus kernel also on both of its
             routes (skinny split-K up to 64 rows, tiles above) with and
             without a floor (``init=``), twice each; the bit-packed
             product also against the or-and kernel, with K = 31, 32, 33
             and words whose bit 31 is set; evalDG's or-and fixpoint
             kernel (``or_and_fixpoint``, ``csrc/or_and_skinny.cu``), x
             and the steps, on random D at B = 2, 300 and 1037, an empty
             source, a source that covers every column, a row of D all
             true, a D not in padded storage (one counted copy) and a
             1024-node chain;
             the or-and floor-pair kernel (``or_and_floor_pair(a, b_t,
             F, Ft)``) on ragged shapes with random, all-zero and all-one
             floors: pads zero, floors unchanged.
3. main    — the query path at full size: an Erdos-Renyi graph of 16384
             nodes and 65536 edges over 8 labels, randomly cut into 16
             fragments; ``repro_torch.connect(fr)``, ``warm(with_dist=True)``,
             then one ``run`` of 256 Reach + 256 Dist (half bounded at 6).
             Every answer is checked against a host BFS (scipy), both
             kernels must have launched during the run, and the min-plus
             wrapper must have copied no operand (its operands live in
             16-byte-pitched storage).  The kernels
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
5. oneshot — the paper's one-shot algorithms on the same graph,
             ``connect(fr, cache="none")``: 16 Reach and 16 Dist (8 bounded)
             checked against the host BFS and 4 Rpq ``(0|1)* 2`` (D is a
             6.4 GB matrix) against a product-graph BFS, each evalDG one
             launch (``or_and_fixpoint`` for reach, ``min_plus_settle``
             for dist) with no per-step
             product and no copy of D or W (``copies`` 0), each Reach and
             Dist one launch of the localEval kernel
             (``csrc/local_eval.cu``, which writes D or W in place); one
             query of each kind split into local stage and
             evalDG (its steps as the kernel counts them); both entries of
             the localEval kernel held byte for byte, pads included,
             against their plain version on one query's inputs (D, W
             exact and capped at 6), one launch a call and no host sync,
             and timed beside it and the bytes they must move;
             ``dis_reach_sharded`` and ``dis_rpq_sharded`` on the NCCL
             group, one collective of ``traffic_bits`` bits each, one
             fixpoint launch each, no copy; the min-plus product held
             against its plain version at evalDG's vector-matrix shape,
             M = 1; the or-and fixpoint kernel on the split reach query,
             against its plain version and timed beside the bytes it
             reads (each step's new rows), the empty step of the
             grid-barrier probe and the engine's evalDG; and the settle
             kernel on the split dist query,
             unbounded and with bound 6, its state [answer, levels, rows]
             equal to its plain version's, timed with the engine's evalDG
             beside the bytes of the rows it read.
6. dynamic — graph deltas at full size through ``session.apply`` on a warm
             amortized session (reserves 64 boundary slots, 256 edges and
             64 stubs): a stream that reaches repair, repair with new
             boundary nodes, recompute (wide inserts, then deletions) and
             rebuild, each delta followed by 256 queries checked against
             the host BFS on the updated graph and a freshly built
             session; one delta made to fail inside the repair must roll
             back with versions, tensors and answers unchanged.  A
             repair makes 3 B1 layout copies and one floor-pair launch.
             Both kernels are held against their plain versions at the
             rank update's shapes, on the operands the repair gave them;
             the last or-and product with its floor pair also beside the
             old composition (P and P^T, then two OR passes) and cuBLAS.
7. serve   — ``repro_torch.QueryServer`` on the dynamic phase's warm
             session (nb = 16103 with reserves, reach + dist cache): a
             deterministic barrier flush (``start=False``) of 1024 mixed
             reach / dist / bounded requests with 2 repair deltas between
             them; two threaded MVCC runs (``mvcc=True, versions=4``)
             where a client thread submits 2048 requests, as a burst and
             paced (one batch in flight), while 3 repairs and 1
             recompute commit as versions; every answer is checked
             against the host BFS on the graph of the version its
             ``cache_version`` names; both kernels launched in both modes,
             no operand copied, no retry, dead letter or degraded group.
             Prints qps, p50/p95/p99 per route, batch occupancy, the MVCC
             gauges, the device memory peak, and the p99 of reads that
             overlapped a repair beside the others'; a probe times one
             batch alone and beside a thread that squares the distance
             closure on the default stream, then on a side stream.  Then
             chaos on the card: transient ``engine.vmap`` faults retried,
             a poison pair dead-lettered alone, a failed MVCC repair
             dropped, and an ``engine.shard_map`` failure on the NCCL group
             degraded to the cached path, exact.
8. baselines — the paper's baselines on the main graph: 16 seeded pairs
             through ``dis_reach_n``, ``dis_reach_m`` and the one-shot
             ``dis_reach``, each answer checked against the host BFS, with
             rounds, site visits and traffic bits, each one-shot evalDG
             one fixpoint launch; then a 1024-node chain dealt round-robin
             over 16 fragments, where ``dis_reach_m`` must take more than
             k rounds and ``dis_reach`` one, whose fixpoint (about 1000
             steps) is timed alone.
9. mapreduce — the one-shot phase's 4 RPQs through ``mr_drpq``: answers
             equal to the one-shot RPQ's and the product-graph BFS, each
             reducer's evalDG one fixpoint launch with no copy, the
             device memory peak below 12 GB (the reference stacks 103 GB
             of mapper outputs), the time split into map and evalDG; and
             the reducer's fixpoint kernel, [1, 80205] x [80205, 80205] on
             D as stored, timed against the rows it reads.
10. sharded repair — ``session.apply`` on a ``backend="shard_map"``
             session over the NCCL group with a reach-only cache and the
             dynamic phase's reserves: inserts in one fragment, cross
             inserts with new boundary nodes, inserts in a fragment that
             owns no boundary row (a second partition of the graph), 16
             deletions, a fault at ``delta.repair`` (rolled back), and a
             delta with a distance cache; each in the mode the reference
             takes, with one collective of ``traffic_bits_update(r)``
             bits per sharded repair (none otherwise), no operand copied,
             the cache bit-equal to the host repair of the same delta on
             a copy-on-write clone, and 256 reach queries after it
             checked through the sharded batch and the cached path; the
             floor-pair product timed at the sharded rank update's K.
11. verify — ``repro_torch.analysis.verify_session`` on that session:
             the three batch programs, the one-shot disReach and the cache
             update, one collective each of its wire model's bits, no
             violation.
12. rpq     — regular path queries at a reduced size (2048 nodes, 8
             fragments), through the vmap session and then the sharded
             one: the product closure has side nb * |Q|, which at full size
             is a 6.4 GB matrix whose squaring would outlast a smoke run.
             Answers are checked against a host product-graph BFS.

13. lm_serve — the LM family (no query kernel): qwen2-1.5b at full width
             and depth (28 layers, d 1536, vocab 151936; 1.544e9
             parameters) from a seeded generator on the card.  In f32:
             decode_step over 32 tokens, and prefill of 24 then
             decode_step, against forward (logits within 2e-3), and
             ServeEngine's greedy tokens against forward's argmax over the
             same padded sequence (a token may differ only at a tie within
             2e-3).  In bf16: ServeEngine(batch=8, max_len=256) on 8
             seeded requests (prompts of 8-64 tokens, 32 new tokens),
             timed (prefill by stepping, decode ms per step and tokens/s
             beside the weight-bytes bound, memory peak, and the device's
             busy time and idle share from a profiler trace); again with
             the int8 KV cache chunked by 64 (the same prompts, 8 new
             tokens), whose tokens and cache dtype are printed.
14. lm_moe  — olmoe-1b-7b at full width and depth (64 experts, top 8): in
             f32 with a capacity that drops nothing, decode_step against
             forward; in bf16 at its own capacity factor 1.25, ServeEngine
             timed as above, with the dropped (token, choice) pairs.
15. lm_train — qwen2-1.5b at full width: Trainer.step on TokenStream
             batches of 4 x 512 tokens, two microbatches, remat, AdamW
             (one warm-up step, then 4 timed; finite losses; memory peak);
             one step with int8 gradient compression; and Trainer.run at
             the smoke configuration with a failure injected at step 7,
             bit-equal to a clean run under
             torch.use_deterministic_algorithms(True), in a child process
             started with CUBLAS_WORKSPACE_CONFIG=:4096:8.
             The three LM phases must launch none of the query kernels
             (``lm_launches``).
16. gnn_molecule — NequIP (plain and ``fused_agg``, bf16), MACE and EGNN at
             their full configurations on the molecule shape at full size:
             128 molecules of 30 atoms drawn in a box, each with its 64
             shortest directed pairs as edges, padded to N = 4096 and
             E = 8192.  For each: ``energy_and_forces`` timed (ms a call,
             device busy ms, idle share, memory peak), held against the
             same call on the CPU (the bf16 path: against the f32 path on
             the card), and under a seeded rotation and shift (energies
             invariant, forces rotated): f32 within 1e-4 of the values'
             scale, bf16 within 0.1 of it (0.2 under the rotation, two
             bf16 evaluations); then Trainer steps on the molecule
             cell's loss (energy + 0.1 x force MSE, whose gradient
             differentiates the forces again), timed and traced.
17. gnn_gat — gat-cora at full width: on a Cora-sized random graph (2708
             nodes, 10556 edges, 1433 features), forward held against the
             CPU and timed, then Trainer steps on ``gat.loss``; on a
             Reddit-sized Erdos-Renyi graph (232965 nodes, 114.6 M edges,
             CSR sorted on the card), 1024 seeds from GraphEpochStream
             sampled 15-10 by ``sample_subgraph_host`` (host ms printed;
             every sampled pair checked to be an edge), padded, features
             gathered from a [232965, 602] table, and one timed training
             step on the seeds' loss.
18. recsys — bert4rec at its full configuration (1 M items, d 64, 2 blocks,
             2 heads, seq 200): serve_p99 (``score_next`` at batch 512, p50
             and p99, held against the CPU on 8 rows), retrieval_cand
             (``score_candidates`` against 1 M candidates, held against
             ``score_next``'s columns), serve_bulk (``score_topk``, k 100,
             chunk 4096, over as many of the cell's 262144 rows as fit in
             ~20 s; the first chunk held against ``torch.topk`` of
             ``score_next``) and train_batch (65536 sequences, 20 masks,
             8192 shared negatives, as 8 microbatches of 8192 through
             ``Trainer(grad_accum=8)``), each with rows/s, device busy ms,
             idle share and memory peak.  The three phases run in f32
             (TF32 off) and must launch none of the query kernels
             (``gnn_launches``, ``recsys_launches``).
19. cells  — the cell programs (``repro_torch.configs.all_cells()``): the
             36 runnable cells and the three optimized builds at
             ``reduced=True``, one step each on the card held against the
             same step on the CPU; the reduced qwen2-1.5b train_4k cell
             placed by its arg_specs (``reshard``) on a one-rank NCCL
             mesh and run through DTensor, equal to the plain run; every
             cell that fits one card at full width on real inputs (see
             ``LM_FULL_CELLS``, ``GNN_FULL_SHAPES``, ``RECSYS_FULL_SHAPES``;
             minibatch_lg where its reckoned peak stays under 70 GB): the
             model function called directly, the first step against it
             (traced: device busy and idle share; FLOPs counted by
             FlopCounterMode beside the cell's model_flops at the dims
             that ran), then three timed steps (median) with their memory
             peak, every cut printed; the dry run of all 40 cells on both
             production meshes.  It launches none of the query kernels
             (``cells_launches``).
20. examples — ``examples/quickstart_torch.py`` (the paper's Fig. 1
             graph, one mixed Reach / Dist / Rpq batch) and
             ``examples/distributed_queries_torch.py`` (sharded
             partial evaluation against the baselines, a warm mixed
             batch, the ``shard_map`` backend and 32 fragments packed on
             a one-rank NCCL group), imported and run on the card as a
             user runs them, each asserting its own answers; the or-and
             and min-plus kernels must launch in each
             (``examples_launches``).
21. dryrun — the compiled dry run (``python -m
             repro_torch.launch.dryrun``) of qwen2-1.5b train_4k, gat-cora
             full_graph_sm, and qwen1.5-32b decode_32k and bert4rec
             train_batch (two cells too large for one card) on the
             single-pod 16x16 mesh of a 256-rank fake process group, with
             its cost probes, under this machine's torch: one CPU process
             each, CUDA hidden, started before the first phase and read
             here.  Each record must be ok with every compiled field
             (temporaries, eager FLOPs and bytes, collectives, probes)
             and is printed on a line.

The min-plus wrapper's operand copies are asserted 0 on the main,
one-shot, dynamic and serve paths as well; the or-and wrapper's copies
(``or_and_copies``) on the one-shot, baselines and MapReduce paths and the
sharded one-shot functions, where ``or_and_fixpoint`` and
``min_plus_settle`` run evalDG.  When the source of an earlier
min-plus kernel is put at ``build/former/min_plus_matmul.cu``, it is
built in the build phase and timed beside the current kernel at every
min-plus shape (``former_ms``).

The second-to-last line of output is a JSON object with one entry per
kernel, with its launches on each path (``launches`` on the main path,
``oneshot_launches``, ``dynamic_launches`` by mode, ``serve_launches``
by mode, ``baselines_launches``, ``mapreduce_launches``,
``sharded_repair_launches`` by mode, ``verify_launches``,
``lm_launches`` by LM phase, ``gnn_launches`` by GNN phase,
``recsys_launches``, ``cells_launches``, ...) and its new
launch shapes (``new_shapes``); the last is ``{"ok": true, "device":
{...}}``.  Times come from
CUDA events after a warm-up; bounds are reckoned from the H100 SXM data
sheet (3.35 TB/s, 1979 TOPS int8, 64 int32 operations per clock per SM
at the card's maximum SM clock) and, for the SIMT min-plus, from the DPX
rate that the probe ``csrc/dpx_rate.cu`` measures in the same run.
"""
from __future__ import annotations

import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12          # H100 SXM data sheet, dense
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


def graph_timed(fn, reps: int = 50) -> float:
    """Milliseconds per call of ``fn`` replayed from a CUDA graph: the
    device's time for its launches without the host's per-call overhead
    (Python, ctypes, the launch itself), which bounds a call that takes
    tens of microseconds on the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


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


# An earlier version of the min-plus kernel, timed beside the current one at
# every shape when its source is put here (the directory is not part of the
# checkout; nothing in the package calls it).  Its C entry point is
# min_plus_matmul(a, b, c, M, K, N, sa0, sa1, sb0, sb1, ldc, stream).
FORMER_MIN_PLUS = ROOT / "build" / "former" / "min_plus_matmul.cu"


def _start_former_build():
    """Start nvcc on the former min-plus source, if there is one; returns
    the process (or None) and the library path."""
    from repro_torch.kernels import _build
    if not FORMER_MIN_PLUS.is_file():
        return None, None
    lib = FORMER_MIN_PLUS.with_suffix(".so")
    return subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
         str(FORMER_MIN_PLUS)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), lib


_former = None


def former_min_plus(a, b, init=None):
    """The former kernel on the same operands, through the steps of the
    wrapper that called it (its checks, the device context, the stream
    object), so that a launch-bound shape is timed as that path paid for
    it; a floor is folded in by one ``torch.minimum`` pass, as the paths
    did before the kernel took it.  Returns None when no former source was
    built."""
    import torch
    if _former is None:
        return None
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("former min_plus_matmul takes int32 tensors")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("former min_plus_matmul shapes do not chain")
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError("former min_plus_matmul runs on one CUDA device")
    lib, fn = _former
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    ints = (M, K, N, *a.stride(), *b.stride(), out.stride(0))
    if max(ints) >= 2 ** 31:
        raise ValueError("sizes and strides must fit in int32")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), *ints, stream)
    if code:
        raise RuntimeError(f"former min_plus_matmul launch failed: {code}")
    return out if init is None else torch.minimum(out, init)


def _load_former(proc, lib) -> None:
    import ctypes
    global _former
    if proc is None:
        print("former min-plus kernel: no source at "
              f"{FORMER_MIN_PLUS.relative_to(ROOT)}; not timed")
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"former min-plus kernel build failed:\n{out}")
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.min_plus_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _former = (cdll, fn)
    print(f"former min-plus kernel built from "
          f"{FORMER_MIN_PLUS.relative_to(ROOT)}; timed beside the current one")


def _time_former(name, want, a, b, init=None, reps=5):
    """ms of the former kernel computing ``want`` (checked), or None."""
    if _former is None:
        return None
    ms, got = cuda_timed(lambda: former_min_plus(a, b, init), reps)
    _check_equal(f"former {name}", got, want)
    return ms


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
    from repro_torch.kernels.local_eval import ops as lops
    from repro_torch.kernels.tropical_matmul import ops as tops
    return {"or_and_matmul": bops, "min_plus_matmul": tops,
            "bitpack_matmul": pops, "local_eval": lops}


def _reset_launches():
    """Set every kernel's launch count (the or-and floor pair's and
    fixpoint's and the settle kernel's too), and both wrappers' operand
    copy counts, to 0."""
    for ops in _counted().values():
        ops.launches = 0
    tops = _counted()["min_plus_matmul"]
    tops.copies = tops.settle_launches = tops.settle_list_launches = 0
    _counted()["local_eval"].list_launches = 0
    bops = _counted()["or_and_matmul"]
    bops.copies = bops.fixpoint_launches = bops.floor_launches = 0


def _copies() -> int:
    """Operand copies the min-plus wrapper made since the last reset: the
    paths hand it padded operands, so a run of them must make none."""
    return _counted()["min_plus_matmul"].copies


def _assert_no_copies(what: str) -> None:
    if _copies():
        raise AssertionError(f"{what}: the min-plus wrapper copied "
                             f"{_copies()} operands into padded storage")


def _assert_no_b1_copies(what: str) -> None:
    """The or-and wrapper made no K-major copy: evalDG reads D as the
    paths store it (the fixpoint), so a one-shot path makes none."""
    n = _counted()["or_and_matmul"].copies
    if n:
        raise AssertionError(f"{what}: the or-and wrapper made {n} K-major "
                             "copies")


def _launches():
    """Launches by kernel since the last reset: ``or_and_floor`` counts the
    or-and floor-pair kernel apart (its launches are in ``or_and_matmul``
    too), ``or_and_fixpoint``, ``min_plus_settle`` and
    ``min_plus_settle_lists`` evalDG's kernels for reach and dist (in
    neither product's count), ``local_eval_lists`` the localEval launches
    that wrote W's row lists (in ``local_eval`` too), and
    ``or_and_copies`` the or-and wrapper's K-major and row copies."""
    counts = {name: ops.launches for name, ops in _counted().items()}
    bops = _counted()["or_and_matmul"]
    tops = _counted()["min_plus_matmul"]
    counts["or_and_floor"] = bops.floor_launches
    counts["or_and_fixpoint"] = bops.fixpoint_launches
    counts["min_plus_settle"] = tops.settle_launches
    counts["min_plus_settle_lists"] = tops.settle_list_launches
    counts["local_eval_lists"] = _counted()["local_eval"].list_launches
    counts["or_and_copies"] = bops.copies
    return counts


class _EvalDGCalls:
    """``with _EvalDGCalls() as calls:`` counts the calls of
    ``engine.evaldg_reach`` and ``engine.evaldg_dist`` (``calls.reach``,
    ``calls.dist``), through which every path runs evalDG."""

    def __enter__(self):
        from repro_torch.core import engine
        self.reach = self.dist = 0
        self._orig = (engine.evaldg_reach, engine.evaldg_dist)

        def reach(*args):
            self.reach += 1
            return self._orig[0](*args)

        def dist_(*args, **kw):
            self.dist += 1
            return self._orig[1](*args, **kw)

        engine.evaldg_reach, engine.evaldg_dist = reach, dist_
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine
        engine.evaldg_reach, engine.evaldg_dist = self._orig
        return False


def _assert_one_fixpoint_each(what: str, launches: dict, calls,
                              local: int) -> None:
    """Each evalDG of a path was one launch, ``or_and_fixpoint`` for reach
    and ``min_plus_settle_lists`` (or, on the dense route,
    ``min_plus_settle``) for dist, with no per-step product launched and
    no operand copied (either wrapper), and the path made ``local``
    launches of the localEval kernel: one for each one-shot Reach or Dist
    it evaluated."""
    if launches["local_eval"] != local:
        raise AssertionError(f"{what}: {launches['local_eval']} localEval "
                             f"launches, expected {local}")
    got = (launches["or_and_fixpoint"],
           launches["min_plus_settle"] + launches["min_plus_settle_lists"])
    if got != (calls.reach, calls.dist) or calls.reach + calls.dist == 0:
        raise AssertionError(f"{what}: {calls.reach} reach and {calls.dist} "
                             f"dist evalDGs made (or-and fixpoint, settle) "
                             f"launches {got}")
    if any(launches[k] for k in ("or_and_matmul", "min_plus_matmul",
                                 "bitpack_matmul")):
        raise AssertionError(f"{what}: evalDG launched per-step products: "
                             f"{launches}")
    _assert_no_copies(what)
    _assert_no_b1_copies(what)


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
    former = _start_former_build()
    paths = _build.build()
    _load_former(*former)
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
    n += _parity_or_and_floor(dev)
    n += _parity_min_plus_routes(dev)
    n += _parity_fixpoints(dev)
    n += _parity_bitpack(dev)
    print(f"parity: {n} kernel calls bit-equal to their plain versions")


# the floor-pair kernel: M and N ragged around its 128 x 128 tiles, K
# around its 64-byte slice and 128-byte stages (0 included)
OR_AND_FLOOR = [(1, 1, 1), (127, 64, 129), (129, 65, 127), (1037, 128, 300),
                (300, 129, 1037), (130, 0, 17), (4113, 1024, 257)]


def _parity_or_and_floor(dev) -> int:
    """The floor pair, ``or_and_floor_pair(a, b_t, F, Ft)``, with floors
    random, all zero and all one, whose pad bytes are set (the kernel must
    not read them) and with Ft drawn apart from F (each output takes its
    own floor): bit-equal to the plain version, both outputs' pads zero,
    both floors unchanged, one launch of the floor-pair kernel a call."""
    import torch
    from repro_torch.kernels.bool_matmul import (or_and_floor_pair,
                                                 or_and_floor_pair_ref, pitch)
    from repro_torch.kernels.bool_matmul import ops as bops
    n = 0
    for si, (m, k, n_) in enumerate(OR_AND_FLOOR):
        rng = np.random.default_rng([SEED, si, 17])
        a = torch.tensor(rng.random((m, k)) < 0.05, device=dev)
        b_t = torch.tensor(rng.random((n_, k)) < 0.05, device=dev)
        for kind in ("random", "zero", "one"):
            floors = []
            for rows, cols in ((m, n_), (n_, m)):
                x = (rng.random((rows, cols)) < 0.1 if kind == "random"
                     else np.full((rows, cols), kind == "one"))
                buf = torch.ones((rows, pitch(cols)), dtype=torch.bool,
                                 device=dev)
                floors.append(buf[:, :cols].copy_(torch.tensor(x,
                                                               device=dev)))
            F, Ft = floors
            held = [_padded_storage(x).clone() for x in floors]
            before = (bops.launches, bops.floor_launches)
            c, ct = or_and_floor_pair(a, b_t, F, Ft)
            if (bops.launches - before[0],
                    bops.floor_launches - before[1]) != (1, 1):
                raise AssertionError(f"or_and floor {m}x{k}x{n_}: not one "
                                     "floor-pair launch")
            want, want_t = or_and_floor_pair_ref(a, b_t, F, Ft)
            what = f"or_and floor {m}x{k}x{n_} {kind}"
            _check_equal(what, c, want)
            _check_equal(what + " C^T", ct, want_t)
            if (_padded_storage(c)[:, n_:].any()
                    or _padded_storage(ct)[:, m:].any()):
                raise AssertionError(f"{what}: pad bytes set")
            if not all(torch.equal(_padded_storage(x), h)
                       for x, h in zip(floors, held)):
                raise AssertionError(f"{what}: a floor changed")
            n += 1
    return n


def _padded_storage(x):
    """The [rows, pitch] storage behind a padded view."""
    return x.as_strided((x.shape[0], x.stride(0)), (x.stride(0), 1))


# evalDG's or-and fixpoint kernel: random D at these B, a chain of
# CHAIN_NODES nodes (one step a hop)
FIXPOINT_B = (2, 300, 1037)


def _fixpoint_cases(dev):
    """(name, x0, D, copies): the parity cases of the or-and fixpoint, with
    the operand copies the wrapper must make (1 for a D that is not in
    padded storage, else 0)."""
    import torch
    from repro_torch.kernels.bool_matmul import padded_zeros

    def case(name, x0, D, padded=True):
        B = len(x0)
        if padded:
            Dt = padded_zeros(B, B, dev).copy_(torch.tensor(D, device=dev))
        else:
            Dt = torch.tensor(D, device=dev)
        return (name, torch.tensor(x0, device=dev), Dt, 0 if padded else 1)

    cases = []
    for B in FIXPOINT_B:
        rng = np.random.default_rng([SEED, B, 17])
        D = rng.random((B, B)) < 2.5 / B
        one = np.zeros(B, dtype=bool)
        one[rng.integers(B)] = True
        cases.append(case(f"random B={B}", one, D))
        cases.append(case(f"empty source B={B}", np.zeros(B, dtype=bool),
                          D))
        cases.append(case(f"covering source B={B}", np.ones(B, dtype=bool),
                          D))
        full = D.copy()
        full[rng.integers(B)] = True                  # a row all true
        cases.append(case(f"full row B={B}", one, full))
    B = 1037                       # 16 does not divide it: copied
    rng = np.random.default_rng([SEED, B, 18])
    one = np.zeros(B, dtype=bool)
    one[3] = True
    cases.append(case("unaligned D", one, rng.random((B, B)) < 2.5 / B,
                      padded=False))
    B = CHAIN_NODES
    chain = np.zeros((B, B), dtype=bool)
    chain[np.arange(B - 1), np.arange(1, B)] = True
    head = np.zeros(B, dtype=bool)
    head[0] = True
    cases.append(case(f"chain of {B}", head, chain))
    return cases


def _parity_fixpoints(dev) -> int:
    """or_and_fixpoint on every case of :func:`_fixpoint_cases`: x and the
    steps bit-equal to the plain version, one fixpoint launch a call and
    the copies counted."""
    from repro_torch.kernels.bool_matmul import (or_and_fixpoint,
                                                 or_and_fixpoint_ref)
    from repro_torch.kernels.bool_matmul import ops as bops
    n = 0
    for name, x0, D, copies in _fixpoint_cases(dev):
        before = (bops.fixpoint_launches, bops.launches, bops.copies)
        got, steps = or_and_fixpoint(x0, D)
        if (bops.fixpoint_launches - before[0], bops.launches - before[1],
                bops.copies - before[2]) != (1, 0, copies):
            raise AssertionError(f"or_and_fixpoint {name}: not one fixpoint "
                                 f"launch with {copies} copies")
        want, want_steps = or_and_fixpoint_ref(x0, D)
        _check_equal(f"or_and_fixpoint {name}", got, want)
        _check_equal(f"or_and_fixpoint {name} steps", steps, want_steps)
        n += 1
    return n


# min-plus shapes on both routes with K split over many blocks (skinny) and
# ragged tiles, each with and without a floor
MIN_PLUS_ROUTES = [(1, 20011, 3001), (2, 4099, 1037), (33, 1000, 517),
                   (64, 4099, 1037), (65, 1000, 517), (300, 1000, 261)]


def _parity_min_plus_routes(dev) -> int:
    import torch
    from repro_torch.kernels.tropical_matmul import (INF, min_plus_matmul,
                                                     min_plus_matmul_ref)
    from repro_torch.kernels.tropical_matmul import ops as tops
    n = 0
    for si, (m, k, n_) in enumerate(MIN_PLUS_ROUTES):
        rng = np.random.default_rng([SEED, si, 11])
        a = rng.integers(0, 1000, (m, k)).astype(np.int32)
        b = rng.integers(0, 1000, (k, n_)).astype(np.int32)
        f = rng.integers(0, 3000, (m, n_)).astype(np.int32)
        a[rng.random((m, k)) < 0.5] = INF
        b[rng.random((k, n_)) < 0.5] = INF
        f[rng.random((m, n_)) < 0.5] = INF
        a, b, f = (tops.padded_i32(*x.shape, dev).copy_(
            torch.tensor(x, device=dev)) for x in (a, b, f))
        route = tops._card_route(dev.index or 0, m, k, n_)
        for floor in (None, f):
            got = min_plus_matmul(a, b, init=floor)
            _check_equal(f"min_plus {route.kind} {m}x{k}x{n_} "
                         f"split {route.split} floor {floor is not None}",
                         got, min_plus_matmul_ref(a, b, floor))
            again = min_plus_matmul(a, b, init=floor)
            _check_equal(f"min_plus {route.kind} {m}x{k}x{n_} twice", again,
                         got)
            n += 2
    return n


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
N_PER_KIND = 256


def _bfs_distances(g, sources) -> dict:
    """Host BFS from every distinct source at once (scipy's csgraph, unit
    weights): {s: [n] int64 hop distances, -1 where unreachable}."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    adj = csr_matrix((np.ones(g.m, dtype=np.float32), (g.src, g.dst)),
                     shape=(g.n, g.n))
    srcs = np.unique(np.asarray(sources, dtype=np.int64))
    d = shortest_path(adj, method="D", unweighted=True, indices=srcs)
    d = np.where(np.isinf(d), -1, d).astype(np.int64)
    return dict(zip(srcs.tolist(), d))


def _check_reach_dist(g, queries, results, what: str = "main") -> dict:
    """Every Reach / Dist answer (and distance) against the host BFS;
    returns the number checked per kind."""
    from repro_torch import Reach
    table = _bfs_distances(g, [q.s for q in queries])
    for q, r in zip(queries, results):
        d = int(table[q.s][q.t])
        if isinstance(q, Reach):
            want = (d >= 0, None) if q.s != q.t else (True, 0)
            got = (r.answer, r.distance if q.s == q.t else None)
        else:
            ok = d >= 0 and (q.bound is None or d <= q.bound)
            want, got = (ok, d if ok else None), (r.answer, r.distance)
        if got != want:
            raise AssertionError(f"{what}: {q}: got {got}, BFS {want}")
    reach = sum(isinstance(q, Reach) for q in queries)
    return {"reach": reach, "dist": len(queries) - reach}


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
    from repro_torch.kernels.tropical_matmul import ops as tops

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
    _assert_no_copies("main path")
    checked = _check_reach_dist(g, queries, results)
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
    del eye
    # the min-plus operands in padded storage, as the closure and the
    # per-query phase make them
    W0 = tops.padded_i32(nb, nb, "cuda").copy_(
        _gather_boundary_matrix(fr, cache.bl_dist, cache.part_b))
    W0.diagonal().fill_(0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sb = torch.rand((N_PER_KIND, nb), device="cuda", generator=gen) < 0.01
    sbd = torch.index_select(
        W0, 0, torch.randint(0, nb, (N_PER_KIND,), device="cuda",
                             generator=gen),
        out=tops.padded_i32(N_PER_KIND, nb, "cuda"))
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
    # the library call for the compose: cuBLAS fp16 on the same batch
    sbh, Cch = sb.half(), C.half()
    t_or_cp_lib, got = cuda_timed(lambda: (sbh @ Cch) > 0, 5)
    _check_equal("cuBLAS fp16 compose", got, or_and_matmul_ref(sb, C))
    del sbh, Cch, got
    copies = _copies()
    t_mp_plain, want = cuda_timed(lambda: min_plus_matmul_ref(W0, W0), 1,
                                  warmup=False)
    t_mp_sq, got = cuda_timed(lambda: min_plus_matmul(W0, W0), 2)
    _check_equal("min_plus squaring", got, want)
    err_mp = _max_abs_err(got, want)
    del got
    t_mp_former = _time_former("min_plus squaring", want, W0, W0, reps=2)
    t_mp_cp_plain, want = cuda_timed(lambda: min_plus_matmul_ref(sbd, Cd), 1)
    t_mp_cp, got = cuda_timed(lambda: min_plus_matmul(sbd, Cd), 5)
    _check_equal("min_plus compose", got, want)
    err_mp = max(err_mp, _max_abs_err(got, want))
    t_mp_cp_former = _time_former("min_plus compose", want, sbd, Cd)
    del got, want
    if _copies() != copies:
        raise AssertionError("the min-plus timings copied an operand")
    routes = _route_threshold(W0)
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
    fmt = lambda ms: "not timed" if ms is None else f"{ms:.3f} ms"
    print(f"time or_and_matmul compose: cuBLAS fp16 {t_or_cp_lib:.3f} ms")
    print(f"time min_plus_matmul: squaring [{nb}]^2 {t_mp_sq:.3f} ms "
          f"(bound {b_mp:.3f} ms, {by_mp}, at the measured DPX rate, "
          f"{100 * b_mp / t_mp_sq:.1f} %), plain {t_mp_plain:.3f} ms, former "
          f"kernel {fmt(t_mp_former)}; compose [{N_PER_KIND},{nb}]x[{nb},{nb}]"
          f" {t_mp_cp:.3f} ms (bound {b_mp_cp:.3f} ms, "
          f"{100 * b_mp_cp / t_mp_cp:.1f} %), plain {t_mp_cp_plain:.3f} ms, "
          f"former kernel {fmt(t_mp_cp_former)}")
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
         "compose_bound_ms": b_or_cp, "compose_library_ms": t_or_cp_lib,
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
         "former_ms": t_mp_former, "compose_former_ms": t_mp_cp_former,
         "route_threshold": routes,
         "dispatch": {
             "squaring": tops._card_route(0, nb, nb, nb)._asdict(),
             "compose": tops._card_route(0, N_PER_KIND, nb, nb)._asdict()},
         "squarings": squarings["min_plus_matmul"]},
    ]
    out["main"] = {"warm_ms": warm_ms, "run_ms": run_ms,
                   "per_query_us": per_query_us, "nb": nb,
                   "launches": launches}
    return g, fr, queries, results


ROUTE_ROWS = (1, 8, 16, 32, 64)


def _route_threshold(W0) -> dict:
    """The min-plus kernel's two routes side by side at the products the
    skinny route takes, ``W0[:M] (x) W0`` for M in ``ROUTE_ROWS``: the
    wrapper (skinny) against the tile entry called directly on the same
    operands, bit-equal; and the skinny blocks an SM holds by rows per
    thread.  Evidence for ``ops.SKINNY_MAX_M``."""
    import torch
    from repro_torch.kernels.tropical_matmul import min_plus_matmul
    from repro_torch.kernels.tropical_matmul import ops as tops
    lib, tile, _, per_sm, check = tops._entries()
    nb = W0.shape[0]
    occupancy = {rows: per_sm(rows, 2 if rows > 32 else 4)
                 for rows in tops.PER_SM_GUESS}
    times = {}
    for m in ROUTE_ROWS:
        a = W0[:m]
        out = tops.padded_i32(m, nb, W0.device)

        def tiled():
            check(lib, "min_plus_tile", tile(
                a.data_ptr(), W0.data_ptr(), None, out.data_ptr(), m, nb,
                nb, a.stride(0), W0.stride(0), 0, out.stride(0),
                torch.cuda.current_stream().cuda_stream))
            return out
        skinny_ms, got = cuda_timed(lambda: min_plus_matmul(a, W0), 5)
        tile_ms, want = cuda_timed(tiled, 5)
        _check_equal(f"min_plus skinny vs tile, M = {m}", got, want)
        times[m] = {"skinny_ms": skinny_ms, "tile_ms": tile_ms,
                    "route": tops._card_route(0, m, nb, nb)._asdict()}
    print(f"time min_plus_matmul routes at [M,{nb}]x[{nb},{nb}] (ms, skinny "
          f"/ tile): " + ", ".join(f"M={m} {t['skinny_ms']:.4f} / "
                                   f"{t['tile_ms']:.4f}"
                                   for m, t in times.items())
          + f"; skinny blocks per SM by rows {occupancy}")
    return {"times": times, "skinny_blocks_per_sm": occupancy}


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
        checked = _check_reach_dist(g, qs, r["results"], f"sharded {kind}")
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
# helpers of the one-shot and dynamic phases
# ---------------------------------------------------------------------------

def _mixed_queries(n, rng, count):
    """``count`` Reach and Dist queries (every second Dist bounded at 6)."""
    from repro_torch import Dist, Reach
    pairs = rng.integers(0, n, size=(count, 2))
    return [Reach(int(s), int(t)) if i % 2 == 0 else
            Dist(int(s), int(t), bound=6 if i % 4 == 1 else None)
            for i, (s, t) in enumerate(pairs)]


def _mm_bound(m, k, n, kind, dpx_per_s, transpose=False, floor=False):
    """(ms, bound_by) of one [m, k] x [k, n] product: or-and ("or_and",
    2mkn int8 tensor-core operations on 1-byte operands, C^T too when
    ``transpose``; with ``floor`` the floor pair C [m, n] and C^T [n, m]
    read at their logical width, whose pads the kernel never reads, and
    C' and C'^T written to their row pitch, pads included) or min-plus
    ("min_plus", mkn DPX operations on int32, an [m, n] floor read too
    when ``floor``)."""
    if kind == "or_and" and floor:
        from repro_torch.kernels.bool_matmul import pitch
        return _bound(2 * m * k * n, INT8_TENSOR_OPS_PER_S,
                      m * k + k * n + 2 * m * n
                      + m * pitch(n) + n * pitch(m))
    if kind == "or_and":
        return _bound(2 * m * k * n, INT8_TENSOR_OPS_PER_S,
                      m * k + k * n + m * n * (2 if transpose else 1))
    return _bound(m * k * n, dpx_per_s,
                  4 * (m * k + k * n + m * n * (2 if floor else 1)))


#: a min-plus call faster than this (ms) is launch-bound: it is timed in
#: LAUNCH_BOUND_TURNS turns with the former kernel, and from a CUDA graph
LAUNCH_BOUND_MS = 0.1
LAUNCH_BOUND_TURNS = 7


def _time_shape(name, kind, run, plain, library, m, k, n, dpx_per_s,
                transpose=False, reps=20, former=None, floor=False) -> dict:
    """One launch shape of a kernel: its time on the given operands beside
    its plain version's (bit-equal), its bound and a library call's; for
    the min-plus kernel also its route and, when ``former`` is given and a
    former kernel was built, that kernel's time on the same function."""
    ms, got = cuda_timed(run, reps)
    plain_ms, want = cuda_timed(plain, 1, warmup=False)
    got_c = got[0] if transpose else got
    _check_equal(name, got_c, want)
    if transpose:
        _check_equal(name + " C^T", got[1], want.T)
    del got
    former_ms = None if former is None else _time_former(name, want, *former)
    del want
    lib_ms = None if library is None else cuda_timed(library, 3)[0]
    bound_ms, by = _mm_bound(m, k, n, kind, dpx_per_s, transpose, floor)
    entry = {"shape": f"[{m},{k}]x[{k},{n}]" + (", C and C^T" if transpose
                                                 else "")
             + (", floor" if floor else ""),
             "path": name, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
             "max_abs_err": 0.0}
    if kind == "min_plus":
        from repro_torch.kernels.tropical_matmul import ops as tops
        entry["dispatch"] = tops._card_route(0, m, k, n)._asdict()
        entry["former_ms"] = former_ms
        if ms < LAUNCH_BOUND_MS:
            # launch-bound: host time, which spreads from run to run, so
            # the two kernels take turns and each reports its median; and
            # the device's time alone, from a CUDA graph
            if former_ms is not None:
                old = lambda: former_min_plus(*former[:3])
                turns = []                 # (new ms, former ms), in turns
                for i in range(LAUNCH_BOUND_TURNS):
                    order = (run, old) if i % 2 == 0 else (old, run)
                    first, second = (cuda_timed(f, reps)[0] for f in order)
                    turns.append((first, second) if i % 2 == 0
                                 else (second, first))
                ms = statistics.median(t[0] for t in turns)
                former_ms = statistics.median(t[1] for t in turns)
                entry.update(ms=ms, former_ms=former_ms, turns_ms=turns)
            entry["graph_ms"] = graph_timed(run)
            entry["former_graph_ms"] = (
                None if former_ms is None
                else graph_timed(lambda: former_min_plus(*former[:3])))
            fg = entry["former_graph_ms"]
            print(f"time {name}: launch-bound; from a CUDA graph "
                  f"{entry['graph_ms']:.4f} ms, former kernel "
                  f"{'not timed' if fg is None else f'{fg:.4f} ms'}")
    print(f"time {name} [{m},{k}]x[{k},{n}]: {ms:.4f} ms (bound "
          f"{bound_ms:.4f} ms, {by}, {100 * bound_ms / ms:.1f} %), plain "
          f"{plain_ms:.3f} ms, library "
          f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
          + ("" if kind != "min_plus" else
             f", route {entry['dispatch']}, former kernel "
             f"{'not timed' if former_ms is None else f'{former_ms:.4f} ms'}"))
    return entry


# ---------------------------------------------------------------------------
# 5. the one-shot algorithms at full size
# ---------------------------------------------------------------------------

N_ONESHOT, N_ONESHOT_RPQ = 32, 4
ONESHOT_REGEX = "(0|1)* 2"


def _split_one_shot(fr, s, t, kind, qa=None):
    """One one-shot query taken apart as ``session.exec_*`` runs it, with
    CUDA events around its stages: the local stage (the allocation of D in
    padded storage or of W's row lists, and localEval's one launch, which
    writes every row into it; for RPQ the product's row block and its
    assembly) and evalDG (one fixpoint launch, its steps as the kernel
    counted them; for dist the row-list settle kernel's levels and rows
    read), which reads D or the lists as they are stored.  Returns the
    split, the answer, D (for dist the row lists) and the source rows."""
    import torch
    from repro_torch.core import engine, session as S
    from repro_torch.kernels.bool_matmul import ops as bops
    from repro_torch.kernels.tropical_matmul import ops as tops
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    clock = _PhaseClock()
    clock("local")
    arrs, s_local, t_local = S._query_inputs(fr, s, t, dev)
    a = [arrs[name] for name in ("esrc", "edst", "src_local", "src_row",
                                 "tgt_local")]
    Q, start, final = 1, 0, 0
    if kind == "reach":
        D = engine.local_eval_reach(*a, s_local, t_local, n_max=fr.n_max,
                                    B=fr.B, out=bops.padded(fr.B, fr.B, dev))
    elif kind == "dist":
        D = engine.local_eval_dist(*a, s_local, t_local, n_max=fr.n_max,
                                   B=fr.B, out=tops.row_lists(fr.B, dev))
    else:
        Q, start, final = qa.n_states, qa.start, qa.final
        D = engine.regular_rvset(
            *a, arrs["labels"], arrs["gids"],
            torch.tensor(qa.state_labels, device=dev),
            torch.tensor(qa.trans, device=dev), s_local, t_local, s, t,
            n_max=fr.n_max, B=fr.B, side=fr.B * Q)
    src = S._src_rows(fr, dev, Q, start)
    tgt = S._tgt_cols(fr, t, dev, Q, final)
    # the fixpoint's (x, steps), or the settle kernel's [answer, levels,
    # rows], kept as the engine gets them
    name = "min_plus_settle_lists" if kind == "dist" else "or_and_fixpoint"
    orig, kept = getattr(engine, name), {}

    def keep(*args):
        kept["result"] = orig(*args)
        return kept["result"]

    clock("evaldg")
    setattr(engine, name, keep)
    try:
        if kind == "dist":
            ans = engine.evaldg_dist(D, src, tgt)
        else:
            ans = engine.evaldg_reach(D, src, tgt)
    finally:
        setattr(engine, name, orig)
    clock("end")
    split = clock.ms()
    split["steps"] = steps = int(kept["result"][1])
    split["ms_per_step"] = split["evaldg"] / max(steps, 1)
    if kind == "dist":
        split["rows"] = int(kept["result"][2])
        split["entries"] = int(kept["result"][4])
    return split, ans, D, src, tgt


def _local_eval_timed(fr, s, t, reps=5) -> dict:
    """Both entries of the localEval kernel at full size on one query's
    inputs: D (reach), W exact and W capped at 6 (``bounded``), written by
    ``local_eval_reach_into`` / ``local_eval_dist_into`` into storage whose
    every byte was 0x5A, held byte for byte, pads included, against the
    plain version (``engine._rows_*``, its row block written into a D of
    zeros or a W of INF), with one launch a call and no host sync; then
    timed (CUDA events, ``reps`` calls) beside the plain version (one call)
    and beside the least time its bytes take: every row written once over
    its pitch, the edges, sources and column map read once."""
    import torch
    from repro_torch.core import engine, session as S
    from repro_torch.kernels.bool_matmul.ops import pitch
    from repro_torch.kernels.local_eval import ops as lops
    from repro_torch.kernels.tropical_matmul.ops import pitch_i32
    dev = torch.device("cuda")
    arrs, s_local, t_local = S._query_inputs(fr, s, t, dev)
    args = [arrs[name] for name in ("esrc", "edst", "src_local", "src_row",
                                    "tgt_local")] + [s_local, t_local]
    B, n_max = fr.B, fr.n_max
    F, E = args[0].shape
    n_src = args[2].shape[1]
    read = 4 * F * (2 * E + 2 * n_src + B + 2)
    res = {}
    for kind, cap in (("reach", None), ("dist", engine.INF), ("bounded", 6)):
        dist = cap is not None
        dtype, width = ((torch.int32, pitch_i32(B)) if dist
                        else (torch.bool, pitch(B)))
        esize = 4 if dist else 1
        got = torch.full((B, width * esize), 0x5A, dtype=torch.uint8,
                         device=dev)
        m = got.view(dtype)[:, :B]
        if dist:
            into = lambda c=cap: lops.local_eval_dist_into(
                m, *args, c, n_max=n_max)
        else:
            into = lambda: lops.local_eval_reach_into(m, *args, n_max=n_max)

        def plain(c=cap):
            want = torch.full((B, width), engine.INF if dist else 0,
                              dtype=torch.int32 if dist else torch.uint8,
                              device=dev)
            if dist:
                rows, block = engine._rows_dist(*args, c, n_max=n_max, B=B)
            else:
                rows, block = engine._rows_reach(*args, n_max=n_max, B=B)
            want.view(dtype)[:, :B][rows] = block
            return want.view(torch.uint8)

        before = lops.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            into()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        plain_ms, want = cuda_timed(plain, 1, warmup=False)
        _check_equal(f"local_eval {kind}", got, want)
        del want
        ms, _ = cuda_timed(into, reps, warmup=False)
        if lops.launches - before != reps + 1:
            raise AssertionError(f"local_eval {kind}: not one launch a call")
        nbytes = B * width * esize + read
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        res[kind] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bytes": nbytes, "share": bound_ms / ms}
        print(f"time local_eval {kind}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes,"
              f" {100 * bound_ms / ms:.1f} %); bit-equal, pads included")
        del got, m
    torch.cuda.empty_cache()
    for kind, cap in (("lists", engine.INF), ("lists_bounded", 6)):
        res[kind] = _local_eval_lists_timed(args, cap, B, n_max, read, reps)
    res["shape"] = (f"B {B} (pitch {pitch(B)} bytes / {pitch_i32(B)} int32), "
                    f"F {F}, S {n_src}, E {E}, n_max {n_max}")
    return res


def _sorted_lists(lists):
    """Each row's pairs sorted by column, INF past its count: row lists
    compared whatever order the appends took."""
    import torch
    live = (torch.arange(lists.pairs.shape[1], device=lists.count.device)
            [None, :] < lists.count[:, None])
    key = torch.where(live, lists.pairs[:, :, 0], 1 << 30)
    order = key.argsort(1)
    pairs = torch.gather(lists.pairs, 1, order[:, :, None].expand(
        -1, -1, 2))
    return torch.where(live[:, :, None], pairs, 1 << 29)


def _local_eval_lists_timed(args, cap, B, n_max, read, reps) -> dict:
    """localEval's row-list route at full size on one query's inputs, into
    fresh row lists: each row's pairs, its count and the meta held equal
    to the plain version's (``engine._rows_dist``'s block turned into
    lists), one launch a call (counted as a row-list launch) and no host
    sync; timed beside the plain version and beside the least time its
    bytes take: the pairs and counts stored once, the edges, sources and
    column map read once."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels.local_eval import ops as lops
    from repro_torch.kernels.tropical_matmul import ops as tops
    dev = args[0].device
    got = tops.row_lists(B, dev)
    before = (lops.launches, lops.list_launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lops.local_eval_dist_lists(got, *args, cap, n_max=n_max)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    plain_ms, want = cuda_timed(lambda: tops.write_row_lists(
        tops.row_lists(B, dev), *engine._rows_dist(*args, cap, n_max=n_max,
                                                   B=B)), 1, warmup=False)
    kind = "lists" if cap >= engine.INF else "lists_bounded"
    _check_equal(f"local_eval {kind} counts", got.count, want.count)
    _check_equal(f"local_eval {kind} meta", got.meta, want.meta)
    _check_equal(f"local_eval {kind} pairs", _sorted_lists(got),
                 _sorted_lists(want))
    entries = int(want.meta[1])
    del want
    ms, _ = cuda_timed(lambda: lops.local_eval_dist_lists(
        got, *args, cap, n_max=n_max), reps, warmup=False)
    if (lops.launches - before[0], lops.list_launches - before[1]) != \
            (reps + 1, reps + 1):
        raise AssertionError(f"local_eval {kind}: not one row-list launch "
                             "a call")
    nbytes = 8 * entries + 4 * B + read
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"time local_eval {kind}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes, "
          f"{100 * bound_ms / ms:.2f} %); {entries} pairs, equal to the "
          f"plain version's row for row")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bytes": nbytes, "share": bound_ms / ms, "entries": entries}


#: empty steps the grid-barrier probe times (beside a launch of none)
PROBE_STEPS = 1000


def _barrier_ms_per_step(blocks: int) -> float:
    """ms of one empty fixpoint step (reading the list's length, two grid
    barriers) on a cooperative grid of ``blocks`` blocks: the probe in
    ``or_and_skinny.cu`` with PROBE_STEPS steps less the probe with none,
    over PROBE_STEPS."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    lib = _build.library("or_and_skinny")
    fn = lib.fixpoint_barrier_probe
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    state = torch.zeros(3, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def probe(steps):
        return lambda: _build.check(lib, "fixpoint_barrier_probe", fn(
            state.data_ptr(), blocks, steps, stream))
    empty = cuda_timed(probe(0), 5)[0]
    return (cuda_timed(probe(PROBE_STEPS), 3)[0] - empty) / PROBE_STEPS


def _evaldg_timed(name, D, src, tgt, want, reps=3) -> dict:
    """The whole evalDG fixpoint of a checked reach query (its answer
    ``want``) on the card: the fixpoint kernel alone (its wrapper) and the
    engine's ``evaldg_reach`` around it (the answer read back), CUDA
    events around ``reps`` runs each, and the plain version (a host loop
    of one product and one sync a step) once; x and the steps held equal
    to the plain version's.  A host loop of the steps, each ORing the rows
    of D that the step before added (the kernel's schedule, whose iterates
    are the naive loop's), counts each step's new rows |Delta_t|, the rows
    that ever enter Delta and each step's frontier.  The bound is the
    bytes the fixpoint must read: each row that ever enters Delta once, N
    bytes each, plus two vector passes (2 N) a step.  Printed beside it:
    the old bound, the rows each step's frontier holds (sum_t |x_t| N +
    2 N).  The floor is the empty step's cost (the grid-barrier probe at
    this fixpoint's grid) times the steps."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels.bool_matmul import ops as bops
    K, N = D.shape
    delta, frontier = [], []
    cur, new = src, src
    entered = torch.zeros(K, dtype=torch.bool, device=D.device)
    while bool(new.any()):                # the fixpoint's own steps
        delta.append(int(new.sum()))
        entered |= new
        frontier.append(int(cur.sum()))
        nxt = cur | D[new].any(dim=0)
        new = nxt & ~cur
        cur = nxt
    del cur, new
    before = bops.fixpoint_launches
    ms, (got, steps) = cuda_timed(lambda: bops.or_and_fixpoint(src, D), reps)
    if bops.fixpoint_launches - before != reps + 1:
        raise AssertionError(f"{name}: not one fixpoint launch a call")
    before = bops.fixpoint_launches
    evaldg_ms, ans = cuda_timed(lambda: engine.evaldg_reach(D, src, tgt),
                                reps)
    if bops.fixpoint_launches - before != reps + 1:
        raise AssertionError(f"{name}: not one fixpoint launch an evalDG")
    plain_ms, (want_x, want_steps) = cuda_timed(
        lambda: bops.or_and_fixpoint_ref(src, D), 1, warmup=False)
    _check_equal(f"{name} fixpoint", got, want_x)
    _check_equal(f"{name} fixpoint steps", steps, want_steps)
    if ans != want or int(steps) != len(delta):
        raise AssertionError(f"{name}: evalDG gave {ans} in {int(steps)} "
                             f"steps, expected {want} in {len(delta)}")
    del got, want_x
    blocks = bops._card_fixpoint_route(0, K).blocks
    barrier = _barrier_ms_per_step(blocks)
    distinct = int(entered.sum())
    del entered
    nbytes = distinct * N + 2 * N * len(delta)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    old_bytes = sum(r * N + 2 * N for r in frontier)
    old_bound_ms = old_bytes / HBM_BYTES_PER_S * 1e3
    floor_ms = barrier * len(delta)
    print(f"time {name} fixpoint: kernel {ms:.4f} ms, evaldg "
          f"{evaldg_ms:.4f} ms, plain {plain_ms:.3f} ms, in {len(delta)} "
          f"steps (new rows {delta}); bound {bound_ms:.4f} ms ({distinct} "
          f"rows read once, bytes {nbytes}, {100 * bound_ms / ms:.2f} %); "
          f"rows the frontiers hold {frontier}, {old_bound_ms:.4f} ms; "
          f"{blocks} blocks, empty step {1e3 * barrier:.2f} us, floor "
          f"{floor_ms:.4f} ms")
    return {"ms": ms, "evaldg_ms": evaldg_ms, "plain_ms": plain_ms,
            "steps": len(delta), "delta_rows": delta,
            "frontier_rows": frontier, "distinct_rows": distinct,
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
            "frontier_bound_ms": old_bound_ms, "blocks": blocks,
            "barrier_ms_per_step": barrier, "barrier_floor_ms": floor_ms,
            "max_abs_err": 0.0, "shape": f"[{K}], [{K},{N}]"}


def _settle_timed(W, src, tgt, want, reps=3) -> dict:
    """evalDG's dist kernel, ``min_plus_settle``, on a checked dist query's
    W, sources and targets (its answer ``want``) on the card, unbounded
    (``dist``) and with bound 6 (``bounded``): the kernel alone (its
    wrapper) and the engine's ``evaldg_dist`` around it (the state read
    back), CUDA events around ``reps`` runs each, each call one launch
    counted as the settle kernel's; and
    the plain version ``min_plus_settle_ref`` (the same schedule in
    PyTorch, a host sync a level) once, whose whole state [answer, levels,
    rows] the kernel's must equal.  The bound is the bytes of the rows it
    read: rows x W's row pitch in bytes."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels.tropical_matmul import ops as tops
    B = W.shape[0]
    d0 = torch.full((B,), engine.INF, dtype=torch.int32, device=W.device)
    d0.masked_fill_(src, 0)
    pitch_bytes = W.stride(0) * W.element_size()
    res = {}
    for kind, bound in (("dist", None), ("bounded", 6)):
        expect = want if bound is None or want <= bound else engine.INF
        before = tops.settle_launches
        ms, got = cuda_timed(
            lambda b=bound: tops.min_plus_settle(d0, W, tgt, b), reps)
        evaldg_ms, ans = cuda_timed(
            lambda b=bound: engine.evaldg_dist(W, src, tgt, bound=b), reps)
        if tops.settle_launches - before != 2 * (reps + 1):
            raise AssertionError(f"min_plus_settle {kind}: not one settle "
                                 "launch a call")
        plain_ms, want_state = cuda_timed(
            lambda b=bound: tops.min_plus_settle_ref(d0, W, tgt, b), 1,
            warmup=False)
        _check_equal(f"min_plus_settle {kind} state", got, want_state)
        answer, levels, rows = got.tolist()
        if answer != expect or ans != expect:
            raise AssertionError(f"min_plus_settle {kind}: kernel {answer}, "
                                 f"evaldg {ans}, expected {expect}")
        nbytes = rows * pitch_bytes
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        res[kind] = {"ms": ms, "evaldg_ms": evaldg_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bytes": nbytes,
                     "share": bound_ms / ms, "answer": answer,
                     "levels": levels, "rows": rows}
        print(f"time min_plus_settle {kind}: kernel {ms:.4f} ms, evaldg "
              f"{evaldg_ms:.4f} ms, plain {plain_ms:.3f} ms; answer {answer}"
              f" in {levels} levels, {rows} of {B} rows read; bound "
              f"{bound_ms:.4f} ms ({nbytes} bytes, {100 * bound_ms / ms:.1f}"
              f" %); state equal to the plain version's")
    blocks = tops._card_settle_route(W.device.index or 0, B).blocks
    res.update({"ms": res["dist"]["ms"], "plain_ms": res["dist"]["plain_ms"],
                "bound_ms": res["dist"]["bound_ms"], "bound_by": "bytes",
                "blocks": blocks, "max_abs_err": 0.0,
                "shape": f"[{B}], [{B},{B}] (pitch {pitch_bytes} bytes)"})
    return res


def _final_distances(lists, src):
    """d of the plain fixpoint on W's row lists: Bellman-Ford over every
    pair at once, a scatter-min a step, until nothing falls."""
    import torch
    from repro_torch.core.engine import INF
    live = (torch.arange(lists.pairs.shape[1], device=src.device)[None, :]
            < lists.count[:, None])
    rows = torch.arange(lists.B, device=src.device)[:, None].expand_as(
        live)[live]
    cols = lists.pairs[:, :, 0][live].long()
    w = lists.pairs[:, :, 1][live]
    d = torch.where(src, 0, INF).to(torch.int32)
    while True:
        nxt = d.scatter_reduce(0, cols, (d[rows] + w).clamp_max(INF),
                               "amin")
        if torch.equal(nxt, d):
            return d
        d = nxt


def _settle_lists_timed(lists, W, src, tgt, want, reps=3) -> dict:
    """evalDG's dist kernel on W's row lists, ``min_plus_settle_lists``, on
    a checked dist query (its answer ``want``), unbounded and with bound 6:
    the kernel alone and the engine's ``evaldg_dist`` around it, CUDA
    events around ``reps`` runs each, one launch a call; its state held
    equal to the dense kernel's on the same query's W and to its plain
    version's.  The bound is the pairs of the rows it read, 8 bytes each
    (the rows whose final distance lies below the level it stopped at);
    the floor its level rounds, one grid barrier each (half the barrier
    probe's empty step at its grid)."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels.tropical_matmul import ops as tops
    B = lists.B
    d0 = torch.full((B,), engine.INF, dtype=torch.int32, device=src.device)
    d0.masked_fill_(src, 0)
    d = _final_distances(lists, src)
    blocks = min(tops.SETTLE_LIST_BLOCKS, tops._settle_list_slots(
        src.device.index or 0))
    barrier = _barrier_ms_per_step(blocks) / 2
    res = {}
    for kind, bound in (("dist", None), ("bounded", 6)):
        expect = want if bound is None or want <= bound else engine.INF
        before = tops.settle_list_launches
        ms, got = cuda_timed(
            lambda b=bound: tops.min_plus_settle_lists(src, lists, tgt, b),
            reps)
        evaldg_ms, ans = cuda_timed(
            lambda b=bound: engine.evaldg_dist(lists, src, tgt, bound=b),
            reps)
        if tops.settle_list_launches - before != 2 * (reps + 1):
            raise AssertionError(f"min_plus_settle_lists {kind}: not one "
                                 "launch a call")
        plain_ms, want_state = cuda_timed(
            lambda b=bound: tops.min_plus_settle_lists_ref(src, lists, tgt,
                                                           b), 1,
            warmup=False)
        _check_equal(f"min_plus_settle_lists {kind} state", got, want_state)
        dense = tops.min_plus_settle(d0, W, tgt, bound)
        _check_equal(f"min_plus_settle_lists {kind} vs dense", got[:3],
                     dense)
        answer, levels, rows, _, entries = got.tolist()
        if answer != expect or ans != expect:
            raise AssertionError(f"min_plus_settle_lists {kind}: kernel "
                                 f"{answer}, evaldg {ans}, expected {expect}")
        finite = torch.unique(d[d < engine.INF])
        stop = (int(finite[levels]) if levels < finite.numel()
                else engine.INF)
        settled = d < stop
        if int(settled.sum()) != rows:
            raise AssertionError(f"min_plus_settle_lists {kind}: {rows} rows "
                                 f"read, {int(settled.sum())} settled")
        read = int(lists.count[settled].sum())
        nbytes = 8 * read
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        floor_ms = barrier * levels
        res[kind] = {"ms": ms, "evaldg_ms": evaldg_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bytes": nbytes,
                     "share": bound_ms / ms, "answer": answer,
                     "levels": levels, "rows": rows, "pairs_read": read,
                     "floor_ms": floor_ms, "entries": entries}
        print(f"time min_plus_settle_lists {kind}: kernel {ms:.4f} ms, "
              f"evaldg {evaldg_ms:.4f} ms, plain {plain_ms:.3f} ms; answer "
              f"{answer} in {levels} levels, {rows} of {B} rows read "
              f"({read} of {entries} pairs); bound {bound_ms:.5f} ms "
              f"({nbytes} bytes, {100 * bound_ms / ms:.2f} %); level-round "
              f"floor {floor_ms:.4f} ms ({blocks} blocks, "
              f"{1e3 * barrier:.2f} us a round); state equal to the dense "
              f"kernel's and the plain version's")
    res.update({"ms": res["dist"]["ms"], "plain_ms": res["dist"]["plain_ms"],
                "bound_ms": res["dist"]["bound_ms"], "bound_by": "bytes",
                "blocks": blocks, "max_abs_err": 0.0,
                "shape": f"[{B}], row lists [{B}, {tops.ROW_CAP}]"})
    return res


def _rpq_targets(g, s: int, qa) -> np.ndarray:
    """[n] bool: every t that (s, t) answers True for the automaton ``qa``,
    from one product-graph BFS in which the t-only state matches every
    node (it has no outgoing transition, so no path goes on from it)."""
    lq = qa.state_labels
    nodes = np.arange(g.n)
    match = ((lq[None, :] >= 0) & (g.labels[:, None] == lq[None, :])) \
        | (lq[None, :] == -3) | (lq[None, :] == -2) \
        | ((lq[None, :] == -1) & (nodes[:, None] == s))
    trans = qa.trans.astype(np.int64)
    seen = np.zeros((g.n, qa.n_states), dtype=bool)
    seen[s, qa.start] = match[s, qa.start]
    frontier = seen.copy()
    while frontier.any():
        adv = (frontier.astype(np.int64) @ trans) > 0
        nxt = np.zeros_like(seen)
        rows, qs = np.nonzero(adv[g.src])
        nxt[g.dst[rows], qs] = True
        nxt &= match
        frontier = nxt & ~seen
        seen |= nxt
    hit = seen[:, qa.final].copy()
    hit[s] = False
    return hit


def _rpq_pairs(g, qa, rng, count: int) -> np.ndarray:
    """``count`` (s, t) pairs, every second one a pair that the automaton
    accepts (found by :func:`_rpq_targets` from seeded sources), the
    others drawn at random, so that the answers are not all False."""
    pairs = rng.integers(0, g.n, size=(count, 2))
    for i in range(0, count, 2):
        for s in rng.integers(0, g.n, size=64):
            hit = np.nonzero(_rpq_targets(g, int(s), qa))[0]
            if hit.size:
                pairs[i] = (s, rng.choice(hit))
                break
    return pairs


def phase_oneshot(out: dict, g, fr) -> None:
    """``connect(fr, cache="none")`` at full size: 16 Reach and 16 Dist (8
    bounded) and 4 Rpq, each a one-shot evaluation, checked against the
    host BFS, each evalDG one launch; the per-query split; the two
    single-query sharded functions on the one-rank NCCL group; both
    kernels at evalDG's vector-matrix shape, M = 1, held against their
    plain versions; and both fixpoint kernels and the settle kernel on the
    split queries, timed against the bytes they read."""
    import torch
    import repro_torch
    from repro_torch import Rpq
    from repro_torch.core import distributed as Dd
    from repro_torch.kernels.tropical_matmul import (min_plus_matmul,
                                                     min_plus_matmul_ref)

    rng = np.random.default_rng(SEED + 2)
    from repro_torch import Dist, Reach
    pairs = rng.integers(0, g.n, size=(N_ONESHOT, 2))
    half = N_ONESHOT // 2
    queries = [Reach(int(s), int(t)) for s, t in pairs[:half]]
    queries += [Dist(int(s), int(t), bound=6 if i % 2 else None)
                for i, (s, t) in enumerate(pairs[half:])]
    sess = repro_torch.connect(fr, cache="none")
    sess.run(queries[:1])                                # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    with _EvalDGCalls() as calls:
        t0 = time.perf_counter()
        results = sess.run(queries)
        run_ms = (time.perf_counter() - t0) * 1e3
    launches = _launches()
    _assert_one_fixpoint_each("one-shot path", launches, calls,
                              local=calls.reach + calls.dist)
    if not (calls.reach and calls.dist):
        raise AssertionError(f"one-shot path: evalDGs {calls.reach} reach, "
                             f"{calls.dist} dist")
    if any(r.cache_version is not None for r in results):
        raise AssertionError("an uncached result carries a cache version")
    for q, r in zip(queries, results):
        if q.s != q.t and r.stats.payload_bits != fr.traffic_bits(q.kind):
            raise AssertionError(f"{q}: {r.stats} is not traffic_bits")
    checked = _check_reach_dist(g, queries, results, "oneshot")
    print(f"oneshot: run of {len(queries)} one-shot queries "
          f"({half} Reach, {half} Dist, {half // 2} bounded) {run_ms:.1f} ms;"
          f" launches {launches}; {checked} answers match the host BFS")

    qa = sess._resolve_automaton(Rpq(0, 1, regex=ONESHOT_REGEX))
    rpq_pairs = _rpq_pairs(g, qa, rng, N_ONESHOT_RPQ)
    rpqs = [Rpq(int(s), int(t), regex=ONESHOT_REGEX) for s, t in rpq_pairs]
    torch.cuda.synchronize()
    _reset_launches()
    with _EvalDGCalls() as calls:
        t0 = time.perf_counter()
        rpq_results = sess.run(rpqs)
        rpq_ms = (time.perf_counter() - t0) * 1e3
    rpq_launches = _launches()
    _assert_one_fixpoint_each("one-shot RPQ path", rpq_launches, calls,
                              local=0)
    for q, r in zip(rpqs, rpq_results):
        want = _rpq_oracle(g, q.s, q.t, qa)
        if r.answer != want:
            raise AssertionError(f"oneshot {q}: got {r.answer}, product "
                                 f"BFS {want}")
    if not any(r.answer for r in rpq_results):
        raise AssertionError("no one-shot RPQ answered True")
    side = fr.B * qa.n_states
    print(f"oneshot: {len(rpqs)} Rpq {ONESHOT_REGEX!r} at full size (D "
          f"[{side}]^2, {side * side / 1e9:.2f} GB, read as stored) "
          f"{rpq_ms:.1f} ms; launches {rpq_launches}; answers "
          f"{[r.answer for r in rpq_results]} match the product-graph BFS")

    # the per-query time split, one query of each kind
    split = {}
    s, t = int(pairs[0, 0]), int(pairs[0, 1])
    split["reach"], ans, D, src, tgt = _split_one_shot(fr, s, t, "reach")
    if ans != results[0].answer:
        raise AssertionError("the split reach query disagrees with the run")
    sd, td = int(pairs[half, 0]), int(pairs[half, 1])
    split["dist"], ans_d, Wl, srcd, tgtd = _split_one_shot(fr, sd, td,
                                                           "dist")
    from repro_torch.core.engine import INF
    want_d = results[half].distance
    if ans_d != (INF if want_d is None else want_d):
        raise AssertionError("the split dist query disagrees with the run")
    if launches["local_eval_lists"] != launches["min_plus_settle_lists"] \
            or launches["min_plus_settle_lists"] != sum(
                q.kind == "dist" and q.s != q.t for q in queries):
        raise AssertionError(f"one-shot path: not one row-list localEval "
                             f"and one row-list settle a Dist: {launches}")
    from repro_torch.core import engine as E, session as S
    from repro_torch.kernels.tropical_matmul import ops as tops
    # the same query's dense W, for the dense kernels' shapes
    arrs, s_loc, t_loc = S._query_inputs(fr, sd, td, "cuda")
    W = E.local_eval_dist(*(arrs[n] for n in ("esrc", "edst", "src_local",
                                              "src_row", "tgt_local")),
                          s_loc, t_loc, n_max=fr.n_max, B=fr.B,
                          out=tops.padded_i32(fr.B, fr.B, "cuda"))
    del arrs
    # one step's vector, in padded storage as evaldg_dist keeps it
    d = tops.padded_i32(1, fr.B, "cuda")[0].fill_(INF)
    d.masked_fill_(srcd, 0)
    d = min_plus_matmul(d[None, :], W, init=d[None, :])[0]
    sr, tr = int(rpq_pairs[0, 0]), int(rpq_pairs[0, 1])
    split["rpq"], ans_q, Dq, _, _ = _split_one_shot(fr, sr, tr, "rpq", qa)
    if ans_q != rpq_results[0].answer:
        raise AssertionError("the split RPQ disagrees with the run")
    del Dq
    torch.cuda.empty_cache()
    local = _local_eval_timed(fr, sd, td)
    for kind, sp in split.items():
        print(f"oneshot: {kind} query split (ms) "
              + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                          f"{k} {v}" for k, v in sp.items()))

    # the single-query sharded functions on the one-rank NCCL group
    sharded = {}
    Dd.collectives = Dd.payload_bits = 0
    torch.cuda.synchronize()
    _reset_launches()
    with _EvalDGCalls() as calls:
        t0 = time.perf_counter()
        ans_s, D_host = Dd.dis_reach_sharded(fr, s, t)
        sharded["reach_ms"] = (time.perf_counter() - t0) * 1e3
        reach_wire = (Dd.collectives, Dd.payload_bits)
        Dd.collectives = Dd.payload_bits = 0
        t0 = time.perf_counter()
        ans_q = Dd.dis_rpq_sharded(fr, sr, tr, qa)
        sharded["rpq_ms"] = (time.perf_counter() - t0) * 1e3
    if reach_wire != (1, fr.traffic_bits("reach")):
        raise AssertionError(f"dis_reach_sharded: {reach_wire[0]} "
                             f"collectives of {reach_wire[1]} bits")
    if ans_s != results[0].answer or not np.array_equal(D_host,
                                                        D.cpu().numpy()):
        raise AssertionError("dis_reach_sharded disagrees with exec_reach")
    sharded["reach_bits"] = reach_wire[1]
    del D_host
    if (Dd.collectives, Dd.payload_bits) != (
            1, fr.traffic_bits("rpq", states=qa.n_states)):
        raise AssertionError(f"dis_rpq_sharded: {Dd.collectives} "
                             f"collectives of {Dd.payload_bits} bits")
    if ans_q != rpq_results[0].answer:
        raise AssertionError("dis_rpq_sharded disagrees with exec_rpq")
    sharded["rpq_bits"] = Dd.payload_bits
    sharded["launches"] = _launches()
    _assert_one_fixpoint_each("dis_reach_sharded / dis_rpq_sharded",
                              sharded["launches"], calls, local=int(s != t))
    torch.cuda.empty_cache()
    print(f"oneshot: dis_reach_sharded {sharded['reach_ms']:.1f} ms and "
          f"dis_rpq_sharded {sharded['rpq_ms']:.1f} ms on the one-rank "
          f"NCCL group, one collective each of {sharded['reach_bits']} and "
          f"{sharded['rpq_bits']} bits (traffic_bits); answers equal to "
          f"exec_reach / exec_rpq, D bit-equal; launches "
          f"{sharded['launches']}")

    # the min-plus product at evalDG's vector-matrix shape, M = 1; then the
    # split reach query through the or-and fixpoint kernel and the split
    # dist query through the settle kernel
    B = fr.B
    dpx = out["kernels"][1]["dpx_ops_per_s"]
    shapes = {"min_plus_matmul": [_time_shape(
                  "evaldg_dist step", "min_plus",
                  lambda: min_plus_matmul(d[None, :], W, init=d[None, :]),
                  lambda: min_plus_matmul_ref(d[None, :], W, d[None, :]),
                  None, 1, B, B, dpx, former=(d[None, :], W, d[None, :], 20),
                  floor=True)]}
    fixpoints = {"or_and_fixpoint": _evaldg_timed(
                     "evaldg_reach", D, src, tgt, ans),
                 "min_plus_settle": _settle_timed(W, srcd, tgtd, ans_d),
                 "min_plus_settle_lists": _settle_lists_timed(
                     Wl, W, srcd, tgtd, ans_d)}
    del D, W, Wl
    torch.cuda.empty_cache()
    # the or-and fixpoint kernel: its launches are the one-shot run's (one
    # for each Reach); no one PyTorch call computes a fixpoint, so no
    # library time
    fx = fixpoints["or_and_fixpoint"]
    out["kernels"].append(
        {"name": "or_and_fixpoint", "route": "cuda",
         "source": "src/repro_torch/kernels/bool_matmul/csrc/"
                   "or_and_skinny.cu",
         "replaces": "src/repro/kernels/bool_matmul/bool_matmul.py:42",
         "launches": launches["or_and_fixpoint"], "launches_path": "oneshot",
         "max_abs_err": fx["max_abs_err"], "ms": fx["ms"],
         "plain_ms": fx["plain_ms"], "bound_ms": fx["bound_ms"],
         "bound_by": fx["bound_by"], "library_ms": None,
         "shape": fx["shape"] + f", {fx['steps']} steps", "fixpoint": fx,
         **out["build"]["or_and_skinny"]})
    # the settle kernel: one launch for each one-shot Dist; ms, plain and
    # bound of the unbounded split query (the bounded one under by_kind)
    st = fixpoints["min_plus_settle"]
    out["kernels"].append(
        {"name": "min_plus_settle", "route": "cuda",
         "source": "src/repro_torch/kernels/tropical_matmul/csrc/"
                   "min_plus_matmul.cu",
         "replaces": "src/repro/kernels/tropical_matmul/"
                     "tropical_matmul.py:51",
         "launches": launches["min_plus_settle"], "launches_path": "oneshot",
         "max_abs_err": st["max_abs_err"], "ms": st["ms"],
         "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
         "bound_by": st["bound_by"], "library_ms": None,
         "shape": st["shape"] + f", {st['dist']['rows']} rows read",
         "by_kind": {k: st[k] for k in ("dist", "bounded")},
         "blocks": st["blocks"]})
    # the settle kernel on W's row lists: one launch for each one-shot
    # Dist; ms, plain and bound of the unbounded split query
    st = fixpoints["min_plus_settle_lists"]
    out["kernels"].append(
        {"name": "min_plus_settle_lists", "route": "cuda",
         "source": "src/repro_torch/kernels/tropical_matmul/csrc/"
                   "min_plus_matmul.cu",
         "replaces": None,
         "launches": launches["min_plus_settle_lists"],
         "launches_path": "oneshot", "max_abs_err": st["max_abs_err"],
         "ms": st["ms"], "plain_ms": st["plain_ms"],
         "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
         "library_ms": None,
         "shape": st["shape"] + f", {st['dist']['rows']} rows read",
         "by_kind": {k: st[k] for k in ("dist", "bounded")},
         "blocks": st["blocks"]})
    # the localEval kernel: one launch for each one-shot Reach and Dist
    # (asserted on each path); it replaces no TPU kernel (the JAX package's
    # localEval is jnp gather and scatter), and no one PyTorch call
    # computes it, so no library time
    out["kernels"].append(
        {"name": "local_eval", "route": "cuda",
         "source": "src/repro_torch/kernels/local_eval/csrc/local_eval.cu",
         "replaces": None, "launches": launches["local_eval"],
         "launches_path": "oneshot", "max_abs_err": 0.0,
         "ms": local["dist"]["ms"], "plain_ms": local["dist"]["plain_ms"],
         "bound_ms": local["dist"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "shape": local["shape"] + ", W exact",
         "by_kind": {k: v for k, v in local.items() if k != "shape"},
         **out["build"]["local_eval"]})
    out["oneshot"] = {"run_ms": run_ms, "launches": launches,
                      "rpq_ms": rpq_ms, "rpq_launches": rpq_launches,
                      "split": split, "sharded": sharded, "shapes": shapes,
                      "fixpoints": fixpoints, "rpq_pairs": rpq_pairs,
                      "rpq_answers": [r.answer for r in rpq_results]}


# ---------------------------------------------------------------------------
# 6. graph deltas on a warm amortized session at full size
# ---------------------------------------------------------------------------

RESERVE = dict(reserve_boundary=64, reserve_edges=256, reserve_stubs=64)
N_DYNAMIC = 256


def _dynamic_stream(fr, rng):
    """(label, delta) pairs that walk through every mode of ``apply``:
    32 inserts inside one fragment (repair); 8 cross inserts onto nodes
    that are not boundary nodes yet, out of one fragment and into the two
    that hold the most such nodes (repair with new boundary nodes); one insert in each of 3/4 of the fragments
    (recompute); 16 deletions (recompute); and more inserts into one
    fragment than its edge reserve holds (rebuild)."""
    from repro_torch import GraphDelta
    part = fr.part
    members = [np.nonzero(part == f)[0] for f in range(fr.k)]
    pick = lambda xs: int(rng.choice(xs))
    f = int(rng.integers(fr.k))
    yield "intra", GraphDelta.insert(
        [(pick(members[f]), pick(members[f])) for _ in range(32)])
    fresh = np.nonzero(fr.b_index < 0)[0]
    hosts = np.argsort(-np.bincount(part[fresh], minlength=fr.k),
                       kind="stable")[:2]
    targets = fresh[np.isin(part[fresh], hosts)]
    targets = rng.choice(targets, size=min(8, len(targets)), replace=False)
    f = int(rng.choice(np.setdiff1d(np.arange(fr.k), hosts)))
    yield "cross", GraphDelta.insert(
        [(pick(members[f]), int(w)) for w in targets])
    yield "wide", GraphDelta.insert(
        [(pick(members[f]), pick(members[f]))
         for f in rng.choice(fr.k, size=3 * fr.k // 4, replace=False)])
    e = rng.choice(fr.g.m, size=16, replace=False)
    yield "delete", GraphDelta.delete(
        [(int(fr.g.src[i]), int(fr.g.dst[i])) for i in e])
    f = int(np.argmax(fr.n_edges))
    yield "overflow", GraphDelta.insert(
        [(pick(members[f]), pick(members[f]))
         for _ in range(fr.e_max - int(fr.n_edges[f]) + 1)])


class _RankUpdateProbe:
    """Wraps ``incremental._rank_update_bool`` / ``_tropical`` to keep the
    operands of their first call (the shapes the repair gives the
    kernels), without launching anything itself."""

    def __init__(self, inc):
        self.inc, self.args = inc, {}
        self.orig = (inc._rank_update_bool, inc._rank_update_tropical)

    def __enter__(self):
        def keep(name, fn):
            def wrapped(*args):
                self.args.setdefault(name, args)
                return fn(*args)
            return wrapped
        self.inc._rank_update_bool = keep("bool", self.orig[0])
        self.inc._rank_update_tropical = keep("tropical", self.orig[1])
        return self

    def __exit__(self, *exc):
        self.inc._rank_update_bool, self.inc._rank_update_tropical = self.orig


def _p_stage(args) -> tuple:
    """The operands of the rank update's last product as the repair makes
    them from the arguments it was given (C, Ct, rows, idx): T and T^T in
    one launch, the r x r closure M* and its K-major copy, ``C[:, R]``
    copied K-major (``Ck``) and ``left = C[:, R] (x) M*``."""
    import torch
    from repro_torch.core import bes
    from repro_torch.kernels.bool_matmul import kmajor_copy, or_and_matmul_nt
    C, Ct, rows, idx = args
    idx = torch.as_tensor(idx, dtype=torch.long, device=C.device)
    T, Tt = or_and_matmul_nt(rows, Ct, with_transpose=True)
    Mc, Mct = bes.bool_closure_kmajor(T[:, idx])
    Ck = kmajor_copy(Ct[idx].T)
    left = or_and_matmul_nt(Ck, Mct)
    return T, Tt, Mc, Mct, Ck, left


P_FLOOR_TURNS = 2


def _time_p_floor(name, C, Ct, left, Tt) -> dict:
    """The rank update's last product with its floor pair, on the operands
    the repair gave it: the floor-pair launch (C | P and C^T | P^T) against
    the old composition (the tile route writing P and P^T, then an OR into
    fresh padded storage for each closure), the two in turns (new, old,
    old, new), each bit-equal to the plain version; the tile route's P and
    P^T alone; and cuBLAS fp16, ``((left_h @ T_h) > 0) | C``, which writes
    no C'^T.  The bound reads the floor pair at its logical width and
    writes both outputs to their row pitch."""
    import torch
    from repro_torch.kernels.bool_matmul import (or_and_floor_pair,
                                                 or_and_floor_pair_ref,
                                                 or_and_matmul_nt,
                                                 padded_zeros)
    m, k = left.shape
    n = Tt.shape[0]

    def fused():
        return or_and_floor_pair(left, Tt, C, Ct)

    def old():
        P, Pt = or_and_matmul_nt(left, Tt, with_transpose=True)
        return (torch.bitwise_or(C, P, out=padded_zeros(m, n, C.device)),
                torch.bitwise_or(Ct, Pt, out=padded_zeros(n, m, C.device)))

    plain_ms, want = cuda_timed(
        lambda: or_and_floor_pair_ref(left, Tt, C, Ct), 1,
        warmup=False)
    for what, fn in (("", fused), (" old composition", old)):
        got = fn()
        _check_equal(name + what, got[0], want[0])
        _check_equal(name + what + " C^T", got[1], want[1])
        if what == "" and (_padded_storage(got[0])[:, n:].any()
                           or _padded_storage(got[1])[:, m:].any()):
            raise AssertionError(f"{name}: pad bytes set")
        del got
    turns = []                            # (new ms, old ms), in turns
    for i in range(P_FLOOR_TURNS):
        order = (fused, old) if i % 2 == 0 else (old, fused)
        first, second = (cuda_timed(f, 10)[0] for f in order)
        turns.append((first, second) if i % 2 == 0 else (second, first))
    ms = statistics.mean(t[0] for t in turns)
    old_ms = statistics.mean(t[1] for t in turns)
    product_ms = cuda_timed(
        lambda: or_and_matmul_nt(left, Tt, with_transpose=True), 10)[0]
    left_h, T_h = left.half(), Tt.T.half()
    lib_ms, got = cuda_timed(lambda: ((left_h @ T_h) > 0) | C, 3)
    _check_equal(name + " cuBLAS", got, want[0])
    del got, want, left_h, T_h
    bound_ms, by = _mm_bound(m, k, n, "or_and", None, floor=True)
    print(f"time {name} [{m},{k}]x[{k},{n}] with the floor pair: {ms:.4f} ms "
          f"(bound {bound_ms:.4f} ms, {by}, {100 * bound_ms / ms:.1f} %); "
          f"old composition {old_ms:.4f} ms (P and P^T alone "
          f"{product_ms:.4f} ms); turns {turns}; plain {plain_ms:.3f} ms; "
          f"cuBLAS fp16 {lib_ms:.4f} ms (C' only, no C'^T)")
    return {"shape": f"[{m},{k}]x[{k},{n}], C | P and C^T | P^T",
            "path": name, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
            "library": "cuBLAS fp16 ((left_h @ T_h) > 0) | C, no C'^T",
            "max_abs_err": 0.0, "old_composition_ms": old_ms,
            "product_ms": product_ms, "turns_ms": turns}


def _rank_update_shapes(args: dict, dpx_per_s) -> dict:
    """The or-and and min-plus products of the rank-style update, each on
    the operands the repair gave it: T = rows (x) C [r, nb] x [nb, nb]
    (or-and writing T and T^T); left = C[:, R] (x) M* [nb, r] x [r, r];
    P = left (x) T [nb, r] x [r, nb] with the floor (or-and: the floor
    pair, ``_time_p_floor``)."""
    import torch
    from repro_torch.core import bes
    from repro_torch.kernels.bool_matmul import (or_and_matmul_nt,
                                                 or_and_matmul_ref)
    from repro_torch.kernels.tropical_matmul import (min_plus_matmul,
                                                     min_plus_matmul_ref)
    C, Ct, rows, idx = args["bool"]
    r, nb = rows.shape
    T, Tt, Mc, Mct, Ck, left = _p_stage(args["bool"])
    half = lambda a: a.half()
    rows_h, C_h, Ck_h, Mc_h = map(half, (rows, C, Ck, Mc))
    b1 = [_time_shape("rank update T", "or_and",
                      lambda: or_and_matmul_nt(rows, Ct, with_transpose=True),
                      lambda: or_and_matmul_ref(rows, C),
                      lambda: (rows_h @ C_h) > 0, r, nb, nb, dpx_per_s,
                      transpose=True),
          _time_shape("rank update left", "or_and",
                      lambda: or_and_matmul_nt(Ck, Mct),
                      lambda: or_and_matmul_ref(Ck, Mc),
                      lambda: (Ck_h @ Mc_h) > 0, nb, r, r, dpx_per_s)]
    del rows_h, C_h, Ck_h, Mc_h
    b1.append(_time_p_floor("rank update P with floor", C, Ct, left, Tt))
    del T, Tt, Mc, Mct, Ck, left
    from repro_torch.kernels.tropical_matmul import ops as tops
    Cd, rows_d, idx_d = args["tropical"]
    idx_d = torch.as_tensor(idx_d, dtype=torch.long, device=Cd.device)
    Td = min_plus_matmul(rows_d, Cd)
    Mcd = bes.tropical_closure(Td[:, idx_d])
    Cdr = torch.index_select(Cd, 1, idx_d,
                             out=tops.padded_i32(nb, r, Cd.device))
    left_d = min_plus_matmul(Cdr, Mcd)
    copies = _copies()
    b2 = [_time_shape("rank update T", "min_plus",
                      lambda: min_plus_matmul(rows_d, Cd),
                      lambda: min_plus_matmul_ref(rows_d, Cd), None,
                      r, nb, nb, dpx_per_s, former=(rows_d, Cd)),
          _time_shape("rank update left", "min_plus",
                      lambda: min_plus_matmul(Cdr, Mcd),
                      lambda: min_plus_matmul_ref(Cdr, Mcd), None,
                      nb, r, r, dpx_per_s, former=(Cdr, Mcd, None, 20)),
          # the last product takes C as its floor, as the repair calls it
          _time_shape("rank update P", "min_plus",
                      lambda: min_plus_matmul(left_d, Td, init=Cd),
                      lambda: min_plus_matmul_ref(left_d, Td, Cd), None,
                      nb, r, nb, dpx_per_s, former=(left_d, Td, Cd),
                      floor=True)]
    if _copies() != copies:
        raise AssertionError("the rank-update timings copied an operand")
    return {"or_and_matmul": b1, "min_plus_matmul": b2}


CACHE_TENSORS = ("bl_frontier", "closure", "closure_t", "bl_dist",
                 "dist_closure")


def _cache_state(cache) -> dict:
    """The cache's tensors (the objects) and clones of their contents."""
    return {n: (getattr(cache, n), getattr(cache, n).clone())
            for n in CACHE_TENSORS}


def phase_dynamic(out: dict, g):
    """Graph deltas at full size through ``session.apply`` on a warm
    amortized session: every mode, each delta checked by 256 mixed queries
    against the host BFS on the updated graph and against a session on a
    freshly built fragmentation; one delta made to fail mid-repair, after
    which versions, tensors and answers are unchanged.  Returns the
    fragmentation and its session, warm, for the serve phase."""
    import torch
    import repro_torch
    from repro_torch import DeltaApplyFailed, GraphDelta
    from repro_torch.core import incremental
    from repro_torch.core.fragments import fragment_graph
    from repro_torch.graph import random_partition

    part = random_partition(g, N_FRAGS, seed=SEED)
    fr = fragment_graph(g, part, N_FRAGS, **RESERVE)
    sess = repro_torch.connect(fr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.warm(with_dist=True)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(SEED + 3)
    print(f"dynamic: n={g.n} k={fr.k} nb={fr.n_boundary} (active "
          f"{fr.nb_active}) n_max={fr.n_max} e_max={fr.e_max} "
          f"s_max={fr.s_max}, reserves {RESERVE}; warm {warm_ms:.1f} ms")

    def check(label, fr=fr, sess=sess):
        queries = _mixed_queries(fr.g.n, rng, N_DYNAMIC)
        results = sess.run(queries)
        _check_reach_dist(fr.g, queries, results, f"dynamic {label}")
        fresh = fragment_graph(fr.g, fr.part, fr.k, **RESERVE)
        want = repro_torch.connect(fresh).run(queries)
        if [(r.answer, r.distance) for r in results] != \
                [(r.answer, r.distance) for r in want]:
            raise AssertionError(f"dynamic {label}: the maintained session "
                                 "disagrees with a freshly built one")
        del fresh, want
        return queries, results

    applies = []
    launches_by_mode = {}

    def timed_apply(label, delta, sess=sess):
        """One ``apply`` with the launch counts set to 0 just before it
        and read just after, and its host-clock time."""
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        stats = sess.apply(delta)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _launches()
        _assert_no_copies(f"dynamic {label} delta")
        if stats.mode == "repair":
            # B1's layout copies in a repair: the r x r closure's two and
            # C[:, R] (rows_new is gathered padded, T^T comes from T's
            # launch); its P stage is one floor-pair launch, C | P and
            # C^T | P^T with no OR pass after it
            want_b1 = (3, 1) if stats.changed_rows else (0, 0)
            got_b1 = (launches["or_and_copies"], launches["or_and_floor"])
            if got_b1 != want_b1:
                raise AssertionError(f"dynamic {label} delta: B1 copies and "
                                     f"floor-pair launches {got_b1}, "
                                     f"expected {want_b1}")
        applies.append({"delta": label, "mode": stats.mode, "ms": ms,
                        "changed_rows": stats.changed_rows,
                        "new_boundary": stats.new_boundary,
                        "dirty_fragments": stats.dirty_fragments,
                        "n_add": delta.n_add, "n_del": delta.n_del,
                        "launches": launches, "reason": stats.reason})
        mode = launches_by_mode.setdefault(stats.mode, {})
        for name, n in launches.items():
            mode[name] = mode.get(name, 0) + n
        print(f"dynamic: {label} delta (+{delta.n_add} -{delta.n_del}) -> "
              f"{stats.mode} in {ms:.1f} ms; changed rows "
              f"{stats.changed_rows}, new boundary {stats.new_boundary}, "
              f"dirty {stats.dirty_fragments}; launches {launches}")
        return stats

    check("warm")
    # an empty delta is a strict no-op: the same tensors, the same versions
    held = {n: getattr(fr.rvset_cache, n) for n in CACHE_TENSORS}
    versions = (fr.arrays_version, sess.cache_version)
    timed_apply("empty", GraphDelta())
    if (fr.arrays_version, sess.cache_version) != versions or any(
            getattr(fr.rvset_cache, n) is not t for n, t in held.items()):
        raise AssertionError("the empty delta changed the cache")
    del held
    probe = _RankUpdateProbe(incremental)
    for label, delta in _dynamic_stream(fr, rng):
        with probe:
            timed_apply(label, delta)
        check(label)
        print(f"dynamic: {N_DYNAMIC} answers after the {label} delta match "
              "BFS and a fresh session")
        torch.cuda.empty_cache()
    applies_stream = applies[1:]
    want = ["repair", "repair", "recompute", "recompute", "rebuild"]
    if [a["mode"] for a in applies_stream] != want:
        raise AssertionError(f"modes {[a['mode'] for a in applies_stream]}"
                             f", expected {want}")
    if not applies_stream[1]["new_boundary"]:
        raise AssertionError("the cross delta activated no boundary node")
    for name in ("or_and_matmul", "min_plus_matmul"):
        if any(launches_by_mode[m][name] == 0
               for m in ("recompute", "rebuild")):
            raise AssertionError(f"{name} not launched by every mode")

    # one delta made to fail inside the repair, after the frontiers and
    # the distance closure were rebound (the repair updates it before the
    # Boolean closure): everything rolls back
    queries, before = check("before the failed delta")
    versions = (fr.arrays_version, sess.cache_version)
    held = _cache_state(fr.rvset_cache)
    f = int(rng.integers(fr.k))
    mine = np.nonzero(fr.part == f)[0]
    delta = GraphDelta.insert([(int(rng.choice(mine)), int(rng.choice(mine)))
                               for _ in range(32)])

    def broken(*args):
        raise RuntimeError("injected failure in the Boolean rank update")

    orig = incremental._rank_update_bool
    incremental._rank_update_bool = broken
    t0 = time.perf_counter()
    try:
        sess.apply(delta)
        raise AssertionError("the failing delta did not raise")
    except DeltaApplyFailed:
        pass
    finally:
        incremental._rank_update_bool = orig
    rollback_ms = (time.perf_counter() - t0) * 1e3
    if (fr.arrays_version, sess.cache_version) != versions:
        raise AssertionError("the failed delta moved a version")
    for name, (obj, copy) in held.items():
        if getattr(fr.rvset_cache, name) is not obj or not torch.equal(obj,
                                                                        copy):
            raise AssertionError(f"the failed delta changed {name}")
    after = sess.run(queries)
    if [(r.answer, r.distance) for r in after] != \
            [(r.answer, r.distance) for r in before]:
        raise AssertionError("answers changed after the failed delta")
    del held
    print(f"dynamic: a delta failing inside the repair rolled back in "
          f"{rollback_ms:.1f} ms (rollbacks {sess.stats.rollbacks}): "
          f"arrays_version and cache_version {versions}, every cache tensor "
          f"and {len(queries)} answers unchanged")

    # a delta on a fragmentation with no cache yet changes host structures
    # only; the session then builds its caches on the updated graph
    bare = fragment_graph(g, part, N_FRAGS, **RESERVE)
    bare_sess = repro_torch.connect(bare)
    timed_apply("uncached", GraphDelta.insert(
        rng.integers(0, g.n, size=(8, 2))), sess=bare_sess)
    if bare.rvset_cache is not None:
        raise AssertionError("a structural delta built a cache")
    check("structural", fr=bare, sess=bare_sess)
    del bare, bare_sess
    modes = {a["mode"] for a in applies}
    if modes != {"noop", "structural", "repair", "recompute", "rebuild"}:
        raise AssertionError(f"the deltas reached the modes {modes}")

    shapes = _rank_update_shapes(probe.args, out["kernels"][1]["dpx_ops_per_s"])
    torch.cuda.empty_cache()
    # the floor-pair kernel: its launches are the repairs' (one a rank
    # update), its times the P stage's on the first repair's operands
    p = next(e for e in shapes["or_and_matmul"]
             if e["path"] == "rank update P with floor")
    n_floor = launches_by_mode["repair"]["or_and_floor"]
    if n_floor == 0:
        raise AssertionError("no repair launched the floor-pair kernel")
    out["kernels"].append(
        {"name": "or_and_floor", "route": "cuda",
         "source": "src/repro_torch/kernels/bool_matmul/csrc/or_and_matmul.cu",
         "replaces": "src/repro/kernels/bool_matmul/bool_matmul.py:42",
         "launches": n_floor, "launches_path": "dynamic repair",
         **{key: p[key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "library", "shape", "old_composition_ms",
             "product_ms", "turns_ms")}})
    out["dynamic"] = {"warm_ms": warm_ms, "applies": applies,
                      "launches_by_mode": launches_by_mode,
                      "rollback_ms": rollback_ms, "shapes": shapes}
    return fr, sess


# ---------------------------------------------------------------------------
# 7. the serving stack on the dynamic phase's fragmentation
# ---------------------------------------------------------------------------

N_SERVE_BARRIER = 1024
N_SERVE_MVCC = 2048
N_SERVE_CHAOS = 192
SERVE_BATCH = 64
SERVE_BOUND = 6
SERVE_SOURCES = 128      # requests draw their sources from this many nodes


def _serve_requests(srv, g, rng, count, sources):
    """Submit ``count`` mixed requests (reach, dist, bounded at
    SERVE_BOUND, in turn); sources from ``sources``, targets anywhere."""
    futs = []
    for i in range(count):
        s, t = int(rng.choice(sources)), int(rng.integers(g.n))
        kind = ("reach", "dist", "bounded")[i % 3]
        futs.append(srv.submit(s, t, kind=kind,
                               bound=SERVE_BOUND if kind == "bounded"
                               else None))
    return futs


def _check_served(graphs: dict, futs, what: str) -> None:
    """Every future DONE, and its answer equal to the host BFS on the graph
    of the version its ``cache_version`` names."""
    by_version = {}
    for f in futs:
        if f.status != "done":
            raise AssertionError(f"{what}: {f!r} ended {f.status}: "
                                 f"{f.error!r}")
        by_version.setdefault(f.cache_version, []).append(f)
    for version, group in by_version.items():
        if version not in graphs:
            raise AssertionError(f"{what}: answers stamped with version "
                                 f"{version}, which no delta published")
        table = _bfs_distances(graphs[version], [f.s for f in group])
        for f in group:
            d = int(table[f.s][f.t])
            want = {"reach": d >= 0, "dist": d if d >= 0 else None,
                    "bounded": 0 <= d <= SERVE_BOUND}[f.kind]
            if f.value != want:
                raise AssertionError(f"{what}: {f.kind} {f.s}->{f.t} at "
                                     f"version {version}: got {f.value}, "
                                     f"BFS {want}")


def _with_edges(g, delta):
    """The graph after an insert-only delta."""
    from repro_torch.graph import Graph
    return Graph(g.n, np.concatenate([g.src, delta.add_src]),
                 np.concatenate([g.dst, delta.add_dst]), g.labels,
                 g.label_names)


def _intra_delta(fr, rng, count=32):
    """``count`` inserts inside one fragment: a repair."""
    from repro_torch import GraphDelta
    f = int(rng.integers(fr.k))
    mine = np.nonzero(fr.part == f)[0]
    return GraphDelta.insert([(int(rng.choice(mine)), int(rng.choice(mine)))
                              for _ in range(count)])


def _wide_delta(fr, rng):
    """One insert in each of 3/4 of the fragments: a recompute."""
    from repro_torch import GraphDelta
    edges = []
    for f in rng.choice(fr.k, size=3 * fr.k // 4, replace=False):
        mine = np.nonzero(fr.part == f)[0]
        edges.append((int(rng.choice(mine)), int(rng.choice(mine))))
    return GraphDelta.insert(edges)


def _assert_clean(srv, what: str) -> None:
    """No retry, no dead letter, no degraded group: nothing fell back."""
    if srv.retries or srv.dead_letters or srv.session.stats.degraded_groups:
        raise AssertionError(
            f"{what}: retries {srv.retries}, dead letters "
            f"{len(srv.dead_letters)}, degraded groups "
            f"{srv.session.stats.degraded_groups}")


def _serve_mvcc_run(fr, sess, rng, sources, label: str,
                    paced: bool) -> dict:
    """One threaded MVCC run of the serve phase: a client thread submits
    N_SERVE_MVCC requests (all at once, or ``paced``: one batch, wait for
    it, 10 ms of think time) while this thread submits 4 deltas, each at
    a fifth of the client's progress, and waits for each commit point.
    Every answer is checked against the BFS of its version's graph."""
    import threading
    import torch
    from repro_torch.serve import QueryServer
    from repro_torch.serve.telemetry import percentile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _reset_launches()
    srv = QueryServer(fr, session=sess, batch_size=SERVE_BATCH, mvcc=True,
                      versions=4, start=True)
    graphs = {sess.cache_version: fr.g}
    futs, client_error = [], []
    progress = threading.Semaphore(0)        # one release per batch done
    crng = np.random.default_rng(SEED + 6)

    def client():
        try:
            for _ in range(N_SERVE_MVCC // SERVE_BATCH):
                mine = _serve_requests(srv, fr.g, crng, SERVE_BATCH, sources)
                futs.extend(mine)
                if paced:
                    for f in mine:
                        f.result(timeout=600)
                    time.sleep(0.010)
                progress.release()
        except BaseException as exc:      # reported by the main thread
            client_error.append(exc)
            for _ in range(N_SERVE_MVCC // SERVE_BATCH):
                progress.release()

    # the recompute last when paced, so that its 1.5 s overlap reads
    modes = ["repair", "repair", "recompute", "repair"]
    if paced:
        modes = ["repair", "repair", "repair", "recompute"]
    deltas = [(m, _wide_delta(fr, rng) if m == "recompute"
               else _intra_delta(fr, rng)) for m in modes]
    batches = N_SERVE_MVCC // SERVE_BATCH
    t0 = time.perf_counter()
    th = threading.Thread(target=client, name="serve-client")
    th.start()
    updates, done = [], 0
    for i, (want, delta) in enumerate(deltas):
        while done < (i + 1) * batches // 5:
            progress.acquire(timeout=600)
            done += 1
        upd = srv.submit_delta(delta)
        stats = upd.result(timeout=600)           # the commit point
        head = srv.store.head()
        graphs[head.cache_version] = head.fr.g
        updates.append((want, stats.mode, upd))
    th.join(timeout=600)
    if th.is_alive() or client_error:
        raise AssertionError(f"serve mvcc {label}: the client failed: "
                             f"{client_error}")
    srv.flush()
    telemetry = srv.telemetry()
    srv.close()
    torch.cuda.synchronize()                 # nothing failed on the card
    wall_s = time.perf_counter() - t0
    launches = _launches()
    _assert_no_copies(f"serve mvcc {label}")
    peak = torch.cuda.max_memory_allocated()
    _assert_clean(srv, f"serve mvcc {label}")
    batches = srv.batches_run
    # the store's last versions become garbage with the server; their
    # fr <-> cache cycles go at the next collection
    del srv, client, th
    gc.collect()
    after_mem = torch.cuda.memory_allocated()
    if [m for _, m, _ in updates] != modes:
        raise AssertionError(f"serve mvcc {label}: modes "
                             f"{[m for _, m, _ in updates]}, expected "
                             f"{modes}")
    _check_served(graphs, futs, f"serve mvcc {label}")
    for name in ("or_and_matmul", "min_plus_matmul"):
        if not launches[name]:
            raise AssertionError(f"serve mvcc {label}: {name} not "
                                 "launched")
    seen = sorted({f.cache_version for f in futs})
    if paced and len(seen) < 2:     # a burst may all be served before
        raise AssertionError(f"serve mvcc {label}: every read saw one "
                             "version")
    # each read by the deltas it overlapped: any, the recompute's, none
    spans = [(m, u.submitted_at, u.resolved_at) for _, m, u in updates]
    overlap, beside_recompute, alone = [], [], []
    for f in futs:
        hits = {m for m, a, b in spans
                if f.submitted_at < b and f.resolved_at > a}
        (overlap if hits else alone).append(f.latency_s * 1e3)
        if "recompute" in hits:
            beside_recompute.append(f.latency_s * 1e3)
    run = {
        "requests": len(futs), "paced": paced, "wall_s": wall_s,
        "qps": len(futs) / wall_s, "telemetry_qps": telemetry["qps"],
        "routes": telemetry["routes"],
        "batch_occupancy": telemetry["batch_occupancy"],
        "batches": batches, "mvcc": telemetry["mvcc"],
        "updates": [{"mode": m, "ms": (u.resolved_at - u.submitted_at) * 1e3}
                    for _, m, u in updates],
        "versions_seen": seen, "peak_bytes": peak, "base_bytes": base_mem,
        "after_close_bytes": after_mem,
        "overlap_reads": len(overlap), "alone_reads": len(alone),
        "recompute_reads": len(beside_recompute),
        "p50_recompute_ms": percentile(beside_recompute, 0.50),
        "p99_recompute_ms": percentile(beside_recompute, 0.99),
        "p50_overlap_ms": percentile(overlap, 0.50),
        "p99_overlap_ms": percentile(overlap, 0.99),
        "p50_alone_ms": percentile(alone, 0.50),
        "p99_alone_ms": percentile(alone, 0.99),
        "launches": launches}
    print(f"serve: mvcc {label}: {len(futs)} requests beside 4 deltas in "
          f"{wall_s * 1e3:.1f} ms, {run['qps']:.1f} qps (telemetry window "
          f"{telemetry['qps']:.1f}); batch occupancy "
          f"{telemetry['batch_occupancy']:.3f} over {batches} "
          f"batches; versions seen {seen}; deltas "
          + ", ".join(f"{d['mode']} {d['ms']:.1f} ms"
                      for d in run["updates"]))
    for route, r in sorted(telemetry["routes"].items()):
        print(f"serve: mvcc {label} {route}: {r['count']} requests, p50 "
              f"{r['p50_ms']:.3f} ms, p95 {r['p95_ms']:.3f} ms, p99 "
              f"{r['p99_ms']:.3f} ms")
    print(f"serve: mvcc {label}: reads overlapping a repair: "
          f"{len(overlap)}, p50 {run['p50_overlap_ms']:.3f} ms, p99 "
          f"{run['p99_overlap_ms']:.3f} ms; the others: {len(alone)}, p50 "
          f"{run['p50_alone_ms']:.3f} ms, p99 {run['p99_alone_ms']:.3f} ms; "
          f"beside the recompute: {len(beside_recompute)}, p50 "
          f"{run['p50_recompute_ms']:.3f} ms, p99 "
          f"{run['p99_recompute_ms']:.3f} ms (host clock; reads and "
          f"repairs share the default stream)")
    print(f"serve: mvcc {label}: gauges {telemetry['mvcc']}; device memory "
          f"peak {peak / 2**30:.3f} GiB (at the start "
          f"{base_mem / 2**30:.3f} GiB, after the server closed "
          f"{after_mem / 2**30:.3f} GiB); launches {launches}")
    return run


def _stream_probe(fr, sess, rng, sources) -> dict:
    """Why a read beside a recompute waits: one batch of SERVE_BATCH mixed
    queries timed alone, then while another thread squares the distance
    closure over and over (the recompute's kernel, 1 launch then 1 host
    sync, as ``bes.tropical_closure`` does) on the default stream, then on
    a side stream of its own.  Host clock: the median of 3 batches alone,
    one batch beside the squarings (each takes seconds on the default
    stream)."""
    import threading
    import torch
    from repro_torch import Dist, Reach
    from repro_torch.kernels.tropical_matmul import min_plus_matmul
    W = fr.rvset_cache.dist_closure
    pairs = [(int(rng.choice(sources)), int(rng.integers(fr.g.n)))
             for _ in range(SERVE_BATCH)]
    queries = [Reach(s, t) if i % 3 == 0 else
               Dist(s, t, bound=SERVE_BOUND if i % 3 == 2 else None)
               for i, (s, t) in enumerate(pairs)]

    def batches(n=3):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            sess.run(queries)                  # ends in a host copy
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    batches(1)                                 # warm
    out = {"alone_ms": batches()}
    for where in ("default", "side"):
        stop, started, squarings = threading.Event(), threading.Event(), []

        def squarer():
            stream = (torch.cuda.current_stream() if where == "default"
                      else torch.cuda.Stream())
            with torch.cuda.stream(stream):
                while not stop.is_set():
                    W2 = min_plus_matmul(W, W)
                    torch.equal(W2, W)         # the closure's host sync
                    squarings.append(1)
                    started.set()

        th = threading.Thread(target=squarer, name=f"squarer-{where}")
        th.start()
        started.wait(60)
        out[f"beside_{where}_ms"] = batches(1)
        stop.set()
        th.join(60)
        out[f"squarings_{where}"] = len(squarings)
    torch.cuda.synchronize()
    print(f"serve: stream probe: a batch of {SERVE_BATCH} queries alone "
          f"{out['alone_ms']:.1f} ms; beside a thread squaring the "
          f"distance closure on the default stream "
          f"{out['beside_default_ms']:.1f} ms, on a side stream "
          f"{out['beside_side_ms']:.1f} ms (host clock; alone the median "
          f"of 3 batches)")
    return out


def phase_serve(out: dict, fr, sess) -> None:
    """``repro_torch.QueryServer`` over the dynamic phase's warm session:
    a deterministic barrier flush with two repair deltas, two threaded
    MVCC runs with four deltas beside 2048 reads each, then chaos on the
    card."""
    import torch
    from repro_torch.serve import (FaultInjector, FaultSpec, InjectedFault,
                                   QueryServer, RetryPolicy)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 5)
    sources = rng.choice(fr.g.n, size=SERVE_SOURCES, replace=False)
    print(f"serve: {out['card']}; nb={fr.n_boundary} (active "
          f"{fr.nb_active}), warm reach + dist cache, batch {SERVE_BATCH}")

    # 1. barrier mode, deterministic: 1024 requests and 2 repair deltas
    srv = QueryServer(fr, session=sess, batch_size=SERVE_BATCH, start=False)
    graphs = {sess.cache_version: fr.g}
    g = fr.g
    futs, updates = [], []
    for part in range(3):
        futs += _serve_requests(srv, fr.g, rng, N_SERVE_BARRIER // 3
                                + (part == 2) * (N_SERVE_BARRIER % 3),
                                sources)
        if part < 2:
            delta = _intra_delta(fr, rng)
            updates.append(srv.submit_delta(delta))
            g = _with_edges(g, delta)
            graphs[max(graphs) + 1] = g
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    srv.flush()
    torch.cuda.synchronize()
    barrier_ms = (time.perf_counter() - t0) * 1e3
    barrier_launches = _launches()
    _assert_no_copies("serve barrier")
    srv.close()
    if [(u.status, u.value.mode) for u in updates] != \
            [("applied", "repair")] * 2:
        raise AssertionError(f"serve barrier: deltas ended "
                             f"{[(u.status, u.value) for u in updates]}")
    _check_served(graphs, futs, "serve barrier")
    _assert_clean(srv, "serve barrier")
    for name in ("or_and_matmul", "min_plus_matmul"):
        if not barrier_launches[name]:
            raise AssertionError(f"serve barrier: {name} not launched")
    barrier_tele = srv.telemetry()
    print(f"serve: barrier flush of {len(futs)} requests and 2 repair "
          f"deltas in {barrier_ms:.1f} ms ({srv.batches_run} batches), "
          f"every answer equal to the BFS of its version; launches "
          f"{barrier_launches}")

    # 2. MVCC mode, threaded: a client thread submits 2048 requests while
    # this thread commits 3 repairs and 1 recompute as versions; once as
    # a burst (every request at once: throughput under a backlog), once
    # paced (one batch in flight, then 10 ms of think time: the latency of
    # reads beside a repair against the others')
    serve_mvcc = {}
    for label, paced in (("burst", False), ("paced", True)):
        serve_mvcc[label] = _serve_mvcc_run(fr, sess, rng, sources, label,
                                            paced)
    torch.cuda.empty_cache()
    probe = _stream_probe(fr, sess, rng, sources)

    # 3. chaos on the card
    chaos_out = {}
    # (a) transient engine.vmap faults: the retries succeed
    chaos = FaultInjector(seed=SEED, rates={
        "engine.vmap": FaultSpec(rate=1.0, max_failures=2)})
    srv = QueryServer(fr, session=sess, batch_size=SERVE_BATCH, start=False,
                      chaos=chaos, retry=RetryPolicy(base_delay_ms=0.0))
    futs = _serve_requests(srv, fr.g, rng, N_SERVE_CHAOS, sources)
    srv.flush()
    _check_served({sess.cache_version: fr.g}, futs, "serve chaos retry")
    if srv.retries != 2 or srv.dead_letters or futs[0].attempts != 3:
        raise AssertionError(f"serve chaos retry: retries {srv.retries}, "
                             f"dead letters {len(srv.dead_letters)}, "
                             f"attempts {futs[0].attempts}")
    chaos_out["retry"] = {"requests": len(futs), "retries": srv.retries,
                          "injected": chaos.failures["engine.vmap"]}
    # (b) one poison pair: dead-lettered alone, its batchmates served
    poison = (int(sources[0]), int(fr.g.n - 1))
    srv.session.chaos = FaultInjector(seed=SEED, poison=[poison])
    futs = _serve_requests(srv, fr.g, rng, SERVE_BATCH - 1, sources)
    bad = srv.submit(*poison)
    srv.flush()
    _check_served({sess.cache_version: fr.g}, futs, "serve chaos poison")
    if (bad.status != "dead_letter" or srv.dead_letters != [bad]
            or not isinstance(bad.error.cause, InjectedFault)):
        raise AssertionError(f"serve chaos poison: {bad!r} {bad.error!r}, "
                             f"dead letters {srv.dead_letters}")
    chaos_out["poison"] = {"batchmates": len(futs),
                           "attempts": bad.attempts}
    srv.close()
    # (c) a delta.repair failure under MVCC: the clone is dropped and the
    # head keeps serving the pre-delta answers
    sess.chaos = FaultInjector(seed=SEED, rates={"delta.repair": 1.0})
    srv = QueryServer(fr, session=sess, batch_size=SERVE_BATCH, mvcc=True,
                      start=False)
    v0 = sess.cache_version
    delta = _intra_delta(fr, rng)
    upd = srv.submit_delta(delta)
    srv.flush()
    futs = _serve_requests(srv, fr.g, rng, SERVE_BATCH, sources)
    srv.flush()
    _check_served({v0: fr.g}, futs, "serve chaos mvcc repair")
    gauges = srv.telemetry()["mvcc"]
    if (upd.status != "failed" or gauges["versions_dropped"] != 1
            or srv.store.head().vid != 0 or sess.cache_version != v0):
        raise AssertionError(f"serve chaos mvcc repair: {upd!r}, {gauges}")
    chaos_out["mvcc_repair"] = {"gauges": gauges}
    srv.close()
    sess.chaos = None
    # (d) engine.shard_map failing on the one-rank NCCL group: every group
    # degrades to the cached path on the card, exact and flagged
    chaos = FaultInjector(seed=SEED, rates={"engine.shard_map": 1.0})
    srv = QueryServer(fr, backend="shard_map", batch_size=SERVE_BATCH,
                      start=False, chaos=chaos)
    futs = _serve_requests(srv, fr.g, rng, N_SERVE_CHAOS, sources)
    _reset_launches()
    srv.flush()
    degraded_launches = _launches()
    _check_served({sess.cache_version: fr.g}, futs, "serve chaos degrade")
    groups = srv.session.stats.degraded_groups
    if (not all(f.degraded for f in futs) or srv.retries
            or srv.dead_letters or groups != 2 * srv.batches_run
            or srv.session.device != sess.device):
        raise AssertionError(f"serve chaos degrade: degraded groups "
                             f"{groups}, batches {srv.batches_run}")
    for name in ("or_and_matmul", "min_plus_matmul"):
        if not degraded_launches[name]:
            raise AssertionError(f"serve chaos degrade: {name} not "
                                 "launched")
    chaos_out["degrade"] = {"requests": len(futs), "degraded_groups": groups,
                            "launches": degraded_launches}
    srv.close()
    del srv
    torch.cuda.synchronize()            # nothing failed on the card
    wall_s = time.perf_counter() - t_phase
    print(f"serve: chaos on the card: 2 transient engine.vmap faults "
          f"retried ({N_SERVE_CHAOS} requests DONE), one poison pair "
          f"dead-lettered alone after {bad.attempts} attempts, a failed "
          f"MVCC repair dropped (head kept version {v0}), "
          f"{groups} sharded groups degraded to the cached path, exact")
    print(f"serve: phase wall time {wall_s:.1f} s")
    out["serve"] = {"barrier": {"requests": N_SERVE_BARRIER,
                                "ms": barrier_ms,
                                "batches": barrier_tele["batches"],
                                "routes": barrier_tele["routes"],
                                "launches": barrier_launches},
                    "mvcc": serve_mvcc, "stream_probe": probe,
                    "chaos": chaos_out,
                    "wall_s": wall_s}


# ---------------------------------------------------------------------------
# 12. regular path queries at reduced size
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


# ---------------------------------------------------------------------------
# 8. the paper's baselines at full size
# ---------------------------------------------------------------------------

N_BASELINE = 16
CHAIN_NODES = 1024


def phase_baselines(out: dict, g, fr) -> None:
    """disReach_n, disReach_m and the one-shot disReach on 16 seeded pairs
    at full size, every answer checked against the host BFS; then the
    paper's contrast on a 1024-node chain dealt round-robin over 16
    fragments: disReach_m takes more than k rounds, disReach one."""
    from repro_torch import dis_reach
    from repro_torch.core.baselines import dis_reach_m, dis_reach_n
    from repro_torch.core.fragments import fragment_graph
    from repro_torch.graph.graph import Graph

    rng = np.random.default_rng(SEED + 6)
    pairs = rng.integers(0, g.n, size=(N_BASELINE, 2))
    table = _bfs_distances(g, pairs[:, 0])
    rows = {"n": [], "m": [], "oneshot": []}
    _reset_launches()
    with _EvalDGCalls() as calls:
        for s, t in pairs.tolist():
            want = s == t or table[s][t] >= 0
            for name, fn in (("n", lambda: dis_reach_n(fr, s, t)),
                             ("m", lambda: dis_reach_m(fr, s, t)),
                             ("oneshot", lambda: dis_reach(fr, s, t))):
                ms, res = cuda_timed(fn, 1, warmup=False)
                if res.answer != want:
                    raise AssertionError(f"baselines: {name} ({s}, {t}) got "
                                         f"{res.answer}, BFS {want}")
                if name == "oneshot":           # each site visited once
                    counts = (res.stats.payload_bits, fr.k,
                              res.stats.collective_rounds)
                else:
                    counts = (res.traffic_bits, res.site_visits, res.rounds)
                rows[name].append({"ms": ms, "traffic_bits": counts[0],
                                   "site_visits": counts[1],
                                   "rounds": counts[2]})
    launches = _launches()
    # the one-shot disReach's evalDGs: disReach_n and _m run none
    _assert_one_fixpoint_each("baselines", launches, calls,
                              local=calls.reach)
    summary = {}
    for name, rs in rows.items():
        summary[name] = {
            "ms_median": statistics.median(r["ms"] for r in rs),
            "ms_max": max(r["ms"] for r in rs),
            "rounds": [r["rounds"] for r in rs],
            "site_visits": [r["site_visits"] for r in rs],
            "traffic_bits": [r["traffic_bits"] for r in rs]}
    if any(b != fr.traffic_bits("reach")
           for b, (s, t) in zip(summary["oneshot"]["traffic_bits"],
                                pairs.tolist()) if s != t):
        raise AssertionError("a one-shot disReach shipped other than "
                             "traffic_bits('reach')")
    for name, sm in summary.items():
        print(f"baselines: {name} over {N_BASELINE} pairs, median "
              f"{sm['ms_median']:.1f} ms (max {sm['ms_max']:.1f}); rounds "
              f"{sm['rounds']}; site visits {sm['site_visits'][:4]}...; "
              f"traffic bits {sm['traffic_bits'][:2]}...")
    print(f"baselines: one-shot wire {fr.traffic_bits('reach')} bits "
          f"(bitpacked B^2; traffic_bits_reach {fr.traffic_bits_reach()}), "
          f"disReach_n {summary['n']['traffic_bits'][0]} bits (|G|); "
          f"launches {launches}; {N_BASELINE} x 3 answers match the BFS")

    # the paper's contrast: a chain crossing the fragments at every edge
    n, k = CHAIN_NODES, N_FRAGS
    chain = Graph(n, np.arange(n - 1), np.arange(1, n),
                  np.zeros(n, np.int32))
    cfr = fragment_graph(chain, (np.arange(n) % k).astype(np.int32), k)
    m_ms, m_res = cuda_timed(lambda: dis_reach_m(cfr, 0, n - 1), 1,
                             warmup=False)
    _reset_launches()
    with _EvalDGCalls() as calls:
        o_ms, o_res = cuda_timed(lambda: dis_reach(cfr, 0, n - 1), 1,
                                 warmup=False)
    _assert_one_fixpoint_each("chain disReach", _launches(), calls, local=1)
    if not (m_res.answer and o_res.answer):
        raise AssertionError("the chain's end is not reached")
    if m_res.rounds <= k or o_res.stats.collective_rounds != 1:
        raise AssertionError(f"chain: disReach_m {m_res.rounds} rounds, "
                             f"disReach {o_res.stats.collective_rounds}")
    print(f"baselines: {n}-node chain round-robin over {k} fragments: "
          f"disReach_m {m_res.rounds} rounds, {m_res.site_visits} site "
          f"visits, {m_res.traffic_bits} bits, {m_ms:.1f} ms; disReach 1 "
          f"round, {o_res.stats.payload_bits} bits, {o_ms:.1f} ms")
    # the chain's evalDG alone: one fixpoint of about n steps
    D, src, tgt = _kept_evaldg(lambda: dis_reach(cfr, 0, n - 1))
    chain_fx = _evaldg_timed("chain evaldg", D, src, tgt, True)
    del D, src, tgt
    out["baselines"] = {"pairs": summary, "launches": launches,
                        "chain": {"m_rounds": m_res.rounds, "m_ms": m_ms,
                                  "m_visits": m_res.site_visits,
                                  "m_bits": m_res.traffic_bits,
                                  "oneshot_ms": o_ms,
                                  "oneshot_bits": o_res.stats.payload_bits,
                                  "fixpoint": chain_fx}}


def _kept_evaldg(run):
    """(D, src, tgt) of the last ``engine.evaldg_reach`` that ``run()``
    made."""
    from repro_torch.core import engine
    keep = {}
    orig = engine.evaldg_reach

    def kept(D, src, tgt):
        keep.update(D=D, src=src, tgt=tgt)
        return orig(D, src, tgt)

    engine.evaldg_reach = kept
    try:
        run()
    finally:
        engine.evaldg_reach = orig
    return keep["D"], keep["src"], keep["tgt"]


# ---------------------------------------------------------------------------
# 9. MRdRPQ at full size
# ---------------------------------------------------------------------------

#: the reference stacks the k mapper outputs: k x (B*Q)^2 bytes at full
#: size; the port's peak must stay far below it.  With D read as stored
#: (no D^T beside it) the peak is D, one mapper's temporaries and what the
#: earlier phases keep, under 12 GB; a second 6.4 GB matrix would pass it
MR_PEAK_LIMIT = 12e9


def phase_mapreduce(out: dict, g, fr) -> None:
    """The one-shot phase's 4 RPQs ``(0|1)* 2`` through ``mr_drpq``: the
    answers equal the one-shot RPQ's and the product-graph BFS; each
    reducer's evalDG one fixpoint launch, no per-step product, no copy;
    the device memory peak printed (the reference would stack 16 mapper
    outputs of 6.4 GB); the map / evalDG split; and the reducer's whole
    fixpoint, [1, 80205] x [80205, 80205] on D as stored, through the
    fixpoint kernel, timed against the bytes it reads."""
    import torch
    from repro_torch.core.automaton import build_query_automaton
    from repro_torch.core.mapreduce import mr_drpq

    qa = build_query_automaton(ONESHOT_REGEX, int)
    pairs = out["oneshot"]["rpq_pairs"]
    want = out["oneshot"]["rpq_answers"]
    side = fr.B * qa.n_states
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_launches()
    splits, results = [], []
    with _EvalDGCalls() as calls:
        t0 = time.perf_counter()
        for (s, t), w in zip(pairs.tolist(), want):
            clock = _PhaseClock()
            res = mr_drpq(fr, s, t, qa, mark=clock)
            splits.append(clock.ms())
            if res.answer != w or res.answer != _rpq_oracle(g, s, t, qa):
                raise AssertionError(f"mr_drpq ({s}, {t}) got {res.answer}, "
                                     f"one-shot {w}")
            results.append(res)
        run_ms = (time.perf_counter() - t0) * 1e3
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    _assert_one_fixpoint_each("mapreduce", launches, calls, local=0)
    if peak > MR_PEAK_LIMIT:
        raise AssertionError(f"mr_drpq peaked at {peak / 1e9:.2f} GB")
    stacked = fr.k * side * side
    if results[0].reducer_input_bits != stacked:
        raise AssertionError("reducer_input_bits is not k (B*Q)^2")
    split = {p: statistics.median(sp[p] for sp in splits)
             for p in splits[0]}
    print(f"mapreduce: {len(pairs)} Rpq {ONESHOT_REGEX!r} (D [{side}]^2) "
          f"{run_ms:.1f} ms; answers {[r.answer for r in results]} equal "
          f"to the one-shot RPQ's and the product-graph BFS; launches "
          f"{launches}; split (ms, median) {split}; memory peak "
          f"{peak / 1e9:.3f} GB ({base / 1e9:.3f} GB before), the stacked "
          f"rvsets would be {stacked / 1e9:.1f} GB; ecc_bits "
          f"{results[0].ecc_bits}")

    # the reducer's evalDG, M = 1 at side B*Q, on the D of the first
    # query, rebuilt here
    s, t = pairs[0].tolist()
    D, src, tgt = _kept_evaldg(lambda: mr_drpq(fr, s, t, qa))
    fixpoint = _evaldg_timed("mr evaldg", D, src, tgt, bool(want[0]))
    del D, src, tgt
    torch.cuda.empty_cache()
    out["mapreduce"] = {"run_ms": run_ms, "launches": launches,
                        "split_ms": split, "peak_bytes": peak,
                        "stacked_bytes": stacked, "fixpoint": fixpoint}


# ---------------------------------------------------------------------------
# 10. the sharded repair at full size, on the one-rank NCCL group
# ---------------------------------------------------------------------------

N_REPAIR_QUERIES = 256
REPAIR_TENSORS = ("bl_frontier", "closure", "closure_t")


class _FailAtRepair:
    """A fault injector that fails every delta at ``delta.repair``."""

    def maybe_fail(self, site, pairs=None):
        if site == "delta.repair":
            raise RuntimeError("injected at delta.repair")


def _rows_free_partition(g) -> np.ndarray:
    """A 16-way partition of ``g`` whose last fragment holds exactly the
    nodes with no in-edge: it owns no boundary row, whatever is inserted
    inside it."""
    rng = np.random.default_rng(SEED)
    indeg = np.bincount(g.dst, minlength=g.n)
    part = rng.integers(0, N_FRAGS - 1, size=g.n).astype(np.int32)
    part[indeg == 0] = N_FRAGS - 1
    return part


def phase_sharded_repair(out: dict, g):
    """``session.apply`` on a ``backend="shard_map"`` session over the
    one-rank NCCL group, with a warm reach-only cache and the dynamic
    phase's reserves: repairs ship one collective of
    ``traffic_bits_update(r)`` bits and launch B1; every delta leaves the
    cache bit-equal to the host repair of the same delta on a copy-on-
    write clone, and 256 reach queries after it, through the sharded batch
    and the cached path, match the BFS.  Returns the session, for the
    verify phase."""
    import torch
    import repro_torch
    from repro_torch import DeltaApplyFailed, GraphDelta, Reach
    from repro_torch.core import cache as C
    from repro_torch.core import distributed as D
    from repro_torch.core import incremental
    from repro_torch.core.fragments import fragment_graph
    from repro_torch.core.versions import cow_clone
    from repro_torch.graph import random_partition

    rng = np.random.default_rng(SEED + 7)
    fr = fragment_graph(g, random_partition(g, N_FRAGS, seed=SEED), N_FRAGS,
                        **RESERVE)
    sess = repro_torch.connect(fr, backend="shard_map")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.warm()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"sharded repair: nb={fr.n_boundary} (active {fr.nb_active}) "
          f"n_max={fr.n_max}, reserves {RESERVE}, reach-only cache warm "
          f"{warm_ms:.1f} ms on the one-rank NCCL group")
    applies, launches_by_mode = [], {}

    def check(label, fr, sess):
        pairs = rng.integers(0, fr.g.n, size=(N_REPAIR_QUERIES, 2))
        queries = [Reach(int(s), int(t)) for s, t in pairs]
        _check_reach_dist(fr.g, queries, sess.run(queries),
                          f"sharded repair {label}")
        table = _bfs_distances(fr.g, pairs[:, 0])
        want = [s == t or table[s][t] >= 0 for s, t in pairs.tolist()]
        got = C.dis_reach_batch(fr, pairs, sess.device).tolist()
        if got != want:
            raise AssertionError(f"sharded repair {label}: the cached path "
                                 "disagrees with the BFS")

    probe = _RankUpdateProbe(incremental)

    def apply(label, delta, want_mode, fr=fr, sess=sess,
              tensors=REPAIR_TENSORS):
        clone = cow_clone(fr, delta)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = incremental.apply_delta(clone, delta)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        _reset_launches()
        D.collectives = D.payload_bits = 0
        t0 = time.perf_counter()
        if label == "intra":
            # keep the sharded rank update's operands (r: every in-node
            # row of the dirty fragment)
            with probe:
                stats = sess.apply(delta)
        else:
            stats = sess.apply(delta)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _launches()
        wire = (D.collectives, D.payload_bits)
        _assert_no_copies(f"sharded repair {label}")
        if stats.mode != want_mode:
            raise AssertionError(f"sharded repair {label}: mode "
                                 f"{stats.mode}, expected {want_mode}")
        r = 0
        if stats.mode == "repair_sharded" and stats.changed_rows:
            r = len(incremental.pad_row_ids(np.arange(stats.changed_rows),
                                            cap=fr.n_boundary))
            if launches["or_and_matmul"] == 0:
                raise AssertionError(f"{label}: B1 not launched by the "
                                     "sharded repair")
        want_wire = (1, fr.traffic_bits_update(r)) if r else (0, 0)
        if wire != want_wire:
            raise AssertionError(f"sharded repair {label}: {wire[0]} "
                                 f"collectives of {wire[1]} bits, expected "
                                 f"{want_wire}")
        for name in tensors:
            if not torch.equal(getattr(fr.rvset_cache, name),
                               getattr(clone.rvset_cache, name)):
                raise AssertionError(f"sharded repair {label}: {name} "
                                     "differs from the host repair's")
        del clone
        applies.append({"delta": label, "mode": stats.mode, "ms": ms,
                        "host_mode": host.mode, "host_ms": host_ms,
                        "changed_rows": stats.changed_rows,
                        "new_boundary": stats.new_boundary,
                        "dirty_fragments": stats.dirty_fragments,
                        "collectives": wire[0], "payload_bits": wire[1],
                        "launches": launches})
        mode = launches_by_mode.setdefault(stats.mode, {})
        for name, n in launches.items():
            mode[name] = mode.get(name, 0) + n
        print(f"sharded repair: {label} (+{delta.n_add} -{delta.n_del}) -> "
              f"{stats.mode} in {ms:.1f} ms (host repair on a clone: "
              f"{host.mode} in {host_ms:.1f} ms); changed rows "
              f"{stats.changed_rows}, new boundary {stats.new_boundary}; "
              f"{wire[0]} collective(s) of {wire[1]} bits; launches "
              f"{launches}; {', '.join(tensors)} bit-equal to the host's")
        check(label, fr, sess)

    check("warm", fr, sess)
    deltas = dict(_dynamic_stream(fr, rng))
    apply("intra", deltas["intra"], "repair_sharded")
    apply("cross", deltas["cross"], "repair_sharded")
    if not applies[-1]["new_boundary"]:
        raise AssertionError("the cross delta activated no boundary node")

    # a fragmentation of the same graph whose last fragment owns no
    # boundary row: its inserts refresh frontiers with no collective
    part = _rows_free_partition(g)
    rf = fragment_graph(g, part, N_FRAGS, **RESERVE)
    rf_sess = repro_torch.connect(rf, backend="shard_map").warm()
    free = np.nonzero(part == N_FRAGS - 1)[0]
    if np.isin(free, rf.bnodes).any():
        raise AssertionError("the rows-free fragment owns a boundary node")
    apply("rows_free", GraphDelta.insert(
        [(int(rng.choice(free)), int(rng.choice(free))) for _ in range(8)]),
        "repair_sharded", fr=rf, sess=rf_sess)
    if applies[-1]["changed_rows"] or applies[-1]["dirty_fragments"] != 1:
        raise AssertionError(f"rows-free delta: {applies[-1]}")
    del rf, rf_sess
    torch.cuda.empty_cache()

    apply("delete", deltas["delete"], "recompute")

    # a delta failing at delta.repair, after the host arrays mutated
    held = {n: (getattr(fr.rvset_cache, n), getattr(fr.rvset_cache, n)
                .clone()) for n in REPAIR_TENSORS}
    versions = (fr.arrays_version, sess.cache_version)
    f = int(rng.integers(fr.k))
    mine = np.nonzero(fr.part == f)[0]
    bad = GraphDelta.insert([(int(rng.choice(mine)), int(rng.choice(mine)))
                             for _ in range(32)])
    sess.chaos = _FailAtRepair()
    t0 = time.perf_counter()
    try:
        sess.apply(bad)
        raise AssertionError("the failing delta did not raise")
    except DeltaApplyFailed:
        pass
    finally:
        sess.chaos = None
    rollback_ms = (time.perf_counter() - t0) * 1e3
    if (fr.arrays_version, sess.cache_version) != versions:
        raise AssertionError("the failed sharded delta moved a version")
    for name, (obj, copy) in held.items():
        if getattr(fr.rvset_cache, name) is not obj or not torch.equal(
                obj, copy):
            raise AssertionError(f"the failed sharded delta changed {name}")
    del held
    print(f"sharded repair: a delta failing at delta.repair rolled back in "
          f"{rollback_ms:.1f} ms (rollbacks {sess.stats.rollbacks}); "
          f"versions {versions} and the cache unchanged")
    check("rolled back", fr, sess)
    apply("after rollback", bad, "repair_sharded")

    # with distances cached, the reference keeps every delta on the host
    sess.warm(with_dist=True)
    mine = np.nonzero(fr.part == int(rng.integers(fr.k)))[0]
    apply("dist cache", GraphDelta.insert(
        [(int(rng.choice(mine)), int(rng.choice(mine))) for _ in range(32)]),
        "repair", tensors=REPAIR_TENSORS + ("bl_dist", "dist_closure"))
    # the P stage with its floor pair at the sharded repair's K
    C0, Ct0 = probe.args["bool"][:2]
    Tt, left = _p_stage(probe.args["bool"])[1::4]
    p_floor = _time_p_floor("sharded rank update P with floor", C0, Ct0,
                            left, Tt)
    del C0, Ct0, Tt, left, probe
    torch.cuda.empty_cache()
    next(k for k in out["kernels"]
         if k["name"] == "or_and_floor")["sharded_repair"] = p_floor
    out["sharded_repair"] = {"warm_ms": warm_ms, "applies": applies,
                             "launches_by_mode": launches_by_mode,
                             "rollback_ms": rollback_ms, "p_floor": p_floor}
    return fr, sess


# ---------------------------------------------------------------------------
# 11. the wire verifier on the NCCL session
# ---------------------------------------------------------------------------

VERIFY_REGEX = "0*"


def phase_verify(out: dict, sess) -> None:
    """``verify_session`` on the sharded repair's NCCL session at full
    size: the three fused batch programs, the one-shot disReach (one
    localEval launch) and the cache update, each one collective of its
    wire model's bits, none in a fixpoint, no graph-sized wire dimension
    (HLO001-HLO004)."""
    import torch
    from repro_torch.analysis.wire_check import (KINDS, _wire_model,
                                                 verify_session)
    from repro_torch.core import distributed as D
    from repro_torch.core import incremental
    from repro_torch.core.automaton import build_query_automaton

    fr = sess.fr
    qa = build_query_automaton(VERIFY_REGEX, int)
    r = len(incremental.pad_row_ids(np.arange(min(3, fr.nb_active)), pad=8,
                                    cap=fr.n_boundary))
    want = {kind: _wire_model(fr, kind, r if kind == "update" else 2,
                              qa.n_states if kind == "rpq" else 1)[0]
            for kind in KINDS}
    torch.cuda.synchronize()
    _reset_launches()
    D.collectives = D.payload_bits = 0
    t0 = time.perf_counter()
    violations = verify_session(sess, qa=qa)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if violations:
        raise AssertionError(f"verify: {[str(v) for v in violations]}")
    if (D.collectives, D.payload_bits) != (len(KINDS), sum(want.values())):
        raise AssertionError(f"verify: {D.collectives} collectives of "
                             f"{D.payload_bits} bits, expected {want}")
    launches = _launches()
    if launches["local_eval"] != 1:
        raise AssertionError(f"verify: {launches['local_eval']} localEval "
                             f"launches, expected 1 (the one-shot disReach)")
    print(f"verify: verify_session on the NCCL session (nb="
          f"{fr.n_boundary}, rpq {VERIFY_REGEX!r} with {qa.n_states} "
          f"states) in {ms:.1f} ms: no violation; {D.collectives} "
          f"collectives, one per program, of {want} bits; launches "
          f"{launches}")
    out["verify"] = {"ms": ms, "bits": want, "launches": launches}


# ---------------------------------------------------------------------------
# 13-15. the LM family: serve, MoE serve, train
# ---------------------------------------------------------------------------

LM_DEVICE = "cuda"
LM_BATCH = 8                 # ServeEngine batch, and requests per run
LM_MAX_LEN = 256
LM_PROMPT_LENS = (8, 64)     # prompt lengths drawn from this range
LM_NEW_TOKENS = 32
LM_INT8_NEW = 8              # the int8 KV run: the same prompts, fewer steps
LM_CHECK_LEN = 32            # tokens of the f32 decode-vs-forward checks
LM_F32_BATCH = 4             # requests of the f32 teacher-forced check
LM_F32_NEW = 16
LM_TRAIN_SEQ = 512
LM_TRAIN_BATCH = 4           # split into LM_TRAIN_ACCUM microbatches
LM_TRAIN_ACCUM = 2
LM_TRAIN_STEPS = 4
LM_REPLAY_STEPS = 10         # smoke config, failure injected at step 7
LM_F32_ATOL = 2e-3           # f32 logits: decode / prefill vs forward
BF16_BYTES = 2


def _lm_cfg(arch_id: str, **changes):
    """The architecture's full-width, full-depth configuration."""
    import dataclasses
    from repro_torch.configs import LM_ARCHS
    return dataclasses.replace(LM_ARCHS[arch_id].base_cfg, **changes)


def _lm_params(cfg, seed: int):
    import torch
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=LM_DEVICE).manual_seed(seed)
    return T.init_params(cfg, gen, device=LM_DEVICE)


def _lm_requests(cfg, seed: int, count: int, new_tokens: int):
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    lo, hi = LM_PROMPT_LENS
    return [Request(prompt=rng.integers(0, cfg.vocab, int(n),
                                        dtype=np.int32),
                    max_new_tokens=new_tokens)
            for n in rng.integers(lo, hi + 1, count)]


def _engine(cfg, params):
    """A ServeEngine over ``params``, warmed up by one short request."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, batch=LM_BATCH, max_len=LM_MAX_LEN,
                      device=LM_DEVICE)
    warm = _lm_requests(cfg, SEED + 99, 1, 2)
    warm[0].prompt = warm[0].prompt[:4]
    eng.generate(warm)
    return eng


def _serve_timed(eng, requests) -> dict:
    """One ServeEngine run of ``requests`` (one batch), timed by phase on
    the host clock around device syncs; the device memory peak."""
    import torch
    marks = {}

    def mark(phase):
        torch.cuda.synchronize()
        marks[phase] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    done = eng.generate(requests, mark=mark)
    steps = max(r.max_new_tokens for r in requests) - 1
    decode_s = marks["end"] - marks["decode"]
    prompt_len = max(len(r.prompt) for r in requests)
    return {"prefill_ms": (marks["decode"] - marks["prefill"]) * 1e3,
            "prefill_steps": prompt_len,
            "decode_ms_per_step": decode_s / steps * 1e3,
            "decode_tokens_per_s": LM_BATCH * steps / decode_s,
            "memory_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "tokens": [r.generated for r in done]}


def _device_busy(fn) -> dict:
    """Device time and event count (kernels, copies, fills) of one call
    of ``fn``, from a torch.profiler trace of the device's activity only
    (the sum of the events' durations; one stream, so they do not
    overlap), and the four event names that took the most of it
    (``top_ms``).  ``device_ms`` is None when the trace holds no device
    event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the trace's raw events: prof.events() builds a Python object per
    # event, slow over the 336k events of a full-width training step
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation()]
    busy = sum(e.duration_ns() for e in dev) / 1e6 if dev else None
    by_name: dict = {}
    for e in dev:
        by_name[e.name()] = by_name.get(e.name(), 0.0) + \
            e.duration_ns() / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"device_ms": busy, "device_events": len(dev),
            "top_ms": [(name[:48], round(ms, 3)) for name, ms in top]}


def _decode_busy(cfg, params, steps: int = 2) -> dict:
    """_device_busy of ``steps`` bf16 decode steps at batch LM_BATCH, per
    step."""
    import torch
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, LM_BATCH, LM_MAX_LEN, device=LM_DEVICE)
    tok = torch.zeros(LM_BATCH, dtype=torch.long, device=LM_DEVICE)

    def run():
        nonlocal cache
        with torch.inference_mode():
            for i in range(steps):
                _, cache = T.decode_step(
                    cfg, params, cache, tok,
                    torch.full((LM_BATCH,), i, device=LM_DEVICE))

    run()                                            # warm-up
    cache = T.init_cache(cfg, LM_BATCH, LM_MAX_LEN, device=LM_DEVICE)
    busy = _device_busy(run)
    if busy["device_ms"] is not None:
        busy["device_ms"] /= steps
    busy["device_events"] /= steps
    busy["top_ms"] = [(name, ms / steps) for name, ms in busy["top_ms"]]
    return busy


def _idle_share(busy_ms, wall_ms):
    return None if busy_ms is None else 1 - busy_ms / wall_ms


def _decode_all(cfg, params, toks):
    """decode_step over every position of ``toks`` [B, S]: logits
    [B, S, V]."""
    import torch
    from repro_torch.models import transformer as T
    B, S = toks.shape
    cache = T.init_cache(cfg, B, S, device=LM_DEVICE)
    out = []
    for i in range(S):
        lg, cache = T.decode_step(cfg, params, cache, toks[:, i],
                                  torch.full((B,), i, device=toks.device))
        out.append(lg)
    return torch.stack(out, dim=1)


def _f32_consistency(cfg, params, seed: int, what: str) -> dict:
    """decode_step over LM_CHECK_LEN tokens against forward, and prefill
    of the first 3/4 followed by decode_step, against forward."""
    import torch
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, LM_CHECK_LEN))
                            ).to(LM_DEVICE)
    cut = LM_CHECK_LEN * 3 // 4
    with torch.no_grad():
        full, _ = T.forward(cfg, params, toks)
        dec = _decode_all(cfg, params, toks)
        pre, cache = T.prefill(cfg, params, toks[:, :cut], LM_CHECK_LEN)
        cont = []
        for i in range(cut, LM_CHECK_LEN):
            lg, cache = T.decode_step(cfg, params, cache, toks[:, i],
                                      torch.full((2,), i, device=LM_DEVICE))
            cont.append(lg)
        cont = torch.stack(cont, dim=1)
    errs = {"decode": (dec - full).abs().max().item(),
            "prefill": (pre - full[:, :cut]).abs().max().item(),
            "prefill_then_decode": (cont - full[:, cut:]).abs().max().item()}
    for name, err in errs.items():
        if not err <= LM_F32_ATOL:
            raise AssertionError(f"{what}: f32 {name} logits differ from "
                                 f"forward by {err} > {LM_F32_ATOL}")
    return errs


def _teacher_forced(cfg, params) -> dict:
    """ServeEngine's greedy tokens against the argmax of forward over the
    same left-padded sequence.  A token may differ only where forward's
    two candidates lie within LM_F32_ATOL of each other (a tie)."""
    import torch
    from repro_torch.models import transformer as T
    reqs = _lm_requests(cfg, SEED + 21, LM_F32_BATCH, LM_F32_NEW)
    res = _serve_timed(_engine(cfg, params), reqs)
    S = max(len(r.prompt) for r in reqs)
    seq = np.zeros((len(reqs), S + LM_F32_NEW - 1), np.int64)
    for j, (r, gen) in enumerate(zip(reqs, res["tokens"])):
        seq[j, S - len(r.prompt):S] = r.prompt
        seq[j, S:] = gen[:-1]
    with torch.no_grad():
        logits, _ = T.forward(cfg, params, torch.from_numpy(seq).to(
            LM_DEVICE))
    logits = logits[:, S - 1:].float()                 # predicts gen[0:]
    want = logits.argmax(-1).cpu().numpy()
    got = np.asarray(res["tokens"])
    ties = 0
    for j, i in zip(*np.nonzero(want != got)):
        gap = (logits[j, i, want[j, i]] - logits[j, i, got[j, i]]).item()
        if gap > LM_F32_ATOL:
            raise AssertionError(
                f"lm_serve: greedy token {got[j, i]} of request {j} at step "
                f"{i} is not forward's argmax {want[j, i]} (gap {gap})")
        ties += 1
    return {"tokens": int(got.size), "differing_ties": ties}


def _fresh(r, new_tokens: int):
    """An unserved copy of a request (ServeEngine writes ``generated``)
    asking for ``new_tokens``."""
    from repro_torch.serve import Request
    return Request(prompt=r.prompt, max_new_tokens=new_tokens)


def _assert_no_launches(what: str) -> dict:
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"{what}: a query kernel was launched: "
                             f"{launches}")
    return launches


def phase_lm_serve(out: dict) -> None:
    """qwen2-1.5b at full width and depth: f32 self-consistency (decode
    vs forward, prefill + decode vs forward, ServeEngine vs teacher-forced
    forward), then ServeEngine timed in bf16, plain and with the int8
    chunked KV cache."""
    import torch
    from repro_torch.models import transformer as T
    _reset_launches()
    cfg32 = _lm_cfg("qwen2-1.5b", dtype=torch.float32)
    params = _lm_params(cfg32, SEED + 20)
    res = {"n_params": cfg32.n_params(),
           "f32_max_abs_err": _f32_consistency(cfg32, params, SEED + 22,
                                               "lm_serve"),
           "f32_teacher_forced": _teacher_forced(cfg32, params)}
    del params
    torch.cuda.empty_cache()

    cfg = _lm_cfg("qwen2-1.5b")
    params = _lm_params(cfg, SEED + 20)
    reqs = _lm_requests(cfg, SEED + 23, LM_BATCH, LM_NEW_TOKENS)
    bf16 = _serve_timed(_engine(cfg, params), reqs)
    bf16["decode_bound_ms"] = cfg.n_params() * BF16_BYTES / \
        HBM_BYTES_PER_S * 1e3
    bf16["profile"] = _decode_busy(cfg, params)
    bf16["idle_share"] = _idle_share(bf16["profile"]["device_ms"],
                                     bf16["decode_ms_per_step"])
    cfg_q = _lm_cfg("qwen2-1.5b", kv_quant_int8=True,
                    decode_chunk=LM_MAX_LEN // 4)
    made = []
    init_cache = T.init_cache
    T.init_cache = lambda *a, **k: made.append(init_cache(*a, **k)) or \
        made[-1]
    try:
        int8 = _serve_timed(_engine(cfg_q, params),
                            [_fresh(r, LM_INT8_NEW) for r in reqs])
    finally:
        T.init_cache = init_cache
    int8["profile"] = _decode_busy(cfg_q, params)
    int8["idle_share"] = _idle_share(int8["profile"]["device_ms"],
                                     int8["decode_ms_per_step"])
    int8["cache_dtype"] = str(made[-1]["k"].dtype)
    if made[-1]["k"].dtype != torch.int8:
        raise AssertionError(f"lm_serve: int8 KV run kept a "
                             f"{made[-1]['k'].dtype} cache")
    int8["same_tokens_as_bf16"] = int(
        (np.asarray(int8["tokens"]) ==
         np.asarray(bf16["tokens"])[:, :LM_INT8_NEW]).sum())
    del made, params
    torch.cuda.empty_cache()
    res.update(bf16=bf16, int8=int8, launches=_assert_no_launches("lm_serve"))
    print(f"lm_serve: qwen2-1.5b N={cfg.n_params()}; f32 max |err| "
          f"{res['f32_max_abs_err']}, teacher-forced {res['f32_teacher_forced']}"
          f"; bf16 prefill {bf16['prefill_ms']:.1f} ms over "
          f"{bf16['prefill_steps']} steps, decode "
          f"{bf16['decode_ms_per_step']:.3f} ms/step "
          f"({bf16['decode_tokens_per_s']:.1f} tokens/s, bound "
          f"{bf16['decode_bound_ms']:.3f} ms/step), peak "
          f"{bf16['memory_peak_gb']:.3f} GB, device per step "
          f"{bf16['profile']} (idle share {bf16['idle_share']}); int8 KV "
          f"(chunk {cfg_q.decode_chunk}, cache {int8['cache_dtype']}) decode "
          f"{int8['decode_ms_per_step']:.3f} ms/step, device per step "
          f"{int8['profile']} (idle share {int8['idle_share']}), "
          f"{int8['same_tokens_as_bf16']}/{LM_BATCH * LM_INT8_NEW} tokens "
          f"as bf16")
    print(f"lm_serve: int8 greedy tokens of request 0: {int8['tokens'][0]}")
    out["lm_serve"] = res



def phase_lm_moe(out: dict) -> None:
    """olmoe-1b-7b at full width and depth: decode_step against forward in
    f32 with a capacity that drops nothing, then ServeEngine timed in bf16
    at the configuration's own capacity factor, with its dropped (token,
    choice) pairs counted."""
    import torch
    from repro_torch.models import transformer as T
    _reset_launches()
    base = _lm_cfg("olmoe-1b-7b")
    cfg32 = _lm_cfg("olmoe-1b-7b", dtype=torch.float32,
                    capacity_factor=float(base.n_experts // base.top_k))
    params = _lm_params(cfg32, SEED + 30)
    rng = np.random.default_rng(SEED + 31)
    toks = torch.from_numpy(rng.integers(0, cfg32.vocab, (2, 16))).to(
        LM_DEVICE)
    with torch.no_grad():
        full, _ = T.forward(cfg32, params, toks)
        dec = _decode_all(cfg32, params, toks)
    err = (dec - full).abs().max().item()
    if not err <= LM_F32_ATOL:
        raise AssertionError(f"lm_moe: f32 decode differs from forward by "
                             f"{err} > {LM_F32_ATOL}")
    del params, full, dec
    torch.cuda.empty_cache()

    params = _lm_params(base, SEED + 30)
    counts = {"dropped": torch.zeros((), dtype=torch.long,
                                     device=LM_DEVICE), "pairs": 0}
    slots = T._capacity_slots

    def counting(flat_e, n_experts, cap):
        pos, keep = slots(flat_e, n_experts, cap)
        counts["dropped"] += (~keep).sum()
        counts["pairs"] += keep.numel()
        return pos, keep

    eng = _engine(base, params)
    T._capacity_slots = counting
    try:
        res = _serve_timed(eng, _lm_requests(base, SEED + 32, LM_BATCH,
                                             LM_NEW_TOKENS))
    finally:
        T._capacity_slots = slots
    res["profile"] = _decode_busy(base, params)
    res["idle_share"] = _idle_share(res["profile"]["device_ms"],
                                    res["decode_ms_per_step"])
    res["decode_bound_ms"] = base.n_params() * BF16_BYTES / \
        HBM_BYTES_PER_S * 1e3
    res.update(n_params=base.n_params(), f32_max_abs_err=err,
               dropped_pairs=int(counts["dropped"]),
               routed_pairs=counts["pairs"],
               launches=_assert_no_launches("lm_moe"))
    del eng, params
    torch.cuda.empty_cache()
    print(f"lm_moe: olmoe-1b-7b N={base.n_params()}; f32 decode vs forward "
          f"(capacity {cfg32.capacity_factor}) max |err| {err:.3e}; bf16 at "
          f"capacity {base.capacity_factor}: prefill {res['prefill_ms']:.1f} "
          f"ms over {res['prefill_steps']} steps, decode "
          f"{res['decode_ms_per_step']:.3f} ms/step "
          f"({res['decode_tokens_per_s']:.1f} tokens/s, bound "
          f"{res['decode_bound_ms']:.3f} ms/step), peak "
          f"{res['memory_peak_gb']:.3f} GB, device per step "
          f"{res['profile']} (idle share {res['idle_share']}); dropped "
          f"{res['dropped_pairs']} of {res['routed_pairs']} (token, choice) "
          f"pairs")
    out["lm_moe"] = res


def _train_timed(trainer, batches, what: str = "lm_train"):
    """(ms, losses) of one Trainer.step per batch, each finite."""
    import torch
    ms, losses = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step(batch)
        loss = float(m["loss"])                   # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(loss):
            raise AssertionError(f"{what}: loss {loss}")
        losses.append(loss)
    return ms, losses


def _replay_in_child() -> dict:
    """_replay_bitwise in a child process started with
    CUBLAS_WORKSPACE_CONFIG=:4096:8, which deterministic cuBLAS needs set
    before cuBLAS starts.  It is not set in this process: it slows
    cuBLAS's small products (a [16103, 64] x [64, 64] call ~2x on the
    H100), which other phases time."""
    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import chip_smoke as C; C._require_repo(); "
            "print(json.dumps(C._replay_bitwise()))")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    if proc.returncode != 0:
        raise AssertionError("lm_train: the replay process failed:\n"
                             + proc.stderr[-4000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _replay_bitwise() -> dict:
    """Trainer.run at the smoke configuration with a failure injected at
    step 7, against a clean run: bit-equal parameters.  Needs
    deterministic kernels: ``torch.use_deterministic_algorithms(True)``
    here, and CUBLAS_WORKSPACE_CONFIG set before cuBLAS started (see
    _replay_in_child)."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(LM_ARCHS["qwen2-1.5b"].smoke_cfg, remat=True)
    params = _lm_params(cfg, SEED + 40)
    stream = TokenStream(vocab=cfg.vocab, batch=4, seq_len=64,
                         device=LM_DEVICE)
    root = ROOT / "build" / "lm_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def run(name, fail):
        tr = Trainer(TrainerConfig(ckpt_dir=str(root / name), ckpt_every=5),
                     adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                       total_steps=20),
                     lambda p, b: T.lm_loss(cfg, p, b["tokens"],
                                            b["targets"]),
                     params, device=LM_DEVICE)
        fired = []

        def hook(step):
            if fail and step == 7 and not fired:
                fired.append(step)
                raise RuntimeError("simulated node failure")
        return tr, tr.run(stream.batch_at, LM_REPLAY_STEPS, fail_hook=hook)

    torch.use_deterministic_algorithms(True)
    try:
        clean, m_clean = run("clean", False)
        failed, m_failed = run("failed", True)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    if m_failed["restarts"] != 1 or int(failed.state["step"]) != \
            LM_REPLAY_STEPS:
        raise AssertionError(f"lm_train: replay restarts "
                             f"{m_failed['restarts']}, step "
                             f"{int(failed.state['step'])}")
    pairs = list(zip(leaves(clean.state["params"]),
                     leaves(failed.state["params"])))
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError("lm_train: the replayed run's parameters are "
                             "not bit-equal to the clean run's")
    return {"steps": LM_REPLAY_STEPS, "restarts": m_failed["restarts"],
            "leaves": len(pairs), "loss": m_clean["loss"]}


def phase_lm_train(out: dict) -> None:
    """qwen2-1.5b at full width: Trainer.step with gradient accumulation,
    remat and AdamW on TokenStream batches (timed, memory peak), one step
    with int8 gradient compression, then failure replay at the smoke
    configuration, bitwise."""
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    _reset_launches()
    cfg = _lm_cfg("qwen2-1.5b")
    stream = TokenStream(vocab=cfg.vocab, batch=LM_TRAIN_BATCH,
                         seq_len=LM_TRAIN_SEQ, device=LM_DEVICE)

    def micro(step):
        return {k: v.reshape(LM_TRAIN_ACCUM, -1, LM_TRAIN_SEQ)
                for k, v in stream.batch_at(step).items()}

    def loss_fn(p, b):
        return T.lm_loss(cfg, p, b["tokens"], b["targets"])

    res = {"n_params": cfg.n_params(),
           "tokens_per_step": LM_TRAIN_BATCH * LM_TRAIN_SEQ}
    for compress, steps in ((False, LM_TRAIN_STEPS), (True, 1)):
        params = _lm_params(cfg, SEED + 41)
        tr = Trainer(TrainerConfig(ckpt_dir=str(ROOT / "build" / "lm_ckpt"),
                                   ckpt_every=10 ** 9,
                                   grad_accum=LM_TRAIN_ACCUM,
                                   compress_grads=compress),
                     adamw.AdamWConfig(), loss_fn, params, device=LM_DEVICE)
        del params
        _train_timed(tr, [micro(0)])                  # warm-up step
        torch.cuda.reset_peak_memory_stats()
        ms, losses = _train_timed(tr, [micro(i + 1) for i in range(steps)])
        run = res["compressed" if compress else "plain"] = {
            "step_ms": ms, "median_ms": statistics.median(ms),
            "losses": losses,
            "memory_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if not compress:
            batch = micro(steps + 1)
            run["profile"] = _device_busy(lambda: tr.step(batch))
            run["idle_share"] = _idle_share(run["profile"]["device_ms"],
                                            run["median_ms"])
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    # 6 N D for the forward and backward, + 2 N D for the remat's second
    # forward, at the dense bf16 rate
    res["bound_ms"] = 8 * cfg.n_params() * res["tokens_per_step"] / \
        BF16_FLOPS_PER_S * 1e3
    res["replay"] = _replay_in_child()
    res["launches"] = _assert_no_launches("lm_train")
    plain, comp = res["plain"], res["compressed"]
    print(f"lm_train: qwen2-1.5b N={cfg.n_params()}, "
          f"{res['tokens_per_step']} tokens/step in {LM_TRAIN_ACCUM} "
          f"microbatches, remat: step {plain['median_ms']:.1f} ms median of "
          f"{plain['step_ms']} (bound {res['bound_ms']:.1f} ms), peak "
          f"{plain['memory_peak_gb']:.3f} GB, losses {plain['losses']}, "
          f"device {plain['profile']} (idle share {plain['idle_share']}); "
          f"int8-compressed step {comp['median_ms']:.1f} ms, peak "
          f"{comp['memory_peak_gb']:.3f} GB, loss {comp['losses']}; "
          f"replay after a failure at step 7: bit-equal over "
          f"{res['replay']['leaves']} leaves")
    out["lm_train"] = res


# ---------------------------------------------------------------------------
# 16-18. the GNN family and bert4rec
# ---------------------------------------------------------------------------

GNN_DEVICE = "cuda"
MOL_ATOMS = 30               # atoms of each of the molecule shape's graphs
MOL_EDGES = 64               # its shortest directed pairs, each molecule
MOL_BOX = 4.0                # side of the box the atoms are drawn in
MOL_REPS = 5                 # timed energy_and_forces calls
# bf16 keeps 8 significant bits (a rounding is within 2^-8 ~ 0.4 %) and
# the forces pass ~25 roundings (5 layers, forward and backward): the fused
# path is held within 10 % of the scale (max |err| <= 0.1 x max |value|)
# of the f32 path on the same weights, and so two fused evaluations (at
# the coordinates and rotated) within twice that of each other
BF16_SCALE_TOL = 0.1
# f32 results (on the card against the CPU, and under the rotation) agree
# within 1e-4 of their scale: max |err| <= 1e-4 x max |value|.  Random
# weights make forces of 10^3-10^4, whose rounding (f32 sums in the
# atomics' varying order) exceeds an elementwise bound near zero
F32_SCALE_TOL = 1e-4
GAT_TRAIN_STEPS = 2
REDDIT = dict(n=232_965, m=114_615_892, d=602)     # Reddit's published size
CORA = (2_708, 10_556)                              # Cora's nodes and edges
MINIBATCH_FANOUTS = [15, 10]
BULK_SECONDS = 20.0          # serve_bulk runs the chunks that fit in this
P99_CALLS = 20
RECSYS_ACCUM = 8             # train_batch as 8 microbatches


def _scale_err(got, want) -> float:
    """max |got - want| / max |want| (0 when both are 0)."""
    scale = want.abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    return err / scale if scale else err


def _to_cpu(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.cpu(), tree)


def _graph_on(g, device):
    import dataclasses
    return dataclasses.replace(
        g, **{f: getattr(g, f).to(device) for f in
              ("senders", "receivers", "node_mask", "edge_mask",
               "graph_ids")})


def _molecule_batch(seed: int):
    """The molecule shape at full size: 128 molecules of 30 atoms in a
    box, each with its 64 shortest directed pairs as edges (all under the
    cutoff), padded to FULL_DIMS (N = 4096, E = 8192); species, features
    and energy/force targets drawn from ``seed``."""
    import torch
    from repro_torch.configs.families.gnn import FULL_DIMS
    from repro_torch.models.gnn import common
    d = FULL_DIMS["molecule"]
    n_mol, N = d["n_graphs"], d["N"]
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, MOL_BOX, (n_mol, MOL_ATOMS, 3))
    dist = np.linalg.norm(x[:, :, None] - x[:, None, :], axis=-1)
    dist[:, np.arange(MOL_ATOMS), np.arange(MOL_ATOMS)] = np.inf
    flat = np.argsort(dist.reshape(n_mol, -1), axis=1,
                      kind="stable")[:, :MOL_EDGES]
    longest = np.take_along_axis(dist.reshape(n_mol, -1), flat, 1).max()
    s, r = np.divmod(flat, MOL_ATOMS)
    base = (np.arange(n_mol) * MOL_ATOMS)[:, None]
    g = common.pad_graph((s + base).ravel(), (r + base).ravel(),
                         n_mol * MOL_ATOMS, d["E"], N,
                         graph_ids=np.repeat(np.arange(n_mol), MOL_ATOMS),
                         n_graphs=n_mol, device=GNN_DEVICE)
    coords = np.zeros((N, 3), np.float32)
    coords[:n_mol * MOL_ATOMS] = x.reshape(-1, 3)

    def on(a):
        return torch.from_numpy(a).to(GNN_DEVICE)

    return dict(
        g=g, longest=float(longest), coords=on(coords),
        species=on(rng.integers(0, 64, N)),
        feats=on(rng.normal(size=(N, d["d"])).astype(np.float32)),
        e=on(rng.normal(size=n_mol).astype(np.float32)),
        f=on(rng.normal(size=(N, 3)).astype(np.float32)))


def _molecule_arch(arch_id, mol, rot, shift, cut, **changes) -> dict:
    """One architecture on the molecule batch: energy_and_forces timed and
    checked against the CPU and under a rotation and shift; one Trainer
    step on the molecule cell's loss (energy + 0.1 x force MSE, whose
    gradient differentiates the forces again), timed."""
    import dataclasses
    import torch
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs.families.gnn import FULL_DIMS
    from repro_torch.models.gnn import egnn, equivariant
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    arch = GNN_ARCHS[arch_id]
    cfg = dataclasses.replace(
        arch.full_cfg_fn(FULL_DIMS["molecule"]["d"]), **changes)
    if arch.kind != "egnn" and mol["longest"] >= cfg.cutoff:
        raise AssertionError(f"gnn_molecule: an edge of {mol['longest']} "
                             f"is past the cutoff {cfg.cutoff}")
    mod = egnn if arch.kind == "egnn" else equivariant
    fused = getattr(cfg, "fused_agg", False)
    x = mol["feats"] if arch.kind == "egnn" else mol["species"]
    g = mol["g"]
    gen = torch.Generator(device=GNN_DEVICE).manual_seed(SEED + 50)
    params = mod.init_params(cfg, gen, device=GNN_DEVICE)

    def energies(p, xx, c, gg):
        out = mod.forward(cfg, p, xx, c, gg)
        return out[0] if isinstance(out, tuple) else out

    def serve(c=mol["coords"]):
        return mod.energy_and_forces(cfg, params, x, c, g)

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        ms, (e1, f1) = cuda_timed(serve, MOL_REPS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        busy = _device_busy(serve)
        moved = mol["coords"] @ rot.T + shift
        _, f2 = serve(moved)
        g1 = energies(params, x, mol["coords"], g)
        g2 = energies(params, x, moved, g)
        if fused:        # against the f32 path on the same card
            plain = dataclasses.replace(cfg, fused_agg=False)
            ref_e, ref_f = mod.energy_and_forces(plain, params, x,
                                                 mol["coords"], g)
        else:                    # against the CPU
            ref_e, ref_f = mod.energy_and_forces(
                cfg, _to_cpu(params), x.cpu(), mol["coords"].cpu(),
                _graph_on(g, "cpu"))
    if not (torch.isfinite(f1).all() and torch.isfinite(g1).all()):
        raise AssertionError(f"gnn_molecule {arch_id}: non-finite output")
    f_rot = f1 @ rot.T
    res = {"n_params": cfg.n_params(), "ms": ms,
           "device_ms": busy["device_ms"], "device_events":
           busy["device_events"], "idle_share": _idle_share(
               busy["device_ms"], ms), "memory_peak_gb": peak,
           "energy_err": (g2 - g1).abs().max().item(),
           "force_err": (f2 - f_rot).abs().max().item(),
           "energy_scale_err": _scale_err(g2, g1),
           "force_scale_err": _scale_err(f2, f_rot),
           "ref": "f32 path" if fused else "cpu",
           "ref_energy_err": _scale_err(e1.to(ref_e.device), ref_e),
           "ref_force_err": _scale_err(f1.to(ref_f.device), ref_f)}
    # two bf16 evaluations each within ``cut`` of f32 differ by up to 2 cut
    rot_cut = 2 * cut if fused else cut
    bad = max(res["ref_energy_err"], res["ref_force_err"]) > cut or \
        max(res["energy_scale_err"], res["force_scale_err"]) > rot_cut
    if bad:
        raise AssertionError(f"gnn_molecule {arch_id} {changes}: "
                             f"invariance or CPU check failed: {res}")

    # the molecule cell's loss (energy + 0.1 x force MSE); optimized=True
    # is the fused_agg build
    cell = arch.build("molecule", optimized=fused)
    gd = {f: getattr(g, f) for f in ("senders", "receivers", "node_mask",
                                     "edge_mask", "graph_ids")}

    def loss_fn(p, b):
        return cell.loss_fn(p, b["x"], b["coords"], gd, b["e"], b["f"])

    tr = Trainer(TrainerConfig(ckpt_dir=str(ROOT / "build" / "gnn_ckpt"),
                               ckpt_every=10 ** 9),
                 adamw.AdamWConfig(), loss_fn, params, device=GNN_DEVICE)
    batch = dict(x=x, coords=mol["coords"], e=mol["e"], f=mol["f"])
    _train_timed(tr, [batch], "gnn_molecule")              # warm-up
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _train_timed(tr, [batch, batch], "gnn_molecule")
    res["train"] = {"step_ms": step_ms, "losses": losses,
                    "memory_peak_gb": torch.cuda.max_memory_allocated()
                    / 1e9, "profile": _device_busy(lambda: tr.step(batch))}
    res["train"]["idle_share"] = _idle_share(
        res["train"]["profile"]["device_ms"], min(step_ms))
    return res


def phase_gnn_molecule(out: dict) -> None:
    """NequIP (plain and fused_agg), MACE and EGNN at their full
    configurations on the molecule shape at full size."""
    import torch
    from scipy.spatial.transform import Rotation
    _reset_launches()
    mol = _molecule_batch(SEED + 51)
    rot = torch.from_numpy(Rotation.random(random_state=SEED + 52)
                           .as_matrix().astype(np.float32)).to(GNN_DEVICE)
    shift = torch.tensor([0.3, -1.2, 2.0], device=GNN_DEVICE)
    res = {"edges": MOL_EDGES, "atoms": MOL_ATOMS,
           "longest_edge": mol["longest"]}
    for name, arch_id, changes, cut in (
            ("nequip", "nequip", {}, F32_SCALE_TOL),
            ("nequip_fused", "nequip", {"fused_agg": True}, BF16_SCALE_TOL),
            ("mace", "mace", {}, F32_SCALE_TOL),
            ("egnn", "egnn", {}, F32_SCALE_TOL)):
        r = res[name] = _molecule_arch(arch_id, mol, rot, shift, cut,
                                       **changes)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"gnn_molecule: {name} N={r['n_params']}: energy_and_forces "
              f"{r['ms']:.3f} ms (device {r['device_ms']} ms in "
              f"{r['device_events']} events, idle share {r['idle_share']}), "
              f"peak {r['memory_peak_gb']:.3f} GB; rotation + shift: energy "
              f"err {r['energy_err']:.3e} ({r['energy_scale_err']:.3e} of "
              f"scale), force err {r['force_err']:.3e} "
              f"({r['force_scale_err']:.3e}); against the {r['ref']} "
              f"{r['ref_energy_err']:.3e} / {r['ref_force_err']:.3e} of "
              f"scale; train step "
              f"{r['train']['step_ms']} ms, device "
              f"{r['train']['profile']} (idle share "
              f"{r['train']['idle_share']}), peak "
              f"{r['train']['memory_peak_gb']:.3f} GB, losses "
              f"{r['train']['losses']}")
    res["launches"] = _assert_no_launches("gnn_molecule")
    out["gnn_molecule"] = res


def _csr_on_card(n: int, src: np.ndarray, dst: np.ndarray):
    """(indptr, indices) of ``csr_from_coo`` (a stable sort by source),
    sorted on the card; also the edge keys ``src * n + dst`` sorted, for
    membership checks."""
    import torch
    s = torch.from_numpy(src).to(GNN_DEVICE)
    d = torch.from_numpy(dst).to(GNN_DEVICE)
    s_sorted, order = torch.sort(s, stable=True)
    indices = d[order].cpu().numpy()
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=GNN_DEVICE)
    indptr[1:] = torch.cumsum(torch.bincount(s_sorted, minlength=n), 0)
    keys = torch.sort(s * n + d).values
    return indptr.cpu().numpy(), indices, keys


def _cora_edges(seed: int):
    """(senders, receivers) of a random graph of Cora's sizes."""
    rng = np.random.default_rng(seed)
    n, e = CORA
    return rng.integers(0, n, e), rng.integers(0, n, e)


def _reddit_sample(n_seeds: int) -> dict:
    """A Reddit-sized Erdos-Renyi graph (CSR sorted on the card) sampled
    15-10 by the host sampler around ``n_seeds`` GraphEpochStream seeds:
    the sample's node ids and edges (every pair checked to be an edge of
    the graph) and the clock at each step."""
    import torch
    from repro_torch.data import GraphEpochStream
    from repro_torch.graph import erdos_renyi
    from repro_torch.models.gnn import sampler
    t0 = time.perf_counter()
    graph = erdos_renyi(REDDIT["n"], REDDIT["m"], seed=SEED + 62)
    t1 = time.perf_counter()
    indptr, indices, keys = _csr_on_card(graph.n, graph.src, graph.dst)
    t2 = time.perf_counter()
    del graph
    seeds = GraphEpochStream(REDDIT["n"], n_seeds, seed=SEED + 63,
                             device="cpu").seeds_at(0).numpy()
    t3 = time.perf_counter()
    node_ids, s, r = sampler.sample_subgraph_host(
        indptr, indices, seeds, MINIBATCH_FANOUTS, seed=SEED + 64)
    t4 = time.perf_counter()
    del indptr, indices
    # each sampled pair (neighbour -> seed) is an edge seed -> neighbour
    # of the graph: degree-0 self-loops aside, none is made up
    gid = torch.from_numpy(node_ids).to(GNN_DEVICE)
    pair = gid[torch.from_numpy(r).to(GNN_DEVICE).long()] * REDDIT["n"] + \
        gid[torch.from_numpy(s).to(GNN_DEVICE).long()]
    found = torch.isin(pair, keys) | torch.from_numpy(s == r).to(GNN_DEVICE)
    if not bool(found.all()):
        raise AssertionError(f"gnn_gat: {int((~found).sum())} sampled pairs "
                             f"are not edges of the graph")
    return dict(node_ids=node_ids, s=s, r=r, seeds=seeds,
                clock=(t0, t1, t2, t3, t4))


def _sample_padding(sample: dict, dims: dict):
    """(N, E) the sample is padded to: FULL_DIMS' sizes, or what it drew
    where that is more."""
    from repro_torch.configs.families.gnn import _pad
    return (max(dims["N"], _pad(len(sample["node_ids"]))),
            max(dims["E"], _pad(len(sample["s"]))))


def _gat_timed(cfg, params, x, g, labels, mask, what: str) -> dict:
    """gat.forward timed, then Trainer steps on gat.loss (one warm-up,
    GAT_TRAIN_STEPS timed, one profiled)."""
    import torch
    from repro_torch.models.gnn import gat
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    with torch.no_grad():
        ms, logits = cuda_timed(lambda: gat.forward(cfg, params, x, g), 5)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{what}: non-finite logits")
    tr = Trainer(TrainerConfig(ckpt_dir=str(ROOT / "build" / "gnn_ckpt"),
                               ckpt_every=10 ** 9),
                 adamw.AdamWConfig(),
                 lambda p, b: gat.loss(cfg, p, b["x"], g, b["labels"],
                                       b["mask"]), params, device=GNN_DEVICE)
    batch = dict(x=x, labels=labels, mask=mask)
    _train_timed(tr, [batch], what)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _train_timed(tr, [batch] * GAT_TRAIN_STEPS, what)
    prof = _device_busy(lambda: tr.step(batch))
    return {"forward_ms": ms, "step_ms": step_ms, "losses": losses,
            "profile": prof, "idle_share": _idle_share(prof["device_ms"],
                                                       min(step_ms)),
            "memory_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "logits": logits}


def phase_gnn_gat(out: dict) -> None:
    """gat-cora at full width: on a Cora-sized random graph (full_graph_sm),
    forward checked against the CPU, then trained; on a Reddit-sized
    Erdos-Renyi graph, 1024 seeds sampled 15-10 by the host sampler and
    padded (minibatch_lg), one training step."""
    import torch
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs.families.gnn import FULL_DIMS
    from repro_torch.models.gnn import common, gat
    _reset_launches()
    arch = GNN_ARCHS["gat-cora"]
    res = {}

    # full_graph_sm: Cora's sizes (2708 nodes, 10556 edges, 1433 features)
    d = FULL_DIMS["full_graph_sm"]
    cfg = arch.full_cfg_fn(d["d"])
    n_real, e_real = CORA
    g = common.pad_graph(*_cora_edges(SEED + 60), n_real, d["E"], d["N"],
                         device=GNN_DEVICE)
    gen = torch.Generator(device=GNN_DEVICE).manual_seed(SEED + 61)
    params = gat.init_params(cfg, gen, device=GNN_DEVICE)
    x = torch.zeros((d["N"], d["d"]), device=GNN_DEVICE)
    x[:n_real] = torch.randn((n_real, d["d"]), generator=gen,
                             device=GNN_DEVICE)
    labels = torch.randint(0, cfg.n_classes, (d["N"],), generator=gen,
                           device=GNN_DEVICE)
    mask = g.node_mask.float()
    with torch.no_grad():
        cpu_logits = gat.forward(cfg, _to_cpu(params), x.cpu(),
                                 _graph_on(g, "cpu"))
    sm = res["full_graph_sm"] = _gat_timed(cfg, params, x, g, labels, mask,
                                           "gnn_gat full_graph_sm")
    sm["cpu_err"] = _scale_err(sm.pop("logits").cpu(), cpu_logits)
    if sm["cpu_err"] > F32_SCALE_TOL:
        raise AssertionError(f"gnn_gat: logits differ from the CPU's by "
                             f"{sm['cpu_err']} of scale")
    sm.update(nodes=n_real, edges=e_real, N=d["N"], E=d["E"],
              n_params=cfg.n_params())
    del params, x, g
    print(f"gnn_gat: full_graph_sm N={cfg.n_params()} ({n_real} nodes, "
          f"{e_real} edges, padded {d['N']} / {d['E']}): forward "
          f"{sm['forward_ms']:.3f} ms (card vs CPU {sm['cpu_err']:.3e} of "
          f"scale), train step {sm['step_ms']} ms, device {sm['profile']} "
          f"(idle share {sm['idle_share']}), peak "
          f"{sm['memory_peak_gb']:.3f} GB, losses {sm['losses']}")

    # minibatch_lg: Reddit's sizes, host sampler 15-10 around 1024 seeds
    d = FULL_DIMS["minibatch_lg"]
    cfg = arch.full_cfg_fn(d["d"])
    sample = _reddit_sample(d["seeds"])
    node_ids, s, r, seeds = (sample[k] for k in ("node_ids", "s", "r",
                                                 "seeds"))
    t0, t1, t2, t3, t4 = sample["clock"]
    gid = torch.from_numpy(node_ids).to(GNN_DEVICE)
    # the reference's second hop samples around the first hop's seeds too,
    # so it can draw more edges than FULL_DIMS' 168960: pad up to them
    N, E = _sample_padding(sample, d)
    g = common.pad_graph(s, r, len(node_ids), E, N, device=GNN_DEVICE)
    gen = torch.Generator(device=GNN_DEVICE).manual_seed(SEED + 65)
    params = gat.init_params(cfg, gen, device=GNN_DEVICE)
    table = torch.randn((REDDIT["n"], d["d"]), generator=gen,
                        device=GNN_DEVICE)
    x = torch.zeros((N, d["d"]), device=GNN_DEVICE)
    x[:len(node_ids)] = table[gid]
    del table
    labels = torch.randint(0, cfg.n_classes, (N,), generator=gen,
                           device=GNN_DEVICE)
    mask = torch.zeros(N, device=GNN_DEVICE)
    mask[:len(seeds)] = 1.0                        # the loss is on the seeds
    lg = res["minibatch_lg"] = _gat_timed(cfg, params, x, g, labels, mask,
                                          "gnn_gat minibatch_lg")
    lg.pop("logits")
    lg.update(graph_nodes=REDDIT["n"], graph_edges=REDDIT["m"],
              generate_s=t1 - t0, csr_s=t2 - t1, seeds_s=t3 - t2,
              sampler_host_ms=(t4 - t3) * 1e3, sampled_nodes=len(node_ids),
              sampled_edges=len(s), N=N, E=E, full_dims=(d["N"], d["E"]))
    del params, x, g
    gc.collect()
    torch.cuda.empty_cache()
    print(f"gnn_gat: minibatch_lg graph {REDDIT['n']} nodes / {REDDIT['m']} "
          f"edges (generated {lg['generate_s']:.1f} s, CSR on the card "
          f"{lg['csr_s']:.1f} s); sampler {MINIBATCH_FANOUTS} around "
          f"{len(seeds)} seeds: {lg['sampler_host_ms']:.1f} ms on the host, "
          f"{len(node_ids)} nodes, {len(s)} edges, padded {N} / {E} "
          f"(FULL_DIMS {d['N']} / {d['E']}); forward "
          f"{lg['forward_ms']:.3f} ms, train step {lg['step_ms']} ms, device "
          f"{lg['profile']} (idle share {lg['idle_share']}), peak "
          f"{lg['memory_peak_gb']:.3f} GB, losses {lg['losses']}")
    res["launches"] = _assert_no_launches("gnn_gat")
    res["sample"] = sample                   # the cells phase reuses it
    out["gnn_gat"] = res


def _item_rows(cfg, rows: int, gen):
    """Item sequences on the card: random items, MASK last, the first
    quarter of every fourth row PAD."""
    import torch
    items = torch.randint(2, cfg.n_items, (rows, cfg.seq_len),
                          generator=gen, device=GNN_DEVICE)
    items[::4, :cfg.seq_len // 4] = cfg.PAD
    items[:, -1] = cfg.MASK
    return items


def _latencies(fn, calls: int) -> dict:
    """Host-clock ms of ``calls`` synchronised calls of ``fn`` after one
    warm-up: median and p99."""
    import torch
    fn()
    ms = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "ms": ms}


def phase_recsys(out: dict) -> None:
    """bert4rec at its full configuration (1 M items, d 64, 2 blocks, 2
    heads, seq 200): serve_p99, retrieval_cand, serve_bulk and
    train_batch, each timed and checked."""
    import torch
    from repro_torch.configs import RECSYS_ARCHS
    from repro_torch.configs.families.recsys import FULL
    from repro_torch.models import bert4rec as B
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    _reset_launches()
    cfg = RECSYS_ARCHS["bert4rec"].full_cfg
    gen = torch.Generator(device=GNN_DEVICE).manual_seed(SEED + 70)
    params = B.init_params(cfg, gen, device=GNN_DEVICE)
    res = {"n_params": cfg.n_params()}

    # serve_p99: score_next at batch 512
    bsz = FULL["serve_p99"]["batch"]
    items = _item_rows(cfg, bsz, gen)
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        lat = _latencies(lambda: B.score_next(cfg, params, items), P99_CALLS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        busy = _device_busy(lambda: B.score_next(cfg, params, items))
        got = B.score_next(cfg, params, items[:8])
        want = B.score_next(cfg, _to_cpu(params), items[:8].cpu())
    p99 = res["serve_p99"] = dict(
        batch=bsz, rows_per_s=bsz / lat["p50_ms"] * 1e3,
        memory_peak_gb=peak, profile=busy,
        idle_share=_idle_share(busy["device_ms"], lat["p50_ms"]),
        cpu_err=_scale_err(got.cpu(), want), **lat)
    if p99["cpu_err"] > F32_SCALE_TOL:
        raise AssertionError(f"recsys: score_next differs from the CPU's by "
                             f"{p99['cpu_err']} of scale")
    print(f"recsys: bert4rec N={cfg.n_params()}; serve_p99 batch {bsz}: "
          f"score_next p50 {p99['p50_ms']:.3f} ms, p99 {p99['p99_ms']:.3f} "
          f"ms ({p99['rows_per_s']:.1f} rows/s), device {busy} (idle share "
          f"{p99['idle_share']}), peak {peak:.3f} GB; card vs CPU "
          f"{p99['cpu_err']:.3e} of scale")

    # retrieval_cand: one query against 1 M candidates
    n_cand = FULL["retrieval_cand"]["n_cand"]
    cands = torch.randperm(cfg.n_items, generator=gen,
                           device=GNN_DEVICE)[:n_cand]
    q = items[:1]
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        lat = _latencies(lambda: B.score_candidates(cfg, params, q, cands),
                         P99_CALLS)
        busy = _device_busy(lambda: B.score_candidates(cfg, params, q,
                                                       cands))
        got = B.score_candidates(cfg, params, q, cands)
        want = B.score_next(cfg, params, q)[0, cands]
    if not torch.allclose(got, want, rtol=2e-4, atol=1e-4):
        raise AssertionError("recsys: score_candidates differs from "
                             "score_next's columns")
    rc = res["retrieval_cand"] = dict(
        n_cand=n_cand, candidates_per_s=n_cand / lat["p50_ms"] * 1e3,
        memory_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=busy, idle_share=_idle_share(busy["device_ms"],
                                             lat["p50_ms"]),
        max_abs_err=(got - want).abs().max().item(), **lat)
    print(f"recsys: retrieval_cand {n_cand} candidates: p50 "
          f"{rc['p50_ms']:.3f} ms, p99 {rc['p99_ms']:.3f} ms, device {busy} "
          f"(idle share {rc['idle_share']}); against score_next's columns "
          f"max |err| {rc['max_abs_err']:.3e}")

    # serve_bulk: score_topk, k 100, chunk 4096, as many chunks as fit
    bulk = FULL["serve_bulk"]
    k, chunk = bulk["topk"], bulk["chunk"]
    with torch.no_grad():
        first = _item_rows(cfg, chunk, gen)
        torch.cuda.reset_peak_memory_stats()
        one = _latencies(lambda: B.score_topk(cfg, params, first, k=k,
                                              chunk=chunk), 1)["ms"][0]
        n_chunks = int(min(bulk["batch"] // chunk,
                           max(1, BULK_SECONDS * 1e3 // one)))
        rows = _item_rows(cfg, n_chunks * chunk, gen)
        rows[:chunk] = first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, idx = B.score_topk(cfg, params, rows, k=k, chunk=chunk)
        torch.cuda.synchronize()
        bulk_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        busy = _device_busy(lambda: B.score_topk(cfg, params, first, k=k,
                                                 chunk=chunk))
        scores = B.score_next(cfg, params, first)
        want_v, want_i = torch.topk(scores, k + 1)
        untied = (want_v[:, 1:] != want_v[:, :-1]).all(dim=1)
        ok = (torch.equal(vals[:chunk], want_v[:, :k])
              and torch.equal(torch.gather(scores, 1, idx[:chunk]),
                              vals[:chunk])
              and torch.equal(idx[:chunk][untied], want_i[untied, :k]))
        del scores
    if not ok:
        raise AssertionError("recsys: score_topk differs from torch.topk of "
                             "score_next")
    sb = res["serve_bulk"] = dict(
        rows=n_chunks * chunk, cell_rows=bulk["batch"], k=k, chunk=chunk,
        seconds=bulk_s, rows_per_s=n_chunks * chunk / bulk_s,
        chunk_ms=bulk_s / n_chunks * 1e3, memory_peak_gb=peak,
        profile_one_chunk=busy, idle_share=_idle_share(
            busy["device_ms"], bulk_s / n_chunks * 1e3),
        checked_rows=chunk, tied_rows=int((~untied).sum()))
    cut_note = "all of them" if sb["rows"] == bulk["batch"] else \
        f"cut to ~{BULK_SECONDS:.0f} s"
    print(f"recsys: serve_bulk {sb['rows']} of {bulk['batch']} rows "
          f"({n_chunks} chunks of {chunk}, {cut_note}), "
          f"top {k}: {bulk_s:.2f} s ({sb['rows_per_s']:.1f} rows/s, "
          f"{sb['chunk_ms']:.1f} ms a chunk), device a chunk {busy} (idle "
          f"share {sb['idle_share']}), peak {peak:.3f} GB; first chunk "
          f"against torch.topk: equal ({sb['tied_rows']} rows with ties)")
    del rows, vals, idx, first
    torch.cuda.empty_cache()

    # train_batch: 65536 sequences, 20 masks, 8192 shared negatives, as 8
    # microbatches of 8192 through Trainer(grad_accum=8)
    tb = FULL["train_batch"]
    micro = tb["batch"] // RECSYS_ACCUM

    def batch_at(step):
        g = torch.Generator(device=GNN_DEVICE).manual_seed(SEED + 80 + step)
        seq = torch.randint(2, cfg.n_items, (tb["batch"], cfg.seq_len),
                            generator=g, device=GNN_DEVICE)
        pos = torch.argsort(torch.rand((tb["batch"], cfg.seq_len),
                                       generator=g, device=GNN_DEVICE),
                            dim=1)[:, :tb["n_mask"]]
        tgt = torch.gather(seq, 1, pos)
        seq.scatter_(1, pos, cfg.MASK)
        neg = torch.randint(2, cfg.n_items, (tb["n_neg"],), generator=g,
                            device=GNN_DEVICE)
        return dict(items=seq.reshape(RECSYS_ACCUM, micro, -1),
                    pos=pos.reshape(RECSYS_ACCUM, micro, -1),
                    tgt=tgt.reshape(RECSYS_ACCUM, micro, -1),
                    neg=neg.expand(RECSYS_ACCUM, -1))

    tr = Trainer(TrainerConfig(ckpt_dir=str(ROOT / "build" / "recsys_ckpt"),
                               ckpt_every=10 ** 9, grad_accum=RECSYS_ACCUM),
                 adamw.AdamWConfig(),
                 lambda p, b: B.sampled_masked_loss(cfg, p, b["items"],
                                                    b["pos"], b["tgt"],
                                                    b["neg"]),
                 params, device=GNN_DEVICE)
    del params
    _train_timed(tr, [batch_at(0)], "recsys train_batch")
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _train_timed(tr, [batch_at(1)], "recsys train_batch")
    batch = batch_at(2)
    prof = _device_busy(lambda: tr.step(batch))
    tr_res = res["train_batch"] = dict(
        sequences=tb["batch"], microbatches=RECSYS_ACCUM, n_mask=tb["n_mask"],
        n_neg=tb["n_neg"], step_ms=step_ms, losses=losses,
        sequences_per_s=tb["batch"] / step_ms[0] * 1e3,
        memory_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=prof, idle_share=_idle_share(prof["device_ms"], step_ms[0]))
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"recsys: train_batch {tb['batch']} sequences as {RECSYS_ACCUM} x "
          f"{micro}, {tb['n_mask']} masks, {tb['n_neg']} shared negatives: "
          f"step {step_ms[0]:.1f} ms ({tr_res['sequences_per_s']:.1f} "
          f"sequences/s), device {prof} (idle share {tr_res['idle_share']}),"
          f" peak {tr_res['memory_peak_gb']:.3f} GB, loss {losses}")
    res["launches"] = _assert_no_launches("recsys")
    out["recsys"] = res


# ---------------------------------------------------------------------------
# 19. cells: the cell programs of every architecture
# ---------------------------------------------------------------------------

CELL_SEED = 9
CELL_REPS = 3                # timed steps of a full-width cell, after one
# a reduced train cell's optimizer step: past OPT_CFG's 200 warm-up steps,
# where lr is ~1e-4 and a parameter of ~0.05 moves by ~1e-4, so the update
# reads above F32_SCALE_TOL of the parameters' scale (at step 0 lr is 5e-7
# and the update is lost under it)
CELL_STEP = 1000
# and its update (new minus old params, m and v) on the card within this
# share of the CPU's largest |update|, leaf by leaf (f32; the bf16
# fused_agg build within BF16_SCALE_TOL)
UPDATE_SCALE_TOL = 1e-3
# the cells test_optimized_builds_smoke builds with optimized=True
OPTIMIZED_CELLS = [("bert4rec", "serve_bulk"), ("mace", "molecule"),
                   ("qwen2-1.5b", "train_4k")]
# a bf16 model's first step against its direct call: the same kernels on
# the same inputs, within bf16's rounding of the values' scale
BF16_DIRECT_TOL = 1e-2
# the LM cells at full width and full sequence length on one card, the
# batch cut through the arch's own shapes record (LMShapes): train 8 x
# 4096 in 8 microbatches of 1 (the cell's 32 x 4096 microbatch makes
# 80 GB of f32 logits), prefill 1 x 32768, decode 8 of a 32768-slot cache.
# The last entry, where not None, is the number of timed steps instead of
# CELL_REPS: chatglm3-6b's prefill takes 21.9 s a step on an H100 at its
# 28 layers, so it is timed once, after the direct call and the profiled
# step, and runs at full depth
LM_FULL_CELLS = [
    ("qwen2-1.5b", "train_4k", dict(train_batch=8, grad_accum=8), None),
    ("qwen2-1.5b", "prefill_32k", dict(prefill_batch=1), None),
    ("qwen2-1.5b", "decode_32k", dict(decode_batch=8), None),
    ("olmoe-1b-7b", "prefill_32k", dict(prefill_batch=1), None),
    ("olmoe-1b-7b", "decode_32k", dict(decode_batch=8), None),
    ("chatglm3-6b", "prefill_32k", dict(prefill_batch=1), 1),
    ("chatglm3-6b", "decode_32k", dict(decode_batch=8), None)]
GNN_FULL_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg")
RECSYS_FULL_SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand")
# minibatch_lg runs where its peak, reckoned from the same arch's
# full_graph_sm peak in this run times the larger of the two cells' node
# and edge ratios, stays under this
RECKON_LIMIT_GB = 70.0
# why a cell runs in the dry run only
DRY_ONLY = {
    "mixtral-8x7b": "93 GB of bf16 weights: more than one card holds",
    "qwen1.5-32b": "70 GB of bf16 weights: with its logits, caches or "
                   "optimizer state more than one card holds",
    ("olmoe-1b-7b", "train_4k"): "bf16 params, f32 grads and AdamW "
                                 "moments: ~97 GB",
    ("chatglm3-6b", "train_4k"): "bf16 params, f32 grads and AdamW "
                                 "moments: ~87 GB",
    ("bert4rec", "train_batch"): "65536 sequences in one step: the "
                                 "[65536, 2, 200, 200] attention and "
                                 "[65536, 20, 8192] negative logits are "
                                 "21 and 43 GB each, with their gradients "
                                 "over 80 GB (the recsys phase runs it as "
                                 "8 microbatches)",
    "ogb_products": "61.9 M edges: several cards' worth of activations"}


def _leaves_close(got, want, tol: float, what: str) -> float:
    """Every leaf of ``got`` (on the card) against ``want``: floats within
    ``tol`` of their scale and finite, others equal.  The largest scale
    error."""
    import torch
    from repro_torch.tree import leaves
    worst = 0.0
    gl, wl = leaves(got), leaves(want)
    if len(gl) != len(wl) or not gl:
        raise AssertionError(f"cells {what}: {len(gl)} outputs, want "
                             f"{len(wl)}")
    for g, w in zip(gl, wl):
        g, w = g.detach().cpu(), w.detach().cpu()
        if g.dtype.is_floating_point:
            if not torch.isfinite(g).all():
                raise AssertionError(f"cells {what}: non-finite output")
            err = _scale_err(g, w)
            worst = max(worst, err)
            if not err <= tol:
                raise AssertionError(f"cells {what}: an output differs by "
                                     f"{err} of its scale (> {tol})")
        elif not torch.equal(g, w):
            raise AssertionError(f"cells {what}: an integer output differs")
    return worst


def _reduced_args(aid: str, sid: str, prog):
    """A reduced cell's arguments on the CPU: zeros_from_abstract's, a
    train cell at CELL_STEP, and a GNN cell's graph drawn in range (no
    self-loops, masks half set, GAT's labels and the equivariant nets'
    species within their counts): all-zero integers mask every node and
    edge out, and the gradients vanish."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.families.base import zeros_from_abstract
    from repro_torch.configs.families.gnn import REDUCED_DIMS
    args = list(zeros_from_abstract(prog.abstract_args, seed=CELL_SEED,
                                    device="cpu"))
    if prog.kind == "train":
        args[3] = torch.tensor(CELL_STEP, dtype=torch.int32)
    arch = ARCHS[aid]
    if arch.family != "gnn":
        return tuple(args)
    dims = REDUCED_DIMS[sid]
    N, E = dims["N"], dims["E"]
    cfg = arch.smoke_cfg_fn(dims["d"])
    gen = torch.Generator().manual_seed(CELL_SEED)

    def ints(bound, n):
        return torch.randint(0, bound, (n,), generator=gen)

    receivers = ints(N, E)
    at = 5 if arch.kind == "gat" else 6           # the graph's argument
    graph = dict(senders=(receivers + 1 + ints(N - 1, E)) % N,
                 receivers=receivers, node_mask=ints(2, N) == 1,
                 edge_mask=ints(2, E) == 1,
                 graph_ids=ints(dims["n_graphs"], N))
    args[at] = {k: graph[k].to(v.dtype) for k, v in args[at].items()}
    if arch.kind == "gat":
        args[6] = ints(cfg.n_classes, args[6].numel()).to(args[6].dtype)
    elif arch.kind != "egnn":
        args[4] = ints(cfg.n_species, args[4].numel()).to(args[4].dtype)
    return tuple(args)


def _update_close(args, got, want, tol: float, what: str) -> float:
    """A train step's update (outputs 0-2, new params, m and v, minus the
    arguments) on the card against the CPU's: every leaf within ``tol`` of
    the CPU update's largest magnitude, which is not 0.  The largest such
    error."""
    from repro_torch.tree import leaves
    worst = 0.0
    for part in range(3):
        for o, g, w in zip(leaves(args[part]), leaves(got[part]),
                           leaves(want[part])):
            o = o.detach().cpu().double()
            du = g.detach().cpu().double() - o
            dw = w.detach().cpu().double() - o
            scale = dw.abs().max().item()
            if not scale > 0:
                raise AssertionError(f"cells {what}: a leaf did not move")
            err = (du - dw).abs().max().item() / scale
            worst = max(worst, err)
            if not err <= tol:
                raise AssertionError(f"cells {what}: an update differs by "
                                     f"{err} of its scale (> {tol})")
    return worst


def _cells_reduced(res: dict) -> None:
    """Every runnable cell at reduced=True, and the three optimized
    builds: one step on the card, held against the same step on the CPU
    (f32 within 1e-4 of the scale; the bf16 fused_agg build within 0.1),
    and a train cell's update within UPDATE_SCALE_TOL of its scale (bf16:
    BF16_SCALE_TOL)."""
    import torch
    from repro_torch.configs import ARCHS, all_cells, get_arch
    from repro_torch.tree import tree_map
    runs = [(a, s, False) for a, s in all_cells()
            if ARCHS[a].skip_reason(s) is None]
    runs += [(a, s, True) for a, s in OPTIMIZED_CELLS]
    t0 = time.perf_counter()
    errs, update_errs = {}, {}
    for aid, sid, opt in runs:
        prog = get_arch(aid).build(sid, reduced=True, optimized=opt)
        args = _reduced_args(aid, sid, prog)
        on_card = tree_map(lambda x: x.to(GNN_DEVICE), args)
        want = prog.step_fn(*args)
        got = prog.step_fn(*on_card)
        bf16 = opt and aid == "mace"
        label = f"{aid}/{sid}{' optimized' if opt else ''}"
        errs[label] = _leaves_close(
            got, want, BF16_SCALE_TOL if bf16 else F32_SCALE_TOL,
            f"reduced {label}")
        if prog.kind == "train":
            update_errs[label] = _update_close(
                args, got, want,
                BF16_SCALE_TOL if bf16 else UPDATE_SCALE_TOL,
                f"reduced {label}")
    torch.cuda.synchronize()
    bf16_label = "mace/molecule optimized"
    r = res["reduced"] = dict(
        cells=len(runs), seconds=time.perf_counter() - t0, errs=errs,
        worst_f32=max(e for k, e in errs.items() if k != bf16_label),
        bf16=errs[bf16_label], step=CELL_STEP, update_errs=update_errs,
        worst_f32_update=max(e for k, e in update_errs.items()
                             if k != bf16_label),
        bf16_update=update_errs[bf16_label])
    print(f"cells: {len(runs)} reduced cells ({len(runs) - 3} + 3 optimized)"
          f" on the card against the CPU in {r['seconds']:.1f} s; worst "
          f"scale error f32 {r['worst_f32']:.3e} (bound {F32_SCALE_TOL}), "
          f"bf16 {r['bf16']:.3e} (bound {BF16_SCALE_TOL}); "
          f"{len(update_errs)} train cells at step {CELL_STEP}, worst update "
          f"error f32 {r['worst_f32_update']:.3e} of its scale (bound "
          f"{UPDATE_SCALE_TOL}), bf16 {r['bf16_update']:.3e} (bound "
          f"{BF16_SCALE_TOL})")


def _cells_dtensor(res: dict) -> None:
    """The reduced qwen2-1.5b train_4k cell through DTensor on the card:
    its arguments placed by their arg_specs (``reshard``) on a
    make_host_mesh(1) over a one-rank NCCL group, the step (at CELL_STEP)
    run under implicit_replication, equal to the plain run, and its update
    within UPDATE_SCALE_TOL of the plain run's."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_arch
    from repro_torch.configs.families.base import spec_lookup
    from repro_torch.launch.collective_stats import (collective_bytes,
                                                     record_step_collectives)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import reshard
    from repro_torch.tree import leaves, tree_map
    _nccl_rank()
    try:
        mesh = make_host_mesh(1)
        prog = get_arch("qwen2-1.5b").build("train_4k", reduced=True)
        args = tree_map(lambda x: x.to(GNN_DEVICE),
                        _reduced_args("qwen2-1.5b", "train_4k", prog))
        want = prog.step_fn(*tree_map(lambda x: x.clone(), args))
        placed = reshard(args, mesh, spec_lookup(prog.arg_specs))
        with record_step_collectives() as rec, implicit_replication():
            got = prog.step_fn(*placed)
        n_dt = sum(isinstance(x, DTensor) for x in leaves(got))
        got = tree_map(lambda x: x.full_tensor()
                       if isinstance(x, DTensor) else x, got)
        err = _leaves_close(got, want, F32_SCALE_TOL, "dtensor")
        update_err = _update_close(args, got, want, UPDATE_SCALE_TOL,
                                   "dtensor")
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    res["dtensor"] = dict(mesh=str(mesh), outputs=len(leaves(got)),
                          dtensors=n_dt, scale_err=err, step=CELL_STEP,
                          update_err=update_err,
                          collectives=collective_bytes(rec))
    print(f"cells: DTensor qwen2-1.5b/train_4k reduced on {mesh}: "
          f"{n_dt} of {len(leaves(got))} outputs DTensors, against the plain "
          f"run {err:.3e} of scale, its update at step {CELL_STEP} "
          f"{update_err:.3e} of the update's scale; collectives "
          f"{collective_bytes(rec)}")


def _lm_full_inputs(arch, sid, prog, gen):
    """Seeded weights at the model's dtype and random tokens; decode: a
    KV cache filled with random keys and values at positions 0..S-1, and
    the batch's next token at position S-1 (every slot attended)."""
    import torch
    from repro_torch.models import transformer as T
    cfg = arch._cfg(sid, False)
    params = T.init_params(cfg, gen, device=GNN_DEVICE)
    V = cfg.vocab

    def tokens(shape):
        return torch.randint(0, V, shape, generator=gen, device=GNN_DEVICE,
                             dtype=torch.int32)

    if sid == "train_4k":
        _, m, v, st, tok, _ = prog.abstract_args
        f32 = torch.float32
        return cfg, (params, *(_zeros_like(t, f32) for t in (m, v)),
                     torch.zeros((), dtype=torch.int32, device=GNN_DEVICE),
                     tokens(tok.shape), tokens(tok.shape))
    if sid == "prefill_32k":
        return cfg, (params, tokens(prog.abstract_args[1].shape))
    B = prog.abstract_args[2].shape[0]
    S = arch.shapes.decode_seq
    cache = T.init_cache(cfg, B, S, device=GNN_DEVICE)
    for name in ("k", "v"):
        cache[name].normal_(generator=gen)
    cache["pos"].copy_(torch.arange(S, dtype=torch.int32,
                                    device=GNN_DEVICE).expand_as(
                                        cache["pos"]))
    return cfg, (params, cache, tokens((B,)),
                 torch.full((B,), S - 1, dtype=torch.int32,
                            device=GNN_DEVICE))


def _zeros_like(tree, dtype):
    """Zeros on the card in the shapes of a tree of meta tensors."""
    import torch
    from repro_torch.tree import tree_map
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype,
                                          device=GNN_DEVICE), tree)


def _lm_direct(cfg, sid, args):
    """The model function called directly on a cell's inputs: lm_loss
    averaged over the microbatches, forward's logits, or decode_step's."""
    import torch
    from repro_torch.models import transformer as T
    if sid == "train_4k":
        tok, tgt = args[4], args[5]
        return torch.stack([T.lm_loss(cfg, args[0], tok[i], tgt[i])
                            for i in range(tok.shape[0])]).mean()
    if sid == "prefill_32k":
        return T.forward(cfg, args[0], args[1])[0]
    return T.decode_step(cfg, *args)[0]


def _first_of(sid: str, first):
    """The part of an LM step's output the direct call gives: the train
    step's loss, the decode step's logits, or prefill's logits."""
    if sid == "train_4k":
        return first[-1]
    if sid == "decode_32k":
        return first[0]
    return first


def _gnn_full_inputs(arch, sid, prog, gen, data: dict):
    """Seeded weights, zero moments, and the shape's real data: a
    Cora-sized random graph, the molecule batch, or the Reddit-sized
    15-10 sample padded to what it drew; features, species, coordinates
    (a 4 A box) and targets drawn from ``gen``."""
    import torch
    from repro_torch.configs.families.gnn import FULL_DIMS, _eq_init
    from repro_torch.models.gnn import common, gat
    d = FULL_DIMS[sid]
    cfg = arch.full_cfg_fn(d["d"])
    if sid == "molecule":
        mol = data["molecule"]
        g, N = mol["g"], d["N"]
    elif sid == "full_graph_sm":
        N = d["N"]
        g = common.pad_graph(*_cora_edges(SEED + 60), CORA[0], d["E"], N,
                             device=GNN_DEVICE)
    else:
        sample = data["sample"]
        N, E = _sample_padding(sample, d)
        g = common.pad_graph(sample["s"], sample["r"],
                             len(sample["node_ids"]), E, N,
                             device=GNN_DEVICE)
    gd = dict(senders=g.senders.int(), receivers=g.receivers.int(),
              node_mask=g.node_mask, edge_mask=g.edge_mask,
              graph_ids=g.graph_ids.int())
    E = g.senders.shape[0]
    params = (gat.init_params(cfg, gen, device=GNN_DEVICE)
              if arch.kind == "gat" else
              _eq_init(arch.kind, cfg, gen, GNN_DEVICE))
    m, v = (_zeros_like(t, torch.float32) for t in prog.abstract_args[1:3])
    st = torch.zeros((), dtype=torch.int32, device=GNN_DEVICE)
    n_graphs = d["n_graphs"]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=GNN_DEVICE)

    if arch.kind == "gat":
        if sid == "molecule":
            labels = torch.randint(0, cfg.n_classes, (n_graphs,),
                                   generator=gen, device=GNN_DEVICE)
            mask = torch.ones(n_graphs, device=GNN_DEVICE)
        else:
            labels = torch.randint(0, cfg.n_classes, (N,), generator=gen,
                                   device=GNN_DEVICE)
            mask = g.node_mask.float()
        x = normal(N, d["d"]) * g.node_mask[:, None]
        args = (params, m, v, st, x, gd, labels.int(), mask)
    else:
        if arch.kind == "egnn":
            x = normal(N, d["d"]) * g.node_mask[:, None]
        else:
            x = torch.randint(0, cfg.n_species, (N,), generator=gen,
                              device=GNN_DEVICE, dtype=torch.int32)
        coords = mol["coords"] if sid == "molecule" else \
            torch.rand((N, 3), generator=gen, device=GNN_DEVICE) * MOL_BOX
        if sid == "molecule":
            extra = (normal(n_graphs), normal(N, 3))
        else:
            extra = (normal(n_graphs), torch.ones(n_graphs,
                                                  device=GNN_DEVICE))
        args = (params, m, v, st, x, coords, gd) + extra
    return cfg, N, E, args


def _recsys_full_inputs(arch, sid, prog, gen):
    import torch
    from repro_torch.models import bert4rec as B
    cfg = arch.full_cfg
    params = B.init_params(cfg, gen, device=GNN_DEVICE)
    if sid == "retrieval_cand":
        n = prog.abstract_args[2].shape[0]
        cands = torch.randperm(cfg.n_items, generator=gen,
                               device=GNN_DEVICE)[:n].int()
        return cfg, (params, _item_rows(cfg, 1, gen).int(), cands)
    rows = prog.abstract_args[1].shape[0]
    return cfg, (params, _item_rows(cfg, rows, gen).int())


def _recsys_direct(cfg, sid, args):
    """score_next, score_candidates, or score_topk on the first chunk of
    rows, called directly."""
    from repro_torch.configs.families.recsys import FULL
    from repro_torch.models import bert4rec as B
    if sid == "serve_p99":
        return B.score_next(cfg, *args)
    if sid == "retrieval_cand":
        return B.score_candidates(cfg, *args)
    bulk = FULL["serve_bulk"]
    chunk = bulk["chunk"]
    return B.score_topk(cfg, args[0], args[1][:chunk], k=bulk["topk"],
                        chunk=chunk)


def _bulk_compare(first, want) -> float:
    """serve_bulk: the first chunk's top-k indices equal, values within
    the scale error returned."""
    import torch
    chunk = want[1].shape[0]
    if not torch.equal(first[1][:chunk], want[1]):
        raise AssertionError("cells serve_bulk: top-k indices differ from "
                             "score_topk's on the first chunk")
    return _scale_err(first[0][:chunk], want[0])


def _finite(x) -> bool:
    """Whether every element of ``x`` is finite, from one f32 sum (a NaN
    or an infinity makes it non-finite): ``torch.isfinite`` builds
    full-size temporaries, 34 GB over olmoe-1b-7b's KV cache."""
    import torch
    return bool(torch.isfinite(x.sum(dtype=torch.float32)))


def _full_step(label, prog, args, flops_ran, dtype, direct, compare,
               reduced, reps: int = CELL_REPS) -> dict:
    """One cell at full width: the model function called directly
    (``direct()``, also the warm-up); the first step under FlopCounterMode
    and the profiler (device busy), its output held against the direct
    call (``compare(first, want)``, a scale error) and checked finite;
    then ``reps`` timed steps (median) and their memory peak."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.tree import leaves
    resident = torch.cuda.memory_allocated() / 1e9
    t_start = time.perf_counter()
    with torch.no_grad():
        want = direct()
    torch.cuda.synchronize()
    kept = []
    with FlopCounterMode(display=False) as fc:
        busy = _device_busy(lambda: kept.append(prog.step_fn(*args)))
    first = kept.pop()
    t_profiled = time.perf_counter()
    for x in leaves(first):
        if x.dtype.is_floating_point and not _finite(x):
            raise AssertionError(f"cells {label}: non-finite output")
    err = compare(first, want)
    tol = BF16_DIRECT_TOL if dtype == torch.bfloat16 else F32_SCALE_TOL
    if not err <= tol:
        raise AssertionError(f"cells {label}: the step's output differs "
                             f"from the direct call by {err} of scale")
    del first, want
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prog.step_fn(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        del out
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(ms)
    counted = float(fc.get_total_flops())
    r = dict(kind=prog.kind, step_ms=step_ms, ms=ms, memory_peak_gb=peak,
             resident_gb=resident, profile=busy,
             idle_share=_idle_share(busy["device_ms"], step_ms),
             counted_flops=counted, model_flops=flops_ran,
             counted_over_model=counted / flops_ran if flops_ran else None,
             direct_err=err, reduced=reduced,
             seconds=time.perf_counter() - t_start,
             direct_and_profiled_s=t_profiled - t_start)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"cells: {label} {prog.kind}: step {step_ms:.1f} ms median of "
          f"{[round(t, 1) for t in ms]}, peak {peak:.3f} GB (inputs "
          f"{resident:.3f} GB), device {busy['device_ms']} ms in "
          f"{busy['device_events']} events (idle share {r['idle_share']}), "
          f"top {busy['top_ms'][:2]}, FLOPs counted {counted:.4e} / model "
          f"{flops_ran:.4e}, against the direct call {err:.3e} of scale; "
          f"cuts {reduced}; {r['seconds']:.1f} s in all")
    return r


def _cells_full(res: dict, data: dict) -> None:
    """The cells that fit one card, at full width (see LM_FULL_CELLS,
    GNN_FULL_SHAPES, RECSYS_FULL_SHAPES); minibatch_lg where its reckoned
    peak stays under RECKON_LIMIT_GB."""
    import dataclasses
    import torch
    from repro_torch.configs import GNN_ARCHS, get_arch
    from repro_torch.configs.families.gnn import FULL_DIMS
    from repro_torch.configs.families.gnn import model_flops as \
        gnn_model_flops
    from repro_torch.configs.families.lm import LMShapes
    from repro_torch.configs.families.recsys import FULL
    full = res["full"] = {}
    gen = torch.Generator(device=GNN_DEVICE).manual_seed(SEED + 90)
    t0 = time.perf_counter()
    for aid, sid, cut, reps in LM_FULL_CELLS:
        arch = dataclasses.replace(get_arch(aid), shapes=LMShapes(**cut))
        cuts = [f"{k} {v}" for k, v in cut.items()]
        prog = arch.build(sid)
        cfg, args = _lm_full_inputs(arch, sid, prog, gen)
        full[f"{aid}/{sid}"] = _full_step(
            f"{aid}/{sid}", prog, args, prog.model_flops, cfg.dtype,
            lambda: _lm_direct(cfg, sid, args),
            lambda first, want: _scale_err(_first_of(sid, first), want),
            cuts, CELL_REPS if reps is None else reps)
        del prog, args
        gc.collect()
        torch.cuda.empty_cache()
    for sid in GNN_FULL_SHAPES:
        for aid, arch in GNN_ARCHS.items():
            label = f"{aid}/{sid}"
            d = FULL_DIMS[sid]
            if sid == "minibatch_lg":
                sm, N, E = FULL_DIMS["full_graph_sm"], *_sample_padding(
                    data["sample"], d)
                ratio = max(N / sm["N"], E / sm["E"])
                reckon = full[f"{aid}/full_graph_sm"]["memory_peak_gb"] * \
                    ratio
                if reckon >= RECKON_LIMIT_GB:
                    full[label] = dict(skipped=True, reckoned_peak_gb=reckon,
                                       ratio=ratio)
                    print(f"cells: {label} dry run only: its peak reckoned "
                          f"from full_graph_sm's x {ratio:.1f} is "
                          f"{reckon:.1f} GB (limit {RECKON_LIMIT_GB})")
                    continue
            prog = arch.build(sid)
            cfg, N, E, args = _gnn_full_inputs(arch, sid, prog, gen, data)
            flops = gnn_model_flops(arch.kind, cfg, N, E, d["d"])
            cuts = [] if (N, E) == (d["N"], d["E"]) else \
                [f"sample padded to N {N}, E {E} (cell N {d['N']}, E "
                 f"{d['E']})"]
            full[label] = _full_step(
                label, prog, args, flops, torch.float32,
                lambda: prog.loss_fn(args[0], *args[4:]).detach(),
                lambda first, want: _scale_err(first[-1], want), cuts)
            if sid == "minibatch_lg":
                full[label]["reckoned_peak_gb"] = reckon
            del prog, args
    arch = get_arch("bert4rec")
    for sid in RECSYS_FULL_SHAPES:
        prog = arch.build(sid)
        cfg, args = _recsys_full_inputs(arch, sid, prog, gen)
        full[f"bert4rec/{sid}"] = _full_step(
            f"bert4rec/{sid}", prog, args, prog.model_flops, torch.float32,
            lambda: _recsys_direct(cfg, sid, args),
            _bulk_compare if sid == "serve_bulk" else _scale_err, [])
        if sid == "serve_bulk":
            full[f"bert4rec/{sid}"]["rows"] = FULL[sid]["batch"]
        del prog, args
    res["full_seconds"] = time.perf_counter() - t0


def _cells_dryrun(res: dict) -> None:
    """The dry run of all 40 cells on both production meshes, as a
    table, with the reason each cell not run at full width has."""
    from repro_torch.configs import ARCHS, all_cells
    from repro_torch.launch import dryrun
    recs = [dryrun.run_cell(a, s, mp, verbose=False, compiled=False)
            for a, s in all_cells() for mp in (False, True)]
    res["dryrun"] = recs
    print("cells: dry run (args whole GB / per device GiB / fit one card):")
    for r in recs:
        if r["status"] != "ok":
            print(f"  {r['arch']:13s} {r['shape']:14s} {r['mesh']:8s} "
                  f"skipped: {r['reason'][:60]}")
            continue
        print(f"  {r['arch']:13s} {r['shape']:14s} {r['mesh']:8s} "
              f"{r['kind']:11s} {r['arg_bytes'] / 1e9:9.3f} "
              f"{r['arg_bytes_per_dev'] / 2**30:7.3f} "
              f"{'fits' if r['args_fit_one_card'] else 'no'}  flops "
              f"{r['model_flops']:.3e}")
    ran = {k for k, v in res["full"].items() if not v.get("skipped")}
    for aid, sid in all_cells():
        if f"{aid}/{sid}" in ran or ARCHS[aid].skip_reason(sid):
            continue
        why = DRY_ONLY.get((aid, sid)) or DRY_ONLY.get(aid) or \
            DRY_ONLY.get(sid) or "peak reckoned over " \
            f"{RECKON_LIMIT_GB} GB from full_graph_sm's"
        print(f"cells: {aid}/{sid} not run at full width: {why}")


def phase_cells(out: dict) -> None:
    """The cell programs (repro_torch.configs): every runnable cell and
    the three optimized builds at reduced size, card against CPU; the
    reduced qwen2-1.5b train cell through DTensor on the NCCL rank; every
    cell that fits one card at full width, timed, traced and counted; the
    dry run of all 40 cells on both meshes."""
    _reset_launches()
    res: dict = {}
    _cells_reduced(res)
    _cells_dtensor(res)
    _cells_full(res, dict(molecule=_molecule_batch(SEED + 51),
                          sample=out["gnn_gat"]["sample"]))
    _cells_dryrun(res)
    res["launches"] = _assert_no_launches("cells")
    out["cells"] = res


# ---------------------------------------------------------------------------
# 20. examples
# ---------------------------------------------------------------------------

def _example(name: str):
    """``examples/<name>.py`` imported as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_examples(out: dict) -> None:
    """The two query examples on the card, through their own entry
    points; both kernels must launch in each."""
    res = {}
    for name, run in (("quickstart_torch", lambda m: m.main("cuda")),
                      ("distributed_queries_torch", lambda m: m.run("cuda"))):
        module = _example(name)
        _reset_launches()
        t0 = time.perf_counter()
        run(module)
        seconds = time.perf_counter() - t0
        launches = _launches()
        if not (launches["or_and_matmul"] and launches["min_plus_matmul"]):
            raise AssertionError(f"examples: {name} did not launch both "
                                 f"query kernels: {launches}")
        print(f"examples: {name} ok in {seconds:.1f} s, launches {launches}")
        res[name] = dict(launches=launches, seconds=seconds)
    out["examples"] = res


# ---------------------------------------------------------------------------
# 21. dryrun
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("qwen2-1.5b", "train_4k"), ("gat-cora", "full_graph_sm"),
                ("qwen1.5-32b", "decode_32k"), ("bert4rec", "train_batch"))
DRYRUN_WAIT_S = 600
DRYRUN_FIELDS = ("counter", "hlo_flops", "hlo_bytes", "temp_bytes_per_dev",
                 "out_bytes_per_dev", "peak_bytes_per_dev", "fits_one_card",
                 "collective_bytes", "collective_count",
                 "collective_breakdown", "collective_schedule",
                 "departure_collectives", "probe_flops", "probe_bytes",
                 "probe_collective_bytes", "probe_method")


def _start_dryrun() -> list:
    """The dryrun phase's cells, one CPU process each (CUDA hidden, at a
    lower priority), started before the first phase so that they run
    beside the phases on the card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    (ROOT / "build").mkdir(exist_ok=True)
    procs = []
    for aid, sid in DRYRUN_CELLS:
        path = ROOT / "build" / f"dryrun_{aid}_{sid}.json"
        log = open(path.with_suffix(".log"), "w")
        procs.append((aid, sid, path, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", aid,
             "--shape", sid, "--multi-pod", "no", "--out", str(path)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(10))))
    return procs


def phase_dryrun(out: dict, procs: list) -> None:
    """Each dry-run process's record: ok, with every compiled field."""
    import torch
    res = {}
    for aid, sid, path, log, proc in procs:
        rc = proc.wait(timeout=DRYRUN_WAIT_S)
        log.close()
        if rc != 0:
            raise AssertionError(
                f"dryrun: {aid}/{sid} exited {rc}:\n"
                f"{path.with_suffix('.log').read_text()[-3000:]}")
        (rec,) = json.loads(path.read_text())
        missing = [k for k in DRYRUN_FIELDS if k not in rec]
        if rec["status"] != "ok" or missing:
            raise AssertionError(f"dryrun: {aid}/{sid} lacks {missing}: "
                                 f"{rec}")
        communicates = rec["collective_count"] > 0 or any(
            d["count"] for d in rec["departure_collectives"].values())
        if rec["torch"] != torch.__version__ or not (
                rec["hlo_flops"] > 0 and rec["temp_bytes_per_dev"] > 0
                and communicates):
            raise AssertionError(f"dryrun: {aid}/{sid}: {rec}")
        departed = sum(d["bytes"]
                       for d in rec["departure_collectives"].values())
        print(f"dryrun: {aid}/{sid} {rec['mesh']} under torch "
              f"{rec['torch']} in {rec['seconds']} s: temp "
              f"{rec['temp_bytes_per_dev'] / 2**30:.2f} GiB/device, eager "
              f"FLOPs {rec['hlo_flops']:.4e}, collectives "
              f"{rec['collective_bytes'] / 2**20:.1f} MiB "
              f"({rec['collective_count']}; departures "
              f"{departed / 2**20:.1f} MiB), fits one card: "
              f"{rec['fits_one_card']}")
        print("dryrun record: " + json.dumps(rec))
        res[f"{aid}/{sid}"] = rec
    out["dryrun"] = res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    _require_repo()
    dry = _start_dryrun()
    try:
        return _main(dry)
    finally:
        for *_, proc in dry:
            proc.kill()
            proc.wait()


def _main(dry: list) -> int:
    import torch
    import torch.distributed as dist
    out: dict = {}
    out.update(phase_build())
    phase_parity()
    g, fr, queries, results = phase_main(out)
    _nccl_rank()
    try:
        phase_sharded(out, g, fr, queries, results)
        del queries, results
        phase_oneshot(out, g, fr)
        phase_baselines(out, g, fr)
        phase_mapreduce(out, g, fr)
        fr.rvset_cache = None
        del fr
        fr, sess = phase_dynamic(out, g)
        phase_serve(out, fr, sess)
        del fr, sess
        torch.cuda.empty_cache()
        fr, sess = phase_sharded_repair(out, g)
        del g
        phase_verify(out, sess)
        del fr, sess
        torch.cuda.empty_cache()
        phase_rpq(out)
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    for phase in (phase_lm_serve, phase_lm_moe, phase_lm_train,
                  phase_gnn_molecule, phase_gnn_gat, phase_recsys,
                  phase_cells, phase_examples,
                  functools.partial(phase_dryrun, procs=dry)):
        t0 = time.perf_counter()
        phase(out)
        print(f"{getattr(phase, '__name__', 'phase_dryrun')[6:]}: phase "
              f"took {time.perf_counter() - t0:.1f} s")
    kernels = out["kernels"]
    paths = {"main": out["main"]["launches"],
             "oneshot": out["oneshot"]["launches"],
             "oneshot_rpq": out["oneshot"]["rpq_launches"],
             "oneshot_sharded": out["oneshot"]["sharded"]["launches"],
             "baselines": out["baselines"]["launches"],
             "mapreduce": out["mapreduce"]["launches"],
             "verify": out["verify"]["launches"],
             "rpq": out["rpq"]["launches"],
             "serve_barrier": out["serve"]["barrier"]["launches"],
             **{f"dynamic_{mode}": n for mode, n in
                out["dynamic"]["launches_by_mode"].items()},
             **{f"sharded_repair_{mode}": n for mode, n in
                out["sharded_repair"]["launches_by_mode"].items()}}
    # the localEval kernel runs on the one-shot Reach and Dist paths alone
    # (the verifier's one-shot disReach among them)
    stray = {p: n["local_eval"] for p, n in paths.items()
             if n["local_eval"] and p not in ("oneshot", "oneshot_sharded",
                                              "baselines", "verify")}
    if stray:
        raise AssertionError(f"localEval launched off the one-shot paths: "
                             f"{stray}")
    for k in kernels:
        name = k["name"]
        k["rpq_launches"] = out["rpq"]["launches"][name]
        k["rpq_sharded_launches"] = out["rpq"]["sharded"]["launches"][name]
        k["oneshot_launches"] = {
            "reach_dist": out["oneshot"]["launches"][name],
            "rpq": out["oneshot"]["rpq_launches"][name]}
        k["dynamic_launches"] = {
            mode: n[name]
            for mode, n in out["dynamic"]["launches_by_mode"].items()}
        k["serve_launches"] = {
            "barrier": out["serve"]["barrier"]["launches"][name],
            **{f"mvcc_{label}": run["launches"][name]
               for label, run in out["serve"]["mvcc"].items()}}
        k["baselines_launches"] = out["baselines"]["launches"][name]
        k["mapreduce_launches"] = out["mapreduce"]["launches"][name]
        k["sharded_repair_launches"] = {
            mode: n[name] for mode, n in
            out["sharded_repair"]["launches_by_mode"].items()}
        k["verify_launches"] = out["verify"]["launches"][name]
        k["lm_launches"] = {phase: out[phase]["launches"][name]
                            for phase in ("lm_serve", "lm_moe", "lm_train")}
        k["gnn_launches"] = {phase: out[phase]["launches"][name]
                             for phase in ("gnn_molecule", "gnn_gat")}
        k["recsys_launches"] = out["recsys"]["launches"][name]
        k["cells_launches"] = out["cells"]["launches"][name]
        k["examples_launches"] = {
            ex: run["launches"][name]
            for ex, run in out["examples"].items()}
        k["new_shapes"] = (out["oneshot"]["shapes"].get(name, [])
                           + out["dynamic"]["shapes"].get(name, []))
        if name == "or_and_matmul":
            # the fixpoint kernel's launches beside this kernel's, and the
            # wrapper's K-major and row copies: 0 copies asserted on the
            # one-shot, baselines and MR paths and the sharded one-shot
            # functions, each evalDG there one fixpoint launch
            k["fixpoint_launches"] = {p: n["or_and_fixpoint"]
                                      for p, n in paths.items()}
            k["copies"] = {p: n["or_and_copies"] for p, n in paths.items()}
        if name == "min_plus_matmul":
            k["settle_launches"] = {p: n["min_plus_settle"]
                                    for p, n in paths.items()}
            shapes = {s["path"]: s for s in k["new_shapes"]}
            k["skinny_ms"] = shapes["evaldg_dist step"]["ms"]
            k["p_ms"] = shapes["rank update P"]["ms"]
            k["dispatch"].update({path: s["dispatch"]
                                  for path, s in shapes.items()})
            # asserted 0 on each path: main, one-shot, every delta
            k["copies"] = {"main": 0, "oneshot": 0, "dynamic": 0,
                           "mapreduce": 0, "sharded_repair": 0}
    print(out["card"])            # nvidia-smi: name, power.limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
