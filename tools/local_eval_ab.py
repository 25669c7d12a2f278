#!/usr/bin/env python3
"""Time the one-shot local stage (localEval of every fragment and the write
of D or W) with the package of one or more source trees, each in a child
process, in the order given:

    git archive <commit> src | tar -x -C build/parent
    python3 tools/local_eval_ab.py build/parent . . build/parent

(``build/`` is ignored by git; one CUDA device.)  Each child imports
``repro_torch`` from ``<tree>/src`` and prints one JSON line with the
card's name and power limit and, on the graph of the benchmark's
``oneshot.reach_dist`` cell (``bench/``'s generator and fragments for
``--seed`` 1: n = 32768, m = 4n, 16 random fragments) and 8 seeded pairs,
the median ms of a call to the end of its device work:

- ``stage_reach_ms`` / ``stage_dist_ms`` / ``stage_bounded_ms``: the local
  stage as ``core.session.exec_reach`` / ``exec_dist`` runs it: the
  allocation of D or W, ``engine.local_eval_*`` and, where the tree's
  engine returns a row block (no ``out=``), the block written in;
- ``kernel_reach_ms`` / ``kernel_dist_ms`` / ``kernel_bounded_ms`` (trees
  with ``kernels.local_eval``): the kernel alone into a preallocated D or
  W, CUDA events around 5 calls after a warm-up, and its share of the
  least time its bytes take at 3.35 TB/s (``*_bound_ms``: every row of
  the [B, B] matrix written once over its pitch, the edges, sources and
  column map read once);
- ``stage_lists_ms`` / ``stage_lists_bounded_ms`` (trees whose engine
  keeps W as row lists, ``tropical_matmul.ops.row_lists``): the local
  stage as ``exec_dist`` then runs it, the lists' allocation and
  ``engine.local_eval_dist`` into them; ``kernel_lists_ms`` /
  ``kernel_lists_bounded_ms`` the row-list kernel alone (CUDA events, 5
  calls), beside its bytes bound (``*_bound_ms``: the pairs and counts
  stored once, the edges, sources and column map read once) and its
  plain version on the card (``plain_lists_ms``: ``engine._rows_dist``
  and the block turned into lists); ``entries`` the pairs stored;
- ``digest``: a digest of the matrices' row sums (D: the ones of each row;
  W: each row's finite distances summed, unreached as -1), which must be
  equal across trees; the row lists' sums must equal their tree's W's.

Distances are bounded at 6, as the cell's bounded reads are.
"""
import hashlib
import inspect
import statistics
import sys
import time
from pathlib import Path

import _ab

SEED, PAIRS, BOUND = 1, 8, 6
PEAK_BYTES_PER_S = 3.35e12
ROOT = Path(__file__).resolve().parents[1]


def child(tree: Path) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import cache, engine
    from repro_torch.core.fragments import query_slots
    from repro_torch.kernels.bool_matmul.ops import padded, padded_zeros
    from repro_torch.kernels.tropical_matmul.ops import padded_i32
    _ab.from_tree(engine, tree)
    sys.path.insert(1, str(ROOT))
    from bench import harness, spec
    from bench.data import generate

    cell = spec.load_cell(ROOT, "oneshot.reach_dist")
    g = generate.make_graph(cell.config, SEED, cell.bench_dir)
    fr = harness.build_fragments(cell.config, g)
    dev = torch.device("cuda")
    arrs = cache._upload_arrays(fr, dev)
    names = ("esrc", "edst", "src_local", "src_row", "tgt_local")
    rng = np.random.default_rng(SEED + 3)
    pairs = [tuple(int(x) for x in p) for p in rng.integers(0, g.n,
                                                            (PAIRS, 2))]
    into = "out" in inspect.signature(engine.local_eval_reach).parameters
    B, n_max = fr.B, fr.n_max

    def inputs(s, t):
        qs = query_slots(fr, s, t)
        return [arrs[n] for n in names] + [
            torch.tensor(qs[n], device=dev) for n in ("s_local", "t_local")]

    def stage(kind, args):
        """The local stage of one query, as the tree's session runs it."""
        if kind == "reach":
            if into:
                return engine.local_eval_reach(*args, n_max=n_max, B=B,
                                               out=padded(B, B, dev))
            rows, block = engine.local_eval_reach(*args, n_max=n_max, B=B)
            D = padded_zeros(B, B, dev)
            D[rows] = block
            return D
        cap = engine.INF if kind == "dist" else BOUND
        if into:
            return engine.local_eval_dist(*args, cap, n_max=n_max, B=B,
                                          out=padded_i32(B, B, dev))
        rows, block = engine.local_eval_dist(*args, cap, n_max=n_max, B=B)
        W = padded_i32(B, B, dev).fill_(engine.INF)
        W[rows] = block
        return W

    row = {"B": B, "n_max": n_max, "S": fr.s_max, "E": fr.e_max}
    digest = hashlib.sha256()
    sums = {}
    for kind in ("reach", "dist", "bounded"):
        ms = []
        stage(kind, inputs(*pairs[0]))            # warm-up (and the build)
        torch.cuda.synchronize()
        for s, t in pairs:
            args = inputs(s, t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = stage(kind, args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            sums[kind, s, t] = row_sums(out, engine.INF)
            digest.update(sums[kind, s, t])
            del out
        row[f"stage_{kind}_ms"] = statistics.median(ms)
    if hasattr(engine, "RowLists"):
        row.update(list_times(fr, pairs, inputs, sums))
    row["digest"] = digest.hexdigest()[:16]
    if into:
        row.update(kernel_times(fr, inputs(*pairs[0])))
    return row


def list_times(fr, pairs, inputs, sums) -> dict:
    """The row-list route: the stage as exec_dist runs it, each query's row
    sums held equal to the dense W's in ``sums``, then the kernel alone on
    the first pair beside its bytes bound and its plain version."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels.local_eval import local_eval_dist_lists
    from repro_torch.kernels.tropical_matmul.ops import (row_lists,
                                                         write_row_lists)
    B, n_max, dev = fr.B, fr.n_max, torch.device("cuda")
    out = {}
    for kind, dense, cap in (("lists", "dist", engine.INF),
                             ("lists_bounded", "bounded", BOUND)):
        def stage(args, c=cap):
            return engine.local_eval_dist(*args, c, n_max=n_max, B=B,
                                          out=row_lists(B, dev))
        stage(inputs(*pairs[0]))
        torch.cuda.synchronize()
        ms = []
        for s, t in pairs:
            args = inputs(s, t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lists = stage(args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if list_sums(lists) != sums[dense, s, t]:
                raise AssertionError(f"{kind} ({s}, {t}): the row lists "
                                     f"differ from the dense W")
        out[f"stage_{kind}_ms"] = statistics.median(ms)
        args = inputs(*pairs[0])
        entries = int(stage(args).meta[1])
        lists = row_lists(B, dev)
        call = (lambda c=cap: local_eval_dist_lists(lists, *args, c,
                                                    n_max=n_max))
        call()
        torch.cuda.synchronize()
        kms, _ = _ab.events_ms(call, 5)
        F, E = args[0].shape
        S = args[2].shape[1]
        nbytes = 8 * entries + 4 * B + 4 * F * (2 * E + 2 * S + B + 2)
        plain_ms, _ = _ab.events_ms(lambda c=cap: write_row_lists(
            row_lists(B, dev), *engine._rows_dist(*args, c, n_max=n_max,
                                                  B=B)), 1)
        out[f"kernel_{kind}_ms"] = kms
        out[f"kernel_{kind}_bound_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
        out[f"plain_{kind}_ms"] = plain_ms
        out[f"entries_{kind}"] = entries
    return out


def list_sums(lists) -> bytes:
    """Each row's finite distances summed, each entry it lacks counted as
    -1: the bytes row_sums reads from the dense W of the same query."""
    import torch
    count = lists.count.long()
    live = (torch.arange(lists.pairs.shape[1], device=count.device)[None, :]
            < count[:, None])
    sums = torch.where(live, lists.pairs[:, :, 1], 0).sum(1, dtype=torch.int64)
    return (sums - (lists.B - count)).cpu().numpy().tobytes()


def row_sums(m, inf: int) -> bytes:
    """Each row's sum, computed on the card and read back."""
    import torch
    if m.dtype != torch.bool:
        m = torch.where(m < inf, m, -1)
    return m.sum(1, dtype=torch.int64).cpu().numpy().tobytes()


def kernel_times(fr, args) -> dict:
    """The kernel alone into a preallocated matrix, and its bytes bound."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels.bool_matmul.ops import padded
    from repro_torch.kernels.local_eval import (local_eval_dist_into,
                                                local_eval_reach_into)
    from repro_torch.kernels.tropical_matmul.ops import padded_i32
    B, n_max, dev = fr.B, fr.n_max, torch.device("cuda")
    F, E = args[0].shape
    S = args[2].shape[1]
    read = 4 * F * (2 * E + 2 * S + B + 2)
    out = {}
    for kind, cap in (("reach", None), ("dist", engine.INF),
                      ("bounded", BOUND)):
        if cap is None:
            m = padded(B, B, dev)
            call = (lambda: local_eval_reach_into(m, *args, n_max=n_max))
        else:
            m = padded_i32(B, B, dev)
            call = (lambda c=cap: local_eval_dist_into(m, *args, c,
                                                       n_max=n_max))
        call()
        torch.cuda.synchronize()
        ms, _ = _ab.events_ms(call, 5)
        bound = (B * m.stride(0) * m.element_size() + read) \
            / PEAK_BYTES_PER_S * 1e3
        out[f"kernel_{kind}_ms"] = ms
        out[f"kernel_{kind}_bound_ms"] = bound
        out[f"kernel_{kind}_share"] = bound / ms
        del m
    return out


if __name__ == "__main__":
    sys.exit(_ab.main(sys.argv[1:], __file__, __doc__, child, agree="digest"))
