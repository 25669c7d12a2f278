"""MRdRPQ: the paper's MapReduce formulation (Section 6, Fig. 10).

Map    = localEval_r on each fragment (procedure mapRPQ);
Shuffle= every mapper emits <1, rvset_i> to ONE reducer;
Reduce = evalDG_r on the union (procedure reduceRPQ).

The *dataflow* is the paper's (including the single-reducer bottleneck it
inherits from Hadoop), so the comparison with the replicated-closure
engine can be measured.  The ECC (elapsed communication cost, after Afrati
& Ullman) is the max over process paths of shipped input sizes:
ECC = O(|F_m| + |R|^2 |V_f|^2).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..kernels.bool_matmul.ops import padded_zeros
from . import engine
from .automaton import QueryAutomaton
from .cache import _upload, _upload_arrays
from .fragments import Fragmentation, query_slots
from .session import _resolve_device, _src_rows, _tgt_cols


@dataclasses.dataclass
class MRResult:
    answer: bool
    ecc_bits: int           # elapsed communication cost
    mapper_input_bits: int  # max |F_i| shipped to a mapper
    reducer_input_bits: int # sum of rvset payloads into the single reducer


def _no_mark(phase: str) -> None:
    pass


def mr_drpq(fr: Fragmentation, s: int, t: int, qa: QueryAutomaton,
            device=None, mark: Callable[[str], None] = _no_mark) -> MRResult:
    """Answer the regular path query (s, t, qa) the MapReduce way on
    ``device`` (``None``: the CUDA device, raising
    :class:`~repro_torch.errors.NoCudaDevice` without one).

    Map: one mapper per fragment runs ``engine.local_eval_regular`` and
    emits its rvset rows ``(rows, block [r, B*Q])``.  Reduce: the one
    reducer takes the union of the rvsets into ``D [B*Q, B*Q]`` and runs
    evalDG_r through the or-and kernel.  Each mapper's block is written
    into ``D`` as it arrives and dropped, so no more than one mapper's
    block is alive at once; the union is the same as the reference's OR
    over stacked ``[k, B*Q, B*Q]`` rvsets, because every row is owned by
    exactly one fragment (a write is the OR with zeros).

    ``mark(phase)`` is called as each phase begins (``"map"``,
    ``"evaldg"``) and once at the end (``"end"``); a caller can record
    CUDA events there to time them.  D is made in zero-padded storage, so
    the evalDG steps read it as it is, with no copy.

    ``ecc_bits``, ``mapper_input_bits`` and ``reducer_input_bits`` are the
    cost model's counts, equal to the reference package's (the reducer's
    is ``k * (B*Q)^2``: every mapper ships its whole block); they do not
    describe what this function allocates."""
    if s == t:
        return MRResult(bool(qa.nullable), 0, 0, 0)
    dev = _resolve_device(device)
    Q = qa.n_states
    side = fr.B * Q
    arrs = _upload_arrays(fr, dev)
    qs = query_slots(fr, s, t)
    s_local, t_local = _upload(qs["s_local"], dev), _upload(qs["t_local"], dev)
    q_labels, q_trans = _upload(qa.state_labels, dev), _upload(qa.trans, dev)

    # ---- map phase, one mapper per fragment (procedure mapRPQ), and the
    # shuffle to the single reducer (procedure reduceRPQ's union) ---------
    mark("map")
    D = padded_zeros(side, side, dev)       # as evalDG's skinny route reads
    for f in range(fr.k):
        one = slice(f, f + 1)
        rows, block = engine.local_eval_regular(
            arrs["esrc"][one], arrs["edst"][one], arrs["src_local"][one],
            arrs["src_row"][one], arrs["tgt_local"][one], arrs["labels"][one],
            arrs["gids"][one], q_labels, q_trans, s_local[one], t_local[one],
            s, t, n_max=fr.n_max, B=fr.B)
        D[rows] = block
        del rows, block

    # ---- reduce: evalDG_r on the union, reading D as it is stored -------
    mark("evaldg")
    ans = engine.evaldg_reach(D, _src_rows(fr, dev, Q, qa.start),
                              _tgt_cols(fr, t, dev, Q, qa.final))
    mark("end")

    mapper_bits = int(fr.frag_sizes.max()) * 32
    reducer_bits = fr.k * side ** 2      # every mapper ships its block
    return MRResult(bool(ans), mapper_bits + reducer_bits,
                    mapper_bits, reducer_bits)
