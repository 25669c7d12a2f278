"""Baselines the paper compares against (Section 7, 'Algorithms').

* ``dis_reach_n``  — ship every fragment to the coordinator, evaluate
  centrally (the paper's disReach_n).  Traffic = |G|.
* ``dis_reach_m``  — Pregel-style message passing following [21] as the
  paper describes it: per-superstep local BFS propagation inside each
  worker, newly activated virtual nodes shipped via the master, repeat
  until quiescent.  No bound on visits per site: the experiment of Table
  2 / Fig. 11 measures exactly that contrast.

Both run on the same padded ``Fragmentation`` as the engine and over its
propagation (``engine._propagate_bool``), so the comparison isolates the
*algorithm*, not the data layout.  Their counts (``traffic_bits``,
``site_visits``, ``rounds``) are the reference package's formulas.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import engine
from .cache import _upload, _upload_arrays
from .fragments import Fragmentation
from .session import _resolve_device


@dataclasses.dataclass
class BaselineResult:
    answer: bool
    traffic_bits: int
    site_visits: int          # total visits summed over sites
    rounds: int               # collective/message rounds


# ---------------------------------------------------------------------------
# disReach_n: centralized
# ---------------------------------------------------------------------------

def dis_reach_n(fr: Fragmentation, s: int, t: int,
                device=None) -> BaselineResult:
    """Every fragment shipped whole to one site, then a BFS from ``s`` over
    the whole graph's edges on ``device`` (``None``: the CUDA device,
    raising :class:`~repro_torch.errors.NoCudaDevice` without one).
    Traffic: the node and edge ids as 32-bit words, ``(n + 2m) * 32``."""
    dev = _resolve_device(device)
    g = fr.g
    src, dst = _upload(g.src[None, :], dev), _upload(g.dst[None, :], dev)
    frontier = torch.zeros((1, 1, g.n + 1), dtype=torch.bool, device=dev)
    frontier[0, 0, s] = True
    seen = engine._propagate_bool(src, dst, frontier)[0, 0]
    traffic = int((g.n + 2 * g.m) * 32)
    return BaselineResult(bool(seen[t]), traffic, fr.k, 1)


# ---------------------------------------------------------------------------
# disReach_m: message passing (Pregel-style, paper Sec. 7)
# ---------------------------------------------------------------------------

def _exchange(active, tgt_local, src_local, src_row, *, n_max: int, B: int):
    """One superstep's message exchange: virtual-node activations [k,
    n_max+1] -> the boundary nodes they name (``bact`` [B]) and the
    activations delivered to the fragments that own them."""
    k = active.shape[0]
    stub_act = torch.gather(active, 1, tgt_local.long())         # [k, B]
    stub_act &= tgt_local != n_max
    bact = stub_act.any(0)                                       # [B]
    recv = bact[src_row.long().clamp(0, B - 1)] & (src_row < B)  # [k, S]
    delivered = torch.zeros((k, n_max + 1), dtype=torch.uint8,
                            device=active.device)
    delivered.scatter_reduce_(1, src_local.long(), recv.to(torch.uint8),
                              "amax")
    delivered[:, n_max] = 0
    return bact, delivered.bool()


def dis_reach_m(fr: Fragmentation, s: int, t: int,
                max_rounds: Optional[int] = None,
                device=None) -> BaselineResult:
    """Pregel-style disReach_m: each round propagates every fragment's
    activations locally (all fragments at once, ``[k, n_max+1]``), then
    ships the newly activated virtual nodes to their owners.  Stops when
    ``t`` is active or no virtual node is fresh (or after ``max_rounds``,
    default ``B + 2``).  Counts 64 bits per fresh message (node id to the
    master and on) and ``k`` site visits per round.  One host sync per
    round reads whether ``t`` is reached and how many messages are fresh:
    the algorithm's own step, as in the reference."""
    if s == t:
        return BaselineResult(True, 0, 0, 0)
    dev = _resolve_device(device)
    arrs = _upload_arrays(fr, dev)
    k, n_max, B = fr.k, fr.n_max, fr.B
    max_rounds = max_rounds or (B + 2)
    active = torch.zeros((k, n_max + 1), dtype=torch.bool, device=dev)
    active[int(fr.part[s]), int(fr.owner_local[s])] = True
    t_frag, t_loc = int(fr.part[t]), int(fr.owner_local[t])

    rounds = 0
    msgs_bits = 0
    seen_b = torch.zeros(B, dtype=torch.bool, device=dev)
    while rounds < max_rounds:
        rounds += 1
        active = engine._propagate_bool(arrs["esrc"], arrs["edst"],
                                        active[:, None, :])[:, 0, :]
        bact, delivered = _exchange(active, arrs["tgt_local"],
                                    arrs["src_local"], arrs["src_row"],
                                    n_max=n_max, B=B)
        fresh = bact & ~seen_b
        hit, n_fresh = torch.stack([active[t_frag, t_loc].long(),
                                    fresh.sum()]).tolist()
        if hit or n_fresh == 0:
            break
        msgs_bits += n_fresh * 64
        seen_b |= bact
        active |= delivered

    ans = bool(active[t_frag, t_loc])
    return BaselineResult(ans, msgs_bits, fr.k * rounds, rounds)
