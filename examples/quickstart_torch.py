"""Quickstart on the PyTorch/CUDA package: the paper's own Figure-1
example as code (the counterpart of ``examples/quickstart.py``).

Builds the recommendation network from Fig. 1 (Ann the CTO, Mark the FA,
DB/HR chains), fragments it across three "data centers", opens a
``repro_torch.connect`` session, and answers all three query classes in
ONE mixed batch — the planner fuses it into one execution per (kind,
automaton) group, through the or-and and min-plus kernels on the card.

    PYTHONPATH=src python examples/quickstart_torch.py                # H100
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np                                      # noqa: E402

import repro_torch                                      # noqa: E402
from repro_torch.core import Dist, Reach, Rpq, fragment_graph  # noqa: E402
from repro_torch.graph.graph import Graph               # noqa: E402

# --- the paper's Fig. 1 graph ------------------------------------------------
# labels: 0=CTO 1=DB 2=HR 3=FA (names attached for readability)
NAMES = ["Ann", "Walt", "Bill", "Mat", "Fred", "Emmy", "Pat", "Jack",
         "Ross", "Tom", "Mark"]
LBL = {"Ann": 0, "Walt": 2, "Bill": 1, "Mat": 2, "Fred": 2, "Emmy": 2,
       "Pat": 1, "Jack": 1, "Ross": 2, "Tom": 1, "Mark": 3}
EDGES = [("Ann", "Walt"), ("Ann", "Bill"), ("Walt", "Mat"), ("Bill", "Pat"),
         ("Mat", "Fred"), ("Fred", "Emmy"), ("Emmy", "Ross"),
         ("Pat", "Jack"), ("Jack", "Fred"), ("Ross", "Mark"),
         ("Tom", "Ross")]
# fragmentation: DC1 = {Ann, Walt, Bill, Fred}, DC2 = {Mat, Emmy, Jack, Tom},
# DC3 = {Pat, Ross, Mark}
PART = {"Ann": 0, "Walt": 0, "Bill": 0, "Fred": 0, "Mat": 1, "Emmy": 1,
        "Jack": 1, "Tom": 1, "Pat": 2, "Ross": 2, "Mark": 2}


def main(device: str = "cuda"):
    idx = {n: i for i, n in enumerate(NAMES)}
    g = Graph(
        n=len(NAMES),
        src=np.array([idx[a] for a, b in EDGES]),
        dst=np.array([idx[b] for a, b in EDGES]),
        labels=np.array([LBL[n] for n in NAMES], np.int32),
        label_names=["CTO", "DB", "HR", "FA"],
    )
    part = np.array([PART[n] for n in NAMES], np.int32)
    fr = fragment_graph(g, part, 3)
    print(f"fragments: 3 | boundary nodes |V_f|: {fr.B - 2} "
          f"| largest fragment |F_m|: {fr.largest_fragment()}")

    s, t = idx["Ann"], idx["Mark"]

    # one handle for all three classes
    session = repro_torch.connect(fr, device=device)
    r, d, rr, rr2 = session.run([
        Reach(s, t),
        Dist(s, t, bound=6),
        Rpq(s, t, regex="(DB* | HR*)"),
        Rpq(s, t, regex="DB*"),
    ])
    print(session.last_plan.explain())

    print(f"\nq_r(Ann, Mark)        -> {r.answer}   "
          f"(payload {r.stats.payload_bits} bits, "
          f"{r.stats.collective_rounds} collective round)")
    print(f"q_br(Ann, Mark, 6)    -> {d.answer}   (dist = {d.distance})")
    print(f"q_rr(Ann, Mark, DB*|HR*) -> {rr.answer}   "
          f"(|V_q| = {rr.stats.states}, payload {rr.stats.payload_bits} bits)")
    print(f"q_rr(Ann, Mark, DB*)     -> {rr2.answer}   "
          "(no pure-DB chain exists — paper Ex. 1)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the session runs (default: the card)")
    main(ap.parse_args().device)
