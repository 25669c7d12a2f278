"""Shared violation / report model of the analysis passes.

Every pass (the wire checker, the repo lint and the lock-order checker)
reports its findings as :class:`Violation` records, so that the CLI folds
them into one JSON report and fails on any non-empty list.  The shape is
the reference package's (``repro.analysis.report``), so that both
packages' reports line up.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List


@dataclasses.dataclass
class Violation:
    """One finding of one pass.

    ``rule`` is the stable identifier (``HLO00x`` for the wire invariants,
    kept from the reference, ``RPR00x`` for the repo lint, ``LCK00x`` for
    the lock order); ``where`` names the program / file:line / lock edge
    the finding is anchored to.
    """

    rule: str
    message: str
    where: str = ""
    context: str = ""

    def to_dict(self) -> Dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v}

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.rule}{loc}: {self.message}"


def make_report(sections: Dict[str, List[Violation]],
                extra: Dict = None) -> Dict:
    """Fold per-pass violation lists into the CLI's JSON report shape."""
    out = {
        "ok": all(not v for v in sections.values()),
        "violations": {
            name: [v.to_dict() for v in vs] for name, vs in sections.items()
        },
        "counts": {name: len(vs) for name, vs in sections.items()},
    }
    if extra:
        out.update(extra)
    return out


def dump_report(report: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
