"""Drill run distilled to a JSON-safe artifact.

A report pins everything needed to (a) fail CI when a campaign regresses
and (b) re-derive the run offline: the campaign description (seed +
tick-indexed steps), every action actually fired (with the drill tick it
fired at), every invariant violation (invariant name, tick, detail), and
the per-invariant check/violation tallies.  The flagship game-day pins
it beside its re-home rate and its journal's replay digest, so
performance and correctness regress together.

A copy of ``noahgameframe_tpu/drill/report.py``, which imports no jax: the
port keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant breach observed at one drill tick."""

    invariant: str
    tick: int
    detail: str

    def to_dict(self) -> Dict[str, object]:
        return {"invariant": self.invariant, "tick": int(self.tick),
                "detail": self.detail}


@dataclasses.dataclass
class DrillReport:
    campaign: Dict[str, object]          # Campaign.describe()
    ticks: int = 0
    actions_fired: List[Dict[str, object]] = dataclasses.field(
        default_factory=list)
    violations: List[Violation] = dataclasses.field(default_factory=list)
    checks: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: free-form extras the driving script pins alongside the drill
    #: (bench numbers, journal digests, convergence verdicts)
    extra: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.violations

    def violations_by_invariant(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.violations:
            out[v.invariant] = out.get(v.invariant, 0) + 1
        return out

    def to_dict(self) -> Dict[str, object]:
        return {
            "campaign": self.campaign,
            "ticks": int(self.ticks),
            "clean": self.clean,
            "actions_fired": list(self.actions_fired),
            "invariant_checks": dict(self.checks),
            "invariant_violations": self.violations_by_invariant(),
            "violations": [v.to_dict() for v in self.violations],
            **({"extra": self.extra} if self.extra else {}),
        }

    def write(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
