"""Shared violation record and report rendering for the analysis passes,
as ``repro.analysis.report``.

Every pass (the program contracts, the AST lint, the steady-state guard)
reports findings as :class:`Violation` rows, so the CLI and the tests
consume one shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List


@dataclass(frozen=True)
class Violation:
    """One static-analysis finding.

    ``rule`` is the rule id (``TXH002``, ``restack``, ...); ``where`` locates
    it: ``path:line`` for lint findings, ``algorithm/program`` for the
    program contracts; ``hint`` says how to fix (or suppress) it.
    """

    rule: str
    where: str
    message: str
    hint: str = ""

    def render(self) -> str:
        out = f"{self.where}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


def render_report(violations: Iterable[Violation], *, title: str) -> str:
    rows: List[Violation] = list(violations)
    lines = [f"== {title}: {len(rows)} violation(s) =="]
    lines += [v.render() for v in rows]
    return "\n".join(lines)
