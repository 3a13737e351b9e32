"""Baseline ratchet: pre-existing violations are tolerated, new ones fail.

The baseline maps ``path -> {rule -> count}``. A run regresses when any
(path, rule) cell exceeds its baselined count — so violations can only be
fixed (ratcheted down), never silently added. Parse errors (TPU000) are
never baselined. Regenerate with ``python -m opensearch_tpu_torch.lint
--write-baseline`` after fixing violations.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterable

from opensearch_tpu_torch.lint.core import PARSE_ERROR_RULE, Violation

BASELINE_VERSION = 1
DEFAULT_BASELINE_NAME = "lint_baseline.json"
# the port's own ratchet file, inside the package (the checkout root's
# lint_baseline.json is the reference linter's); its keys are paths
# relative to the checkout root
DEFAULT_BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    DEFAULT_BASELINE_NAME)


def violation_counts(violations: Iterable[Violation]) -> dict[str, dict[str, int]]:
    counts: dict[str, dict[str, int]] = {}
    for v in violations:
        per_file = counts.setdefault(v.path, {})
        per_file[v.rule] = per_file.get(v.rule, 0) + 1
    return counts


@dataclass(frozen=True)
class Regression:
    path: str
    rule: str
    count: int
    allowed: int

    def render(self) -> str:
        return (f"{self.path}: {self.count} x {self.rule} "
                f"(baseline allows {self.allowed})")

    def to_dict(self) -> dict:
        return {"path": self.path, "rule": self.rule,
                "count": self.count, "allowed": self.allowed}


def load_baseline(path: str) -> dict[str, dict[str, int]]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    counts = data.get("counts", data)
    return {
        str(p): {str(r): int(n) for r, n in rules.items()}
        for p, rules in counts.items()
    }


def write_baseline(path: str, violations: Iterable[Violation]) -> dict:
    data = {
        "version": BASELINE_VERSION,
        "comment": ("tpulint ratchet: tolerated pre-existing violations "
                    "per (file, rule). Shrink it by fixing violations and "
                    "re-running with --write-baseline; never grow it by "
                    "hand."),
        "counts": {
            p: dict(sorted(rules.items()))
            for p, rules in sorted(violation_counts(violations).items())
        },
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=False)
        fh.write("\n")
    return data


def compare(
    violations: Iterable[Violation],
    baseline: dict[str, dict[str, int]] | None,
) -> list[Regression]:
    """Regressions: (path, rule) cells whose count exceeds the baseline."""
    baseline = baseline or {}
    out: list[Regression] = []
    for path, rules in sorted(violation_counts(violations).items()):
        for rule, count in sorted(rules.items()):
            allowed = 0 if rule == PARSE_ERROR_RULE else (
                baseline.get(path, {}).get(rule, 0))
            if count > allowed:
                out.append(Regression(path, rule, count, allowed))
    return out


def stale_entries(
    violations: Iterable[Violation],
    baseline: dict[str, dict[str, int]] | None,
) -> list[Regression]:
    """Baseline cells larger than reality — candidates for ratcheting down
    (reported as a hint, never an error)."""
    baseline = baseline or {}
    counts = violation_counts(violations)
    out: list[Regression] = []
    for path, rules in sorted(baseline.items()):
        for rule, allowed in sorted(rules.items()):
            count = counts.get(path, {}).get(rule, 0)
            if count < allowed:
                out.append(Regression(path, rule, count, allowed))
    return out
