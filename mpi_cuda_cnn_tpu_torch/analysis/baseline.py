"""Finding baseline (ci/torch_lint_baseline.json): fail on new findings
only (the reference's `analysis/baseline.py`, the same code).

An analyzer added to a living codebase must not force a flag day:
pre-existing findings go into a committed baseline and the gate fails
only on findings a change introduced. The port's baseline ships empty
(every finding in the tree is fixed or suppressed at the site, where a
reviewer sees it); the mechanism exists so a future rule with real
pre-existing debt can land enforcing for new code first.

Matching is (rule, path, line): stable across reformats of other lines,
intentionally brittle against edits near the baselined site — touching
that code is exactly when the finding should resurface for a decision.
"""

from __future__ import annotations

import json
from pathlib import Path

from .core import Finding, LintError

BASELINE_VERSION = 1


def load_baseline(path: str | Path) -> set[tuple[str, str, int]]:
    p = Path(path)
    if not p.is_file():
        raise LintError(f"baseline not found: {p}")
    try:
        raw = json.loads(p.read_text())
    except json.JSONDecodeError as e:
        raise LintError(f"{p}: bad JSON: {e}") from e
    if raw.get("version") != BASELINE_VERSION:
        raise LintError(
            f"{p}: baseline version {raw.get('version')!r} != "
            f"{BASELINE_VERSION}"
        )
    entries = raw.get("findings")
    if not isinstance(entries, list):
        raise LintError(f"{p}: 'findings' must be a list")
    out: set[tuple[str, str, int]] = set()
    for e in entries:
        try:
            out.add((e["rule"], e["path"], int(e["line"])))
        except (TypeError, KeyError) as exc:
            raise LintError(
                f"{p}: baseline entry needs rule/path/line: {e!r}"
            ) from exc
    return out


def apply_baseline(findings: list[Finding],
                   known: set[tuple[str, str, int]]) -> list[Finding]:
    """Drop findings present in the baseline. Unmatched baseline
    entries are fine — fixed debt just leaves a stale entry that the
    next `--write-baseline` refresh removes."""
    return [f for f in findings if f.key() not in known]


def write_baseline(findings: list[Finding], path: str | Path) -> None:
    """Write the CURRENT findings as the new baseline (tmp+rename — a
    crashed write must not leave CI gating on half a file)."""
    p = Path(path)
    payload = {
        "_doc": "lint baseline of the port: findings the gate "
                "tolerates. Keep this empty — new findings are fixed or "
                "suppressed at the site (# mctpu: disable=MCTxxx with a "
                "reason); baseline entries are for landing a new rule "
                "over pre-existing debt only. Refresh: python -m "
                "mpi_cuda_cnn_tpu_torch lint --write-baseline "
                "ci/torch_lint_baseline.json",
        "version": BASELINE_VERSION,
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line, "msg": f.msg}
            for f in findings
        ],
    }
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(json.dumps(payload, indent=2) + "\n")
    tmp.replace(p)
