"""`python -m mpi_cuda_cnn_tpu_torch lint [PATHS] [--rule MCTxxx]
[--format json] [--baseline F]` (counterpart of the reference's
`analysis/cli.py`, the same contract).

With no --manifest the root is the directory above the working one that
holds pyproject.toml, and the manifest is its
ci/torch_lint_manifest.json. Exit codes follow the repo's gate
convention (obs.regress/health):
0 = clean, 1 = findings, 2 = configuration error. `--format json`
prints one machine-readable object (CI uploads it as an artifact);
text mode prints one `path:line:col: MCTxxx message` per finding plus
a one-line summary on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import ALL_RULES, all_rules
from .baseline import apply_baseline, load_baseline, write_baseline
from .core import LintError, lint_paths
from .manifest import MANIFEST_REL, find_root, load_manifest

KNOWN_RULES = tuple(cls.rule_id for cls in ALL_RULES)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch lint",
        description="Static analyzer of the port's contracts: purity "
                    "(no jax, no reference package; torch-free modules), "
                    "clock and RNG discipline, schema and fault-site "
                    "cross-checks, host syncs in the serving hot loops "
                    "(rules MCT001, MCT002, MCT004-MCT007).",
    )
    p.add_argument("paths", nargs="*",
                   help="files/directories to scan (default: the "
                        "manifest's checked-in scope)")
    p.add_argument("--rule", action="append", metavar="MCTxxx",
                   help="run only this rule (repeatable)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", metavar="FILE",
                   help="suppress findings recorded in this baseline "
                        "(ci/torch_lint_baseline.json)")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="write current findings as the new baseline "
                        "and exit 0")
    p.add_argument("--manifest", metavar="FILE",
                   help=f"contract manifest (default: <root>/{MANIFEST_REL})")
    return p


def lint_main(argv: list[str]) -> int:
    args = build_parser().parse_args(argv)
    try:
        root = (find_root(Path(args.manifest).resolve().parent)
                if args.manifest else find_root())
        manifest = load_manifest(args.manifest or root / MANIFEST_REL)
        rules = all_rules()
        if args.rule:
            wanted = set(args.rule)
            unknown = sorted(wanted - set(KNOWN_RULES))
            if unknown:
                raise LintError(
                    f"unknown rule(s) {', '.join(unknown)} "
                    f"(known: {', '.join(KNOWN_RULES)})"
                )
            rules = [r for r in rules if r.rule_id in wanted]
        paths = args.paths or list(manifest.paths)
        findings = lint_paths(paths, root=root, manifest=manifest,
                              rules=rules)
        if args.write_baseline:
            write_baseline(findings, args.write_baseline)
            print(f"wrote {len(findings)} finding(s) to "
                  f"{args.write_baseline}", file=sys.stderr)
            return 0
        if args.baseline:
            findings = apply_baseline(findings, load_baseline(args.baseline))
    except LintError as e:
        print(f"lint: error: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps({
            "version": 1,
            "rules": [r.rule_id for r in rules],
            "paths": paths,
            "findings": [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "col": f.col, "msg": f.msg}
                for f in findings
            ],
        }, indent=2))
    else:
        for f in findings:
            print(f.render())
        print(
            f"lint: {len(findings)} finding(s) "
            f"[{', '.join(r.rule_id for r in rules)}]",
            file=sys.stderr,
        )
    return 1 if findings else 0
