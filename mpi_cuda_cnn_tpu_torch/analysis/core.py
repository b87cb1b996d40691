"""Analyzer core: Finding, the Rule protocol, the shared visitor, and
per-line suppressions (the reference's `analysis/core.py`, the same
code).

One AST parse and ONE tree walk per file, however many rules run: each
rule declares the node types it wants (`node_types`) and the walker
dispatches every matching node to every subscribed rule. Rules are
small classes — the Engler-style pattern is "state the invariant, visit
the two node shapes that can break it" — and findings carry exact
file:line:col so a CI annotation lands on the offending token.

Suppressions: `# mctpu: disable=MCT001` (comma-separate for several,
`disable=all` for every rule) on the finding's line, or on a
standalone comment line directly above it. A suppression is a visible,
reviewable exception at the site; the committed baseline
(ci/torch_lint_baseline.json) is for pre-existing debt only and ships
empty.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

from .manifest import Manifest

# Directories never scanned: the C driver tree, caches, VCS internals.
SKIP_DIRS = {".git", "__pycache__", ".github", "native", ".pytest_cache"}

# Capture ONLY comma-separated rule-id tokens: trailing prose on the
# same pragma ("# mctpu: disable=MCT002 injectable default") must not
# be swallowed into the token, or the visibly-present pragma silently
# suppresses nothing.
_SUPPRESS_RE = re.compile(
    r"#\s*mctpu:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
)


class LintError(Exception):
    """Configuration/environment error (bad manifest, unparsable file):
    exit 2, distinct from findings (exit 1)."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at an exact source location. `path` is
    repo-root-relative POSIX (the baseline's stable key — absolute
    paths would break the committed file across checkouts)."""

    rule: str
    path: str
    line: int
    col: int
    msg: str

    def key(self) -> tuple[str, str, int]:
        """Baseline identity: rule + file + line. Column is excluded so
        a same-line reformat does not resurrect a baselined finding."""
        return (self.rule, self.path, self.line)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.msg}"


class FileContext:
    """Everything a rule may consult about the file under analysis."""

    def __init__(self, rel: str, source: str, tree: ast.Module,
                 manifest: Manifest):
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.manifest = manifest
        self.findings: list[Finding] = []
        self._suppressed = _suppression_map(self.lines)
        self._bindings: dict[str, str] | None = None

    @property
    def is_test(self) -> bool:
        parts = self.rel.split("/")
        return "tests" in parts or Path(self.rel).name.startswith("test_")

    @property
    def import_bindings(self) -> dict[str, str]:
        """name -> canonical dotted origin for every import in the file
        (`import time as t` -> {"t": "time"}, `from datetime import
        datetime as dt` -> {"dt": "datetime.datetime"}). Computed once
        per file and shared by every rule that needs to resolve an
        aliased or from-imported spelling back to its module — so
        `t.monotonic()` and `dt.now()` cannot evade a module-keyed ban,
        and `from jax import random` is distinguishable from the stdlib
        `random`. Relative imports are first-party and excluded (rules
        that care about those resolve them path-wise, see MCT001)."""
        if self._bindings is None:
            b: dict[str, str] = {}
            for node in ast.walk(self.tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        b[a.asname or a.name.split(".", 1)[0]] = (
                            a.name if a.asname else a.name.split(".", 1)[0])
                elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                        and node.module:
                    for a in node.names:
                        if a.name != "*":
                            b[a.asname or a.name] = \
                                f"{node.module}.{a.name}"
            self._bindings = b
        return self._bindings

    def canonical(self, dotted: str) -> str:
        """Rewrite a dotted chain's head through import_bindings:
        "t.monotonic" -> "time.monotonic", "dt.now" ->
        "datetime.datetime.now". Unbound heads pass through."""
        head, _, rest = dotted.partition(".")
        origin = self.import_bindings.get(head)
        if origin is None:
            return dotted
        return f"{origin}.{rest}" if rest else origin

    def report(self, rule: str, node: ast.AST, msg: str) -> None:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0) + 1
        if not self.suppressed(rule, line):
            self.findings.append(Finding(rule, self.rel, line, col, msg))

    def suppressed(self, rule: str, line: int) -> bool:
        active = self._suppressed.get(line, frozenset())
        return rule in active or "all" in active


def _suppression_map(lines: list[str]) -> dict[int, frozenset[str]]:
    """line (1-based) -> rule ids suppressed there. A comment-only line
    carrying a disable pragma suppresses the next non-blank line too
    (same-line pragmas on 100-char lines rarely fit)."""
    out: dict[int, set[str]] = {}
    pending: set[str] | None = None
    for i, text in enumerate(lines, 1):
        m = _SUPPRESS_RE.search(text)
        stripped = text.strip()
        if m:
            rules = {r.strip() for r in m.group(1).split(",")}
            out.setdefault(i, set()).update(rules)
            if stripped.startswith("#"):
                pending = rules  # standalone pragma: covers the next line
                continue
        elif pending is not None and stripped and not stripped.startswith("#"):
            out.setdefault(i, set()).update(pending)
        if stripped:
            pending = None
    return {k: frozenset(v) for k, v in out.items()}


class Rule:
    """Base class: subclasses set `rule_id`, `title`, `node_types`, and
    implement `visit`. `begin_file` returning False skips the file
    entirely (scope decisions — manifests, test exclusions — live
    there, not in every visit)."""

    rule_id: str = "MCT000"
    title: str = ""
    node_types: tuple[type, ...] = ()

    def begin_file(self, ctx: FileContext) -> bool:
        return True

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        raise NotImplementedError

    def report(self, ctx: FileContext, node: ast.AST, msg: str) -> None:
        ctx.report(self.rule_id, node, msg)


def collect_files(root: Path, paths: list[str]) -> list[Path]:
    """Resolve PATHS (files or directories, relative to `root`) into the
    sorted .py file list to scan. Unknown paths are a config error —
    a typo'd path silently scanning nothing would green-light CI."""
    files: set[Path] = set()
    for p in paths:
        target = (root / p) if not Path(p).is_absolute() else Path(p)
        # Findings and manifest/baseline entries key on root-relative
        # paths, so a target outside the root has no stable identity —
        # a config error (exit 2), not a traceback.
        if not target.resolve().is_relative_to(root.resolve()):
            raise LintError(
                f"lint path {p} is outside the repo root {root} — "
                "findings are keyed root-relative; run from the repo "
                "or pass --manifest from the target checkout"
            )
        target = target.resolve()
        if target.is_file():
            files.add(target)
        elif target.is_dir():
            for f in sorted(target.rglob("*.py")):
                if not SKIP_DIRS.intersection(f.relative_to(root).parts):
                    files.add(f)
        else:
            raise LintError(f"lint path does not exist: {p}")
    return sorted(files)


def lint_file(path: Path, root: Path, rules: list[Rule],
              manifest: Manifest) -> list[Finding]:
    rel = path.relative_to(root).as_posix()
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        raise LintError(f"{rel}:{e.lineno}: cannot parse: {e.msg}") from e
    ctx = FileContext(rel, source, tree, manifest)
    active = [r for r in rules if r.begin_file(ctx)]
    if not active:
        return []
    # ONE walk, whatever the rule count: dispatch by node type.
    by_type: dict[type, list[Rule]] = {}
    for r in active:
        for t in r.node_types:
            by_type.setdefault(t, []).append(r)
    for node in ast.walk(tree):
        for r in by_type.get(type(node), ()):
            r.visit(node, ctx)
    return sorted(ctx.findings, key=lambda f: (f.line, f.col, f.rule))


def lint_paths(paths: list[str], *, root: Path, manifest: Manifest,
               rules: list[Rule] | None = None) -> list[Finding]:
    """Run `rules` (default: every shipped rule) over `paths`; findings
    come back sorted by (path, line, col, rule). The programmatic
    entry point — tests drive it with synthetic manifests."""
    if rules is None:
        from . import all_rules

        rules = all_rules()
    # One resolve up front: collect_files resolves each target, so the
    # root must be resolved too or relative_to mismatches on symlinked
    # roots (macOS /tmp, bind mounts).
    root = Path(root).resolve()
    findings: list[Finding] = []
    for f in collect_files(root, paths):
        findings.extend(lint_file(f, root, rules, manifest))
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def dotted_name(node: ast.AST) -> str | None:
    """Render a Name/Attribute chain ("self.compute.prefill_chunk");
    None for anything dynamic (subscripts, calls)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
