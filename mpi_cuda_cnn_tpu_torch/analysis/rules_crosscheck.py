"""MCT005/MCT006 — cross-checks against the live registries (the
reference's rules, read against the port's registries).

The codebase already holds the specification — obs/schema.py's
EVENT_KEYS and faults.py's SITES — and the bug class is a string
literal at a call site drifting from it. A copy of either registry
inside the analyzer would itself drift, so the rules import the real
objects: when a family or hook site is added, the rule learns it in the
same commit.

MCT005 (schema families): a string literal passed as the event family
to a record emitter (`<sink>.log("family", ...)`, `make_record("family",
t, ...)`) must be a key of obs.schema.EVENT_KEYS. An unregistered
family validates at run time (families not in the registry are
free-form) and then falls out of every consumer's tables.

MCT006 (fault sites): a string literal at a `<injector>.fire("site",
...)` hook point must appear in faults.SITES under some surface. This
is the static half of faults.validate_plan_sites: the run-time half
rejects a plan naming an unknown site when the flags are parsed, but a
misspelt site at the emitting side would let every plan targeting the
real site validate and then never fire.
"""

from __future__ import annotations

import ast

from .core import FileContext, Rule

# Live registries — imported, not transcribed. Both home modules are
# declared torch-free in the manifest, so the analyzer imports no torch.
from ..faults import SITES
from ..obs.schema import EVENT_KEYS

# Emitter method names whose first positional string argument is an
# event family. `.log` covers MetricsLogger and every sink that mirrors
# its call shape; bare/attribute `make_record` covers the offline
# producers (bench scripts, tests' record builders).
_EMITTER_METHODS = {"log"}
_RECORD_BUILDERS = {"make_record"}


def _first_str_arg(node: ast.Call) -> ast.Constant | None:
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0]
    return None


class SchemaFamilyRule(Rule):
    rule_id = "MCT005"
    title = "event-family literal not in obs.schema.EVENT_KEYS"
    node_types = (ast.Call,)

    def __init__(self, families=None):
        # Injectable for tests; defaults to the live registry.
        self.families = frozenset(families if families is not None
                                  else EVENT_KEYS)

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        assert isinstance(node, ast.Call)
        func = node.func
        name = None
        if isinstance(func, ast.Attribute):
            name = func.attr
        elif isinstance(func, ast.Name):
            name = func.id
        if name in _EMITTER_METHODS and isinstance(func, ast.Attribute):
            lit = _first_str_arg(node)
            # Only string first-args are family literals — loggers'
            # `.log(level, msg)` and math.log(x) never match.
            if lit is not None and lit.value not in self.families:
                self.report(
                    ctx, lit,
                    f"event family {lit.value!r} is not registered in "
                    "obs.schema.EVENT_KEYS — unregistered records "
                    "silently fall out of report/trace/compare; register "
                    "the family (with its required keys) first",
                )
        elif name in _RECORD_BUILDERS:
            lit = _first_str_arg(node)
            if lit is not None and lit.value not in self.families:
                self.report(
                    ctx, lit,
                    f"make_record family {lit.value!r} is not registered "
                    "in obs.schema.EVENT_KEYS — register it (with its "
                    "required keys) before emitting",
                )


class FaultSiteRule(Rule):
    rule_id = "MCT006"
    title = "fault hook-site literal not in faults.SITES"
    node_types = (ast.Call,)

    def __init__(self, sites=None):
        if sites is None:
            sites = {site for surface in SITES.values() for site in surface}
        self.sites = frozenset(sites)

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        assert isinstance(node, ast.Call)
        func = node.func
        if not (isinstance(func, ast.Attribute) and func.attr == "fire"):
            return
        lit = _first_str_arg(node)
        if lit is not None and lit.value not in self.sites:
            self.report(
                ctx, lit,
                f"fault hook site {lit.value!r} is not in faults.SITES — "
                "plans can never target it (validate_plan_sites rejects "
                "them), so this hook point is dead; add the site to "
                "SITES under its CLI surface(s)",
            )
