"""MCT007 — host sync on a device value inside a serving hot loop (the
reference's rule, its converters those of torch).

`int()` / `float()` / `.item()` / `.cpu()` / `.numpy()` / `.tolist()` /
`np.asarray()` / `np.array()` of a tensor still on the card, and
`torch.cuda.synchronize()` while one is pending, block the host until
the card has caught up. Once per batched tick that is the sanctioned
sync point; once per prefill chunk it serializes the whole pipeline,
which is why `run_prefill_chunk` returns the next token as a device
tensor and the caller converts it only on the completing chunk.

Statically, "is this value on the device" needs dataflow, so the rule
is scoped by the manifest: hot_loops declares, per file, the function
bodies that are serving hot loops and the dotted call targets whose
results are device tensors (the paged forward, the kernels' launch
helpers, `self.run_prefill_chunk`). Inside a hot function the rule
walks statements in source order, tainting names assigned from
producer calls (tuple unpacking taints every target — which element
holds the device tensor is not statically knowable) and clearing taint
on reassignment from clean values; a conversion whose argument (or
receiver) involves a tainted name or a producer call directly is a
finding, and so is `torch.cuda.synchronize()` while any name but the
discard `_` is tainted.

The sanctioned syncs in the shipped tree — the batched decode tick's
and verify round's one transfer, the completing prefill chunk's int(),
the spill tier's page copy — carry commented suppressions at the site:
the rule's job is to make the next per-chunk sync impossible to add
silently, not to relitigate the ones the design documents.
"""

from __future__ import annotations

import ast

from .core import FileContext, Rule, dotted_name

_CONVERTERS_NAME = {"int", "float"}
_CONVERTERS_DOTTED = {"np.asarray", "np.array", "numpy.asarray",
                      "numpy.array"}
# Tensor methods that copy to the host (argument-free calls).
_CONVERTER_METHODS = {"item", "cpu", "numpy", "tolist"}
_SYNCHRONIZE = {"torch.cuda.synchronize"}


def _stmt_exprs(stmt: ast.stmt):
    """The statement's OWN expressions (test/value/iter/...), excluding
    nested statement blocks — those are walked recursively in source
    order so assignments update taint at the right point."""
    for _, value in ast.iter_fields(stmt):
        if isinstance(value, ast.expr):
            yield value
        elif isinstance(value, list):
            for v in value:
                if isinstance(v, ast.expr):
                    yield v
                elif isinstance(v, ast.withitem):
                    yield v.context_expr


class HostSyncRule(Rule):
    rule_id = "MCT007"
    title = "host sync on a device value inside a declared hot loop"
    node_types = (ast.FunctionDef, ast.AsyncFunctionDef)

    def begin_file(self, ctx: FileContext) -> bool:
        self._spec = ctx.manifest.hot_loops.get(ctx.rel)
        return self._spec is not None

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        assert isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        if node.name not in self._spec.functions:
            return
        walker = _TaintWalker(self, ctx, self._spec.producers)
        walker.run(node.body)


class _TaintWalker:
    """Source-order statement walk with a name-level taint set.

    Deliberately linear (no loop fixed point): taint introduced late in
    a loop body does not flow back to the top. The hot loops this rule
    guards assign their device results and convert them within one
    iteration's straight-line code, and a linear walk keeps findings
    explainable — the producer assignment is always textually above the
    flagged conversion.
    """

    def __init__(self, rule: Rule, ctx: FileContext,
                 producers: frozenset[str]):
        self.rule = rule
        self.ctx = ctx
        self.producers = producers
        self.tainted: set[str] = set()

    # -- taint queries ----------------------------------------------------

    def _is_producer_call(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and dotted_name(node.func) in self.producers)

    def _expr_tainted(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id in self.tainted:
                return True
            if self._is_producer_call(sub):
                return True
        return False

    # -- walk -------------------------------------------------------------

    def run(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        # Flag conversions BEFORE updating taint: `x = int(x)` on a
        # tainted x is still a sync.
        for expr in _stmt_exprs(stmt):
            self._scan_conversions(expr)
        if isinstance(stmt, ast.Assign):
            tainted = self._expr_tainted(stmt.value)
            for target in stmt.targets:
                self._assign(target, tainted)
        elif isinstance(stmt, ast.AugAssign):
            if self._expr_tainted(stmt.value) and \
                    isinstance(stmt.target, ast.Name):
                self.tainted.add(stmt.target.id)
        # Recurse into compound statements in source order; nested
        # function/class defs are separate scopes the manifest would
        # name explicitly.
        for body_attr in ("body", "orelse", "finalbody"):
            for sub in getattr(stmt, body_attr, ()):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.ClassDef)):
                    continue
                if isinstance(sub, ast.stmt):
                    self._stmt(sub)
        for handler in getattr(stmt, "handlers", ()):
            for sub in handler.body:
                self._stmt(sub)
        # A `match` statement's cases (the reference's walk stops at
        # them): each guard is scanned, each body walked in order.
        for case in getattr(stmt, "cases", ()):
            if case.guard is not None:
                self._scan_conversions(case.guard)
            for sub in case.body:
                self._stmt(sub)

    def _assign(self, target: ast.expr, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            # Which element carries the device array is not statically
            # knowable: taint (or clear) them all.
            for elt in target.elts:
                self._assign(elt, tainted)

    def _scan_conversions(self, expr: ast.AST) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            # int(x) / float(x)
            if isinstance(func, ast.Name) and func.id in _CONVERTERS_NAME:
                if node.args and self._expr_tainted(node.args[0]):
                    self._flag(node, f"{func.id}()")
            # np.asarray(x) / np.array(x)
            elif (dn := dotted_name(func)) in _CONVERTERS_DOTTED:
                if node.args and self._expr_tainted(node.args[0]):
                    self._flag(node, f"{dn}()")
            # torch.cuda.synchronize() with a device value pending
            elif dn is not None and self.ctx.canonical(dn) in _SYNCHRONIZE:
                # `_` is the discard name: nothing pending is bound there.
                if self.tainted - {"_"} or any(self._expr_tainted(a)
                                               for a in node.args):
                    self._flag(node, f"{dn}()")
            # x.item() / x.cpu() / x.numpy() / x.tolist()
            elif isinstance(func, ast.Attribute) \
                    and func.attr in _CONVERTER_METHODS \
                    and not node.args and self._expr_tainted(func.value):
                self._flag(node, f".{func.attr}()")

    def _flag(self, node: ast.Call, what: str) -> None:
        self.rule.report(
            self.ctx, node,
            f"{what} on a device value inside a declared hot loop forces "
            "a blocking device->host sync — keep it a device array "
            "(convert once per tick / on the completing chunk, with a "
            "commented suppression at the sanctioned site)",
        )
