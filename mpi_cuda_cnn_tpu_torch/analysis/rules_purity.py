"""MCT001 — the port's purity (counterpart of the reference's jax-purity
rule, aimed at the port).

Two contracts:
- The port stands alone: a user of it has torch, numpy and the stdlib,
  no JAX. Importing jax/jaxlib, or the reference package
  `mpi_cuda_cnn_tpu`, is a finding in every file of the port, at
  module level or inside a function alike.
- The torch-free modules (the manifest's `torch_free` list: the fault
  plans, the scheduler/router/SLO layer, the run-file tools, `chaos/`,
  `autosize`, `analysis/` itself) run in offline tools and in the
  fleet's SimCompute storms without a card. In them a torch import is a
  finding — a lazy one too, as the reference flags a lazy jax import: it
  is still a torch dependency the first time the branch runs, so a
  deliberate one carries a commented suppression at the site. So is a
  direct import of a first-party module that is not itself declared
  torch-free (the one-level closure check: it may pull torch in
  transitively).
"""

from __future__ import annotations

import ast
from pathlib import Path

from .core import FileContext, Rule

_JAX_ROOTS = ("jax", "jaxlib")
# The reference package the port is held to; only the port's tests may
# import it.
REFERENCE_ROOT = "mpi_cuda_cnn_tpu"
_TORCH_ROOTS = ("torch",)


def _top(module: str | None) -> str:
    return (module or "").split(".", 1)[0]


class PurityRule(Rule):
    rule_id = "MCT001"
    title = ("port imports jax or the reference package, or a torch-free "
             "module imports torch or a module that is not torch-free")
    node_types = (ast.Import, ast.ImportFrom)

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                self._check_module(node, ctx, alias.name)
                if ctx.rel in ctx.manifest.torch_free and \
                        _top(alias.name) == ctx.manifest.first_party_root:
                    self._check_first_party(
                        node, ctx, alias.name.split("."), level=0)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                self._check_module(node, ctx, node.module)
            if ctx.rel in ctx.manifest.torch_free and (
                    node.level > 0 or _top(node.module)
                    == ctx.manifest.first_party_root):
                parts = node.module.split(".") if node.module else []
                self._check_first_party(node, ctx, parts, level=node.level)

    def _check_module(self, node: ast.AST, ctx: FileContext,
                      module: str | None) -> None:
        top = _top(module)
        if top in _JAX_ROOTS or top == REFERENCE_ROOT:
            self.report(
                ctx, node,
                f"the port imports {module!r} — it stands alone on torch, "
                "numpy and the stdlib (only its tests import the JAX "
                "package, as the reference they hold it to)",
            )
        elif top in _TORCH_ROOTS and ctx.rel in ctx.manifest.torch_free:
            self.report(
                ctx, node,
                f"module is declared torch-free (ci/torch_lint_manifest."
                f"json) but imports {module!r}",
            )

    def _check_first_party(self, node: ast.AST, ctx: FileContext,
                           parts: list[str], *, level: int) -> None:
        target = _resolve(ctx.rel, parts, level)
        if target is None or target in ctx.manifest.torch_free:
            return
        self.report(
            ctx, node,
            f"torch-free module imports first-party {target!r}, which is "
            "not declared torch-free — it may pull torch transitively "
            "(declare it in ci/torch_lint_manifest.json once it is, or "
            "move the needed helper into a torch-free module)",
        )


def _resolve(rel: str, parts: list[str], level: int) -> str | None:
    """Map an import in file `rel` to the repo-relative .py path of the
    imported module. The manifest lists concrete module files, so the
    .py form is the membership key; a package import (`from . import
    obs`, which runs an __init__ chain) resolves to the package's
    __init__.py, which is then held to the list like any module."""
    if level == 0:
        base: list[str] = []
        # Absolute: parts already start at the first-party root, which
        # is a directory at the repo root.
    else:
        parent = Path(rel).parent
        base = [] if parent == Path(".") else list(parent.parts)
        for _ in range(level - 1):
            if not base:
                return None
            base.pop()
    full = [*base, *parts]
    if not full:
        return None
    if not parts:
        # `from . import x`: the import target is the package __init__.
        return "/".join(full) + "/__init__.py"
    return "/".join(full) + ".py"
