"""MCT002/MCT004 — clock and RNG discipline (the reference's rules; MCT004
also bans torch's global generator).

Two rules with one shape: a capability the framework routes through
one sanctioned spelling, and a banned raw form everywhere else.

MCT002 (clock): every serving, fleet and elasticity proof is
bit-for-bit deterministic because wall-clock only ever enters through
an injectable `clock` parameter (FakeClock substitutes it in tests). A
raw `time.time()` / `time.monotonic()` / `datetime.now()` read anywhere
else is a nondeterminism leak that FakeClock cannot reach. The one
sanctioned home for real wall-clock reads is the manifest's
clock_modules (utils/clock.py). `time.perf_counter` is deliberately NOT
banned: it is the injectable-clock *default value* convention
("`clock` has the time.perf_counter call shape") — the discipline is
about call sites, and a default argument is the injection point itself.

MCT004 (RNG): every random draw threads a seeded generator
(np.random.default_rng(seed), random.Random(seed), data/prng.py's
threefry keys, a torch.Generator); the global-state conveniences
(np.random.rand, random.random, np.random.seed, torch.manual_seed, and
torch.rand/randn/randint/randperm/... without `generator=`) make runs
irreproducible and break the elastic "global batch is a pure function
of (seed, step)" contract. Tests are exempt (they own their seeds);
injectable jitter defaults (faults.supervise, utils/retry) carry
commented suppressions — visible exceptions, not silent ones.
"""

from __future__ import annotations

import ast

from .core import FileContext, Rule, dotted_name

# Canonical dotted names whose evaluation reads the wall clock. Call
# sites are matched AFTER resolving import aliases through
# ctx.canonical (`import time as t; t.monotonic()` and
# `from datetime import datetime as dt; dt.now()` both resolve), and
# `from time import monotonic`-style imports are flagged at the import
# itself — a from-import is the evasion, not its later call sites.
_BANNED_CLOCK = {
    "time.time", "time.monotonic", "time.monotonic_ns", "time.time_ns",
    "time.localtime", "time.gmtime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

# np.random attributes that are NOT the global-state API: seeded
# construction stays legal everywhere.
_NP_RANDOM_OK = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937", "RandomState",
}
# stdlib random attributes that construct an owned, seedable instance.
_STDLIB_RANDOM_OK = {"Random", "SystemRandom"}
# torch calls that seed the process-global generator (any call is a
# finding) and torch draws that use it unless given `generator=` (the
# *_like draws take none, so any call of one is a finding).
_TORCH_GLOBAL_SEED = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
}
_TORCH_DRAWS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
    "torch.poisson", "torch.rand_like", "torch.randn_like",
    "torch.randint_like",
}


class ClockRule(Rule):
    rule_id = "MCT002"
    title = "raw wall-clock read outside the allowlisted clock module"
    node_types = (ast.Attribute, ast.ImportFrom)

    def begin_file(self, ctx: FileContext) -> bool:
        return (ctx.rel not in ctx.manifest.clock_modules
                and not ctx.is_test)

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.ImportFrom):
            # `from time import monotonic` (any alias) binds a banned
            # reader to a bare name no attribute match can see — flag
            # the import. `from datetime import datetime` is fine: its
            # .now() call sites canonicalize and match below.
            for a in node.names:
                full = f"{node.module}.{a.name}" if node.module else a.name
                if node.level == 0 and full in _BANNED_CLOCK:
                    self.report(
                        ctx, node,
                        f"`from {node.module} import {a.name}` binds a "
                        "raw wall-clock reader — take an injectable "
                        "clock or use utils/clock.py",
                    )
            return
        name = dotted_name(node)
        if name is None:
            return
        if ctx.canonical(name) in _BANNED_CLOCK:
            self.report(
                ctx, node,
                f"wall-clock read {name!r} outside the clock module — "
                "take an injectable clock (perf_counter call shape; "
                "FakeClock substitutes it) or use utils/clock.py, the "
                "one sanctioned wall-clock surface",
            )


class RngRule(Rule):
    rule_id = "MCT004"
    title = "global-state RNG outside tests"
    node_types = (ast.Attribute, ast.ImportFrom, ast.Call)

    def begin_file(self, ctx: FileContext) -> bool:
        return not ctx.is_test

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.Call):
            self._visit_torch_call(node, ctx)
            return
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level == 0 and mod == "random":
                bad = [a.name for a in node.names
                       if a.name not in _STDLIB_RANDOM_OK]
                if bad:
                    self.report(
                        ctx, node,
                        f"`from random import {', '.join(bad)}` pulls the "
                        "process-global RNG — thread a seeded "
                        "np.random.default_rng / random.Random instead",
                    )
            elif node.level == 0 and mod == "numpy.random":
                bad = [a.name for a in node.names
                       if a.name not in _NP_RANDOM_OK]
                if bad:
                    self.report(
                        ctx, node,
                        f"`from numpy.random import {', '.join(bad)}` is "
                        "the global-state API — use default_rng(seed)",
                    )
            return
        name = dotted_name(node)
        if name is None:
            return
        # Resolve aliases through the file's own imports: `np.random.X`
        # canonicalizes to numpy.random.X; a `random` bound by
        # `from jax import random` canonicalizes to jax.random and is
        # seeded-key threading, not a violation.
        parts = ctx.canonical(name).split(".")
        if (len(parts) == 3 and parts[0] == "numpy" and parts[1] == "random"
                and parts[2] not in _NP_RANDOM_OK):
            self.report(
                ctx, node,
                f"{name} draws from numpy's process-global RNG — "
                "irreproducible; thread np.random.default_rng(seed)",
            )
        elif (len(parts) == 2 and parts[0] == "random"
                and parts[1] not in _STDLIB_RANDOM_OK):
            self.report(
                ctx, node,
                f"{name} draws from the process-global stdlib RNG — "
                "irreproducible; thread a seeded random.Random or "
                "np.random.default_rng",
            )

    def _visit_torch_call(self, node: ast.Call, ctx: FileContext) -> None:
        """torch's global generator: seeding it, or drawing from it
        without `generator=`. Spellings resolve through the file's
        imports (`from torch import manual_seed`, `import torch as t`)."""
        name = dotted_name(node.func)
        if name is None:
            return
        full = ctx.canonical(name)
        if full in _TORCH_GLOBAL_SEED:
            self.report(
                ctx, node,
                f"{name}() seeds torch's process-global generator — "
                "thread a seeded torch.Generator (or data/prng.py keys) "
                "instead",
            )
        elif full in _TORCH_DRAWS and not any(
                kw.arg == "generator" for kw in node.keywords):
            self.report(
                ctx, node,
                f"{name}() draws from torch's process-global generator — "
                "irreproducible; pass generator= a seeded "
                "torch.Generator",
            )
