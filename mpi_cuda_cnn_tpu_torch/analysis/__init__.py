"""analysis — the static analyzer behind `python -m mpi_cuda_cnn_tpu_torch
lint` (counterpart of the reference's `analysis/` package: the same
engine, its rules aimed at the port).

The port keeps contracts that no test sees directly: it stands alone on
torch, numpy and the stdlib; the modules the offline tools load import
no torch; wall-clock reads go through an injectable clock; every random
draw threads a seeded generator; every JSONL record uses a registered
schema family; every fault hook site is in faults.SITES; and the
serving hot loops sync the card once a tick, not once a chunk. This
package states them as AST rules over the port's sources.

Layout:
- `core`        — Finding, the Rule protocol, the shared single-pass
                  visitor, per-line `# mctpu: disable=MCTxxx` suppressions.
- `manifest`    — the checked-in contract manifest
                  (ci/torch_lint_manifest.json): the torch-free modules,
                  the clock module, the hot-loop sites.
- `rules_purity`     — MCT001: no jax and no reference package anywhere
                  in the port; no torch and no undeclared first-party
                  module in the torch-free ones.
- `rules_discipline` — MCT002 clock, MCT004 RNG (numpy's, the stdlib's
                  and torch's global generators).
- `rules_crosscheck` — MCT005 schema families, MCT006 fault sites
                  (against the live registries of obs/schema.py and
                  faults.py).
- `rules_hotloop`    — MCT007 host sync in a serving hot loop.
- `baseline`    — the committed zero-entry baseline
                  (ci/torch_lint_baseline.json).
- `cli`         — `lint [PATHS] [--rule MCTxxx] [--format json]`.

The reference's MCT003 (buffer donation through one helper) has no
meaning here: a torch update is in place. It is not registered, and
`--rule MCT003` is an unknown rule.

This package is itself torch-free: `lint` runs on a machine with no
card and no accelerator stack.
"""

from __future__ import annotations

from .baseline import load_baseline, write_baseline
from .core import Finding, LintError, Rule, lint_paths
from .manifest import Manifest, find_root, load_manifest
from .rules_crosscheck import FaultSiteRule, SchemaFamilyRule
from .rules_discipline import ClockRule, RngRule
from .rules_hotloop import HostSyncRule
from .rules_purity import PurityRule

__all__ = [
    "ALL_RULES",
    "Finding",
    "LintError",
    "Manifest",
    "Rule",
    "all_rules",
    "find_root",
    "lint_paths",
    "load_baseline",
    "load_manifest",
    "write_baseline",
]

# The shipped rule set, in rule-id order. A rule class is instantiated
# per lint run (rules hold no cross-run state).
ALL_RULES = (
    PurityRule,         # MCT001
    ClockRule,          # MCT002
    RngRule,            # MCT004
    SchemaFamilyRule,   # MCT005
    FaultSiteRule,      # MCT006
    HostSyncRule,       # MCT007
)


def all_rules() -> list[Rule]:
    """Fresh instances of every shipped rule."""
    return [cls() for cls in ALL_RULES]
