"""The checked-in contract manifest the rules read
(ci/torch_lint_manifest.json; counterpart of the reference's
`analysis/manifest.py` and its ci/lint_manifest.json, which stays the
reference's own).

The analyzer encodes the repo's contracts, and a contract needs a
declaration site: which modules are torch-free (MCT001), which module
may read the wall clock (MCT002), and which function bodies are serving
hot loops with which device-value producers (MCT007). Keeping those in
one committed JSON file means a reviewer sees a change of scope as a
diff to the manifest, and tests can hand the rules a synthetic manifest
that points them at fixture files.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

MANIFEST_REL = "ci/torch_lint_manifest.json"


@dataclasses.dataclass(frozen=True)
class HotLoop:
    """One file's hot-loop declaration: `functions` are the def names
    whose bodies are scanned, `producers` the dotted call targets whose
    results are device tensors (the forwards and the documented
    device-tensor-returning helpers)."""

    functions: frozenset[str]
    producers: frozenset[str]


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Rule configuration. All paths are repo-root-relative POSIX."""

    # Modules declared torch-free: no torch import anywhere in the
    # module, and no direct first-party import of a module outside this
    # set (it may pull torch transitively). The package __init__ chain
    # is outside the contract: torch-free means the module's own code
    # adds no torch dependency. These are the counterparts of the
    # reference manifest's jax-free modules.
    torch_free: frozenset[str] = frozenset()
    # The one module allowed to read the wall clock (MCT002).
    clock_modules: frozenset[str] = frozenset()
    # file -> hot-loop declaration (MCT007).
    hot_loops: dict[str, HotLoop] = dataclasses.field(default_factory=dict)
    # Default scan scope for `lint` with no PATHS.
    paths: tuple[str, ...] = ("mpi_cuda_cnn_tpu_torch",)
    # Import prefix that counts as first-party for MCT001.
    first_party_root: str = "mpi_cuda_cnn_tpu_torch"


def load_manifest(path: str | Path) -> Manifest:
    from .core import LintError  # local: core imports Manifest

    p = Path(path)
    if not p.is_file():
        raise LintError(
            f"lint manifest not found: {p} — the analyzer's contracts "
            "(torch-free modules, the clock module, hot loops) live "
            "there; pass --manifest or run from the repo root"
        )
    try:
        raw = json.loads(p.read_text())
    except json.JSONDecodeError as e:
        raise LintError(f"{p}: bad JSON: {e}") from e
    known = {"_doc", "torch_free", "clock_modules", "hot_loops", "paths",
             "first_party_root"}
    unknown = sorted(set(raw) - known)
    if unknown:
        # A typo'd key would silently relax the contract it misspells
        # (and the reference's manifest, with its jax_free list, is not
        # this analyzer's).
        raise LintError(f"{p}: unknown manifest keys {unknown}")
    hot = {}
    for rel, spec in raw.get("hot_loops", {}).items():
        hot[rel] = HotLoop(functions=frozenset(spec.get("functions", ())),
                           producers=frozenset(spec.get("producers", ())))
    return Manifest(
        torch_free=frozenset(raw.get("torch_free", ())),
        clock_modules=frozenset(raw.get("clock_modules", ())),
        hot_loops=hot,
        paths=tuple(raw.get("paths", ("mpi_cuda_cnn_tpu_torch",))),
        first_party_root=raw.get("first_party_root",
                                 "mpi_cuda_cnn_tpu_torch"),
    )


def find_root(start: str | Path | None = None) -> Path:
    """Walk up from `start` (default: cwd) to the directory holding
    pyproject.toml — the repo root every manifest/baseline path is
    relative to."""
    from .core import LintError

    p = Path(start or Path.cwd()).resolve()
    if p.is_file():
        p = p.parent
    for candidate in (p, *p.parents):
        if (candidate / "pyproject.toml").is_file():
            return candidate
    raise LintError(
        f"no pyproject.toml above {p} — cannot locate the repo root "
        "(run from inside the repo or pass explicit paths)"
    )
