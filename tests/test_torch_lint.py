"""The port's `lint` (`analysis/`, run as `python -m mpi_cuda_cnn_tpu_torch
lint`) against the JAX package's analyzer on the CPU.

The engine is the reference's (findings, suppressions, the baseline,
exit codes 0/1/2, `--format json`), its rules aimed at the port:
- on the JAX package's own rule fixtures, the port's MCT002 and
  MCT004-MCT006, and MCT007's shared converters, report the same rule,
  line, column and message as the JAX rules;
- each rule of the port's own has a fixture that must fire at pinned
  lines and a clean twin that must stay silent: MCT001's jax, reference
  and torch imports (the torch-free modules of the manifest), MCT004's
  global torch generator, MCT007's torch converters (and `match` cases,
  decorated hot functions);
- MCT003 (buffer donation) is not registered: `--rule MCT003` is an
  unknown rule, exit 2 with the reference's message;
- the port's tree is finding-free under ci/torch_lint_manifest.json with
  the empty ci/torch_lint_baseline.json, and every module the manifest
  declares torch-free imports with torch absent.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

from mpi_cuda_cnn_tpu.analysis import lint_paths as jax_lint_paths
from mpi_cuda_cnn_tpu.analysis.cli import lint_main as jax_lint_main
from mpi_cuda_cnn_tpu.analysis.manifest import HotLoop as JaxHotLoop
from mpi_cuda_cnn_tpu.analysis.manifest import Manifest as JaxManifest
from mpi_cuda_cnn_tpu.analysis.rules_crosscheck import (
    FaultSiteRule as JaxFaultSiteRule,
)
from mpi_cuda_cnn_tpu.analysis.rules_crosscheck import (
    SchemaFamilyRule as JaxSchemaFamilyRule,
)
from mpi_cuda_cnn_tpu.analysis.rules_discipline import ClockRule as JaxClock
from mpi_cuda_cnn_tpu.analysis.rules_discipline import RngRule as JaxRng
from mpi_cuda_cnn_tpu.analysis.rules_hotloop import HostSyncRule as JaxSync
from mpi_cuda_cnn_tpu_torch.analysis import (
    ALL_RULES,
    LintError,
    all_rules,
    lint_paths,
    load_baseline,
    load_manifest,
    write_baseline,
)
from mpi_cuda_cnn_tpu_torch.analysis.baseline import apply_baseline
from mpi_cuda_cnn_tpu_torch.analysis.cli import lint_main
from mpi_cuda_cnn_tpu_torch.analysis.manifest import HotLoop, Manifest
from mpi_cuda_cnn_tpu_torch.analysis.rules_crosscheck import (
    FaultSiteRule,
    SchemaFamilyRule,
)
from mpi_cuda_cnn_tpu_torch.analysis.rules_discipline import ClockRule, RngRule
from mpi_cuda_cnn_tpu_torch.analysis.rules_hotloop import HostSyncRule
from mpi_cuda_cnn_tpu_torch.cli import main
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

REPO = Path(__file__).resolve().parents[1]


def _write(root: Path, files: dict[str, str]) -> None:
    for rel, source in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(source)


def run_lint(tmp_path, files: dict[str, str], *, manifest=None, rules=None):
    _write(tmp_path, files)
    return lint_paths(list(files), root=tmp_path,
                      manifest=manifest or Manifest(), rules=rules)


def keys(findings):
    return [(f.rule, f.path, f.line) for f in findings]


def _run(fn, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def test_rules_registered_without_donation():
    assert [cls.rule_id for cls in ALL_RULES] == [
        "MCT001", "MCT002", "MCT004", "MCT005", "MCT006", "MCT007"]


# -- parity with the JAX rules on the JAX package's fixtures --------------

# (rule pair, source) of tests/test_lint.py's fixtures, firing and clean
SHARED = [
    ("clock", "import time\ndeadline = time.monotonic() + 5\n"
              "t0 = time.time()\n"),
    ("clock", "import time as t\nfrom datetime import datetime as dt\n"
              "from time import monotonic\na = t.monotonic()\nb = dt.now()\n"),
    ("clock", "import time\ndef f(clock=time.perf_counter):\n"
              "    return clock()\n"),
    ("clock", "import time\na = time.monotonic()  # mctpu: disable=MCT002\n"
              "# mctpu: disable=MCT002\nb = time.monotonic()\n"
              "c = time.monotonic()\n"),
    ("clock", "import time\na = time.monotonic()  # mctpu: disable=MCT004\n"),
    ("rng", "import random\nimport numpy as np\nx = random.random()\n"
            "y = np.random.rand(3)\nnp.random.seed(0)\n"),
    ("rng", "import numpy as np\nrng = np.random.default_rng(0)\n"
            "g = np.random.Generator(np.random.PCG64(1))\n"
            "from random import shuffle\nfrom numpy.random import rand\n"),
    ("schema", "metrics.log(\"not_a_family\", step=1)\n"
               "rec = make_record(\"bogus_event\", 0.0, x=1)\n"
               "metrics.log(\"train\", step=1, loss=0.5)\n"
               "rec = make_record(\"bench\", 0.0, metric=\"m\", value=1)\n"
               "metrics.log(event, step=2)\nimport math\n"
               "y = math.log(2.0)\n"),
    ("sites", "for f in faults.fire(\"serve.tock\", i):\n    pass\n"
              "faults.fire(\"serve.tick\", i)\nfaults.fire(\"fleet.tick\", t)\n"
              "faults.fire(site, t)\n"),
    ("sync", "import numpy as np\nclass E:\n    def run(self):\n"
             "        cache, nxt = self._tick(1)\n        a = int(nxt)\n"
             "        b = np.asarray(nxt)\n        c = nxt.item()\n"
             "        return a, b, c\n"),
    ("sync", "class E:\n    def run(self):\n"
             "        cache, nxt = self._tick(1)\n        self.stash(nxt)\n"
             "        nxt = self.decode_host(2)\n        n = int(nxt)\n"
             "        return n, int(self.counter)\n    def cold(self):\n"
             "        _, nxt = self._tick(1)\n        return int(nxt)\n"),
]
RULES = {"clock": (ClockRule, JaxClock), "rng": (RngRule, JaxRng),
         "schema": (SchemaFamilyRule, JaxSchemaFamilyRule),
         "sites": (FaultSiteRule, JaxFaultSiteRule),
         "sync": (HostSyncRule, JaxSync)}


@pytest.mark.parametrize("i", range(len(SHARED)))
def test_shared_rules_report_as_the_jax_rules(tmp_path, i):
    kind, source = SHARED[i]
    ours, theirs = RULES[kind]
    _write(tmp_path, {"mod.py": source})
    hot = {"mod.py": ("run",), "producers": ("self._tick",)}
    manifest = Manifest(hot_loops={"mod.py": HotLoop(
        functions=frozenset(hot["mod.py"]),
        producers=frozenset(hot["producers"]))})
    jmanifest = JaxManifest(hot_loops={"mod.py": JaxHotLoop(
        functions=frozenset(hot["mod.py"]),
        producers=frozenset(hot["producers"]))})
    got = lint_paths(["mod.py"], root=tmp_path, manifest=manifest,
                     rules=[ours()])
    want = jax_lint_paths(["mod.py"], root=tmp_path, manifest=jmanifest,
                          rules=[theirs()])
    assert [(f.rule, f.path, f.line, f.col, f.msg) for f in got] == \
        [(f.rule, f.path, f.line, f.col, f.msg) for f in want]


def test_shared_fixtures_fire_at_the_jax_tests_lines(tmp_path):
    """The pinned lines of the JAX tests, on the port's engine with every
    rule: the fixtures that fire fire where those tests pin them."""
    want = {0: [("MCT002", 2), ("MCT002", 3)],
            1: [("MCT002", 3), ("MCT002", 4), ("MCT002", 5)],
            2: [], 3: [("MCT002", 5)], 4: [("MCT002", 2)],
            5: [("MCT004", 3), ("MCT004", 4), ("MCT004", 5)],
            7: [("MCT005", 1), ("MCT005", 2)], 8: [("MCT006", 1)]}
    for i, lines in want.items():
        found = run_lint(tmp_path / str(i), {"mod.py": SHARED[i][1]},
                         rules=all_rules())
        assert [(f.rule, f.line) for f in found] == lines, i


# -- MCT001: the port's purity ------------------------------------------

PURE = Manifest(torch_free=frozenset({"pkg/free.py", "pkg/helper.py"}),
                first_party_root="pkg")


def test_mct001_fires_on_jax_and_reference_imports_anywhere(tmp_path):
    src = ("import jax\n"
           "from mpi_cuda_cnn_tpu.obs import schema\n"
           "import torch\n"
           "def f():\n"
           "    import jax.numpy as jnp\n"
           "    import mpi_cuda_cnn_tpu\n"
           "    from jaxlib import xla_client\n"
           "    return jnp, schema, torch, xla_client\n")
    found = run_lint(tmp_path, {"pkg/heavy.py": src}, manifest=PURE)
    assert keys(found) == [("MCT001", "pkg/heavy.py", n)
                           for n in (1, 2, 5, 6, 7)]


def test_mct001_fires_on_torch_in_a_torch_free_module(tmp_path):
    src = ("import numpy as np\n"
           "import torch\n"
           "from .heavy import thing\n"
           "from torch.nn import functional as F\n"
           "import pkg.heavy\n"
           "def f():\n"
           "    import torch.nn\n"
           "    from . import heavy\n"
           "    return np, thing, F, torch.nn, heavy\n")
    found = run_lint(tmp_path, {"pkg/free.py": src}, manifest=PURE)
    assert keys(found) == [("MCT001", "pkg/free.py", n)
                           for n in (2, 3, 4, 5, 7, 8)]
    msgs = [f.msg for f in found]
    assert "declared torch-free" in msgs[0] and "'torch'" in msgs[0]
    assert "'pkg/heavy.py'" in msgs[1]


def test_mct001_clean_twin(tmp_path):
    free = ("import numpy as np\n"
            "from .helper import thing\n"
            "import pkg.helper\n"
            "def f():\n"
            "    import torch  # mctpu: disable=MCT001 trainers only\n"
            "    return np, thing, torch\n")
    heavy = ("import torch\nimport triton\nfrom .free import f\n"
             "import mpi_cuda_cnn_tpu_torch.obs\n")
    found = run_lint(tmp_path, {"pkg/free.py": free, "pkg/heavy.py": heavy,
                                "pkg/helper.py": "thing = 1\n"},
                     manifest=PURE)
    assert found == []


# -- MCT004: torch's global generator ------------------------------------


def test_mct004_fires_on_torch_global_generator(tmp_path):
    src = ("import torch\n"
           "from torch import randn, manual_seed\n"
           "torch.manual_seed(0)\n"
           "x = torch.rand(3)\n"
           "y = randn(2, 2)\n"
           "torch.cuda.manual_seed_all(1)\n"
           "p = torch.randperm(5)\n"
           "z = torch.randn_like(x)\n"
           "manual_seed(3)\n")
    found = run_lint(tmp_path, {"mod.py": src})
    assert keys(found) == [("MCT004", "mod.py", n)
                           for n in (3, 4, 5, 6, 7, 8, 9)]


def test_mct004_torch_clean_twin(tmp_path):
    src = ("import torch\n"
           "g = torch.Generator().manual_seed(0)\n"
           "x = torch.rand(3, generator=g)\n"
           "p = torch.randperm(5, generator=g)\n"
           "y = torch.randint(0, 9, (4,), generator=g)\n"
           "z = torch.zeros(3).uniform_(generator=g)\n")
    assert run_lint(tmp_path, {"mod.py": src}) == []
    assert run_lint(tmp_path, {"test_mod.py": "import torch\n"
                               "torch.manual_seed(0)\n"}) == []


# -- MCT007: torch's converters -------------------------------------------

HOT = Manifest(hot_loops={"mod.py": HotLoop(
    functions=frozenset({"run", "tick"}),
    producers=frozenset({"paged_forward", "self.run_prefill_chunk"}))})


def test_mct007_fires_on_torch_converters(tmp_path):
    src = ("import numpy as np\n"
           "import torch\n"
           "class E:\n"
           "    @torch.no_grad()\n"
           "    def run(self, slot):\n"
           "        logits, _ = paged_forward(self.model, slot)\n"
           "        a = logits.cpu()\n"
           "        b = torch.argmax(logits).numpy()\n"
           "        c = logits.tolist()\n"
           "        d = np.array(logits)\n"
           "        torch.cuda.synchronize()\n"
           "        e = float(paged_forward(self.model, slot)[0].sum())\n"
           "        return a, b, c, d, e\n"
           "    def tick(self, slot):\n"
           "        n, nxt = self.run_prefill_chunk(slot)\n"
           "        match n:\n"
           "            case 0:\n"
           "                return int(nxt)\n"
           "            case _ if nxt.item() > 0:\n"
           "                return n\n")
    found = run_lint(tmp_path, {"mod.py": src}, manifest=HOT)
    assert [(f.rule, f.line, f.msg.split(" on ")[0]) for f in found] == [
        ("MCT007", 7, ".cpu()"), ("MCT007", 8, ".numpy()"),
        ("MCT007", 9, ".tolist()"), ("MCT007", 10, "np.array()"),
        ("MCT007", 11, "torch.cuda.synchronize()"),
        ("MCT007", 12, "float()"), ("MCT007", 18, "int()"),
        ("MCT007", 19, ".item()")]


def test_mct007_torch_clean_twin(tmp_path):
    src = ("import torch\n"
           "class E:\n"
           "    @torch.no_grad()\n"
           "    def run(self, slot):\n"
           "        torch.cuda.synchronize()\n"
           "        logits, _ = paged_forward(self.model, slot)\n"
           "        self.stash(logits)\n"
           "        logits = self.host_copy(slot)\n"
           "        torch.cuda.synchronize()\n"
           "        return logits.cpu().numpy(), int(slot.cached)\n"
           "    def cold(self, slot):\n"
           "        logits, _ = paged_forward(self.model, slot)\n"
           "        return logits.cpu()\n"
           "    def tick(self, slot):\n"
           "        n, nxt = self.run_prefill_chunk(slot)\n"
           "        # mctpu: disable=MCT007 once, on the completing chunk\n"
           "        return int(nxt)\n")
    assert run_lint(tmp_path, {"mod.py": src}, manifest=HOT) == []


# -- baseline and CLI -----------------------------------------------------


def test_baseline_round_trip(tmp_path):
    found = run_lint(tmp_path, {"mod.py": "import time\nx = time.time()\n"})
    assert len(found) == 1
    bl = tmp_path / "baseline.json"
    write_baseline(found, bl)
    known = load_baseline(bl)
    assert apply_baseline(found, known) == []
    found2 = run_lint(tmp_path, {"mod.py": "import time\nx = time.time()\n"
                                 "y = time.monotonic()\n"})
    assert keys(apply_baseline(found2, known)) == [("MCT002", "mod.py", 3)]
    bad = tmp_path / "b.json"
    bad.write_text("{\"version\": 99, \"findings\": []}")
    with pytest.raises(LintError):
        load_baseline(bad)


def _cli_fixture(tmp_path, source: str) -> tuple[Path, Path]:
    """A repo with mod.py under both packages' manifests."""
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    (tmp_path / "mod.py").write_text(source)
    ci = tmp_path / "ci"
    ci.mkdir()
    ours, theirs = ci / "torch_lint_manifest.json", ci / "lint_manifest.json"
    ours.write_text(json.dumps({"paths": ["mod.py"], "torch_free": []}))
    theirs.write_text(json.dumps({"paths": ["mod.py"], "jax_free": []}))
    return ours, theirs


def test_cli_exit_codes_and_json_match_the_reference(tmp_path):
    ours, theirs = _cli_fixture(tmp_path,
                                "import time\nt = time.time()\n")
    rc, out, _ = _run(lint_main, ["--manifest", str(ours), "--format",
                                  "json"])
    jrc, jout, _ = _run(jax_lint_main, ["--manifest", str(theirs),
                                        "--format", "json"])
    got, want = json.loads(out), json.loads(jout)
    assert rc == jrc == 1
    assert got["rules"] == [r for r in want["rules"] if r != "MCT003"]
    assert {k: v for k, v in got.items() if k != "rules"} == \
        {k: v for k, v in want.items() if k != "rules"}
    for argv in (["--rule", "MCT004"], ["--rule", "MCT999"]):
        assert _run(lint_main, ["--manifest", str(ours), *argv])[0] == \
            _run(jax_lint_main, ["--manifest", str(theirs), *argv])[0]
    assert _run(lint_main, ["--manifest", str(tmp_path / "no.json")])[0] \
        == 2
    # The reference's manifest is not this analyzer's: exit 2, by name.
    rc, _, err = _run(lint_main, ["--manifest", str(theirs)])
    assert rc == 2 and "jax_free" in err
    bl = tmp_path / "ci" / "torch_lint_baseline.json"
    assert _run(lint_main, ["--manifest", str(ours), "--write-baseline",
                            str(bl)])[0] == 0
    assert _run(lint_main, ["--manifest", str(ours), "--baseline",
                            str(bl)])[0] == 0


def test_mct003_is_an_unknown_rule(tmp_path):
    ours, _ = _cli_fixture(tmp_path, "x = 1\n")
    rc, out, err = _run(lint_main, ["--manifest", str(ours), "--rule",
                                    "MCT003"])
    assert rc == 2 and out == ""
    assert err == ("lint: error: unknown rule(s) MCT003 (known: MCT001, "
                   "MCT002, MCT004, MCT005, MCT006, MCT007)\n")


# -- the shipped tree -------------------------------------------------------


def test_port_tree_is_finding_free(monkeypatch):
    """`lint` of the port under its manifest and empty baseline exits 0:
    every finding is fixed or suppressed at the site."""
    monkeypatch.chdir(REPO)
    manifest = load_manifest(REPO / "ci" / "torch_lint_manifest.json")
    findings = lint_paths(list(manifest.paths), root=REPO,
                          manifest=manifest, rules=all_rules())
    assert findings == [], "\n".join(f.render() for f in findings)
    assert load_baseline(REPO / "ci" / "torch_lint_baseline.json") == set()
    rc, _, err = _run(main, ["lint", "--baseline",
                             "ci/torch_lint_baseline.json"])
    assert rc == 0 and "0 finding(s)" in err


def test_manifest_is_the_reference_manifests_counterpart():
    """torch_free is the JAX manifest's jax_free list under the port's
    package, and each hot-loop file exists with its functions."""
    import ast

    ours = json.loads((REPO / "ci" / "torch_lint_manifest.json").read_text())
    theirs = json.loads((REPO / "ci" / "lint_manifest.json").read_text())
    assert sorted(ours["torch_free"]) == sorted(
        p.replace("mpi_cuda_cnn_tpu/", "mpi_cuda_cnn_tpu_torch/", 1)
        for p in theirs["jax_free"])
    for rel, spec in ours["hot_loops"].items():
        tree = ast.parse((REPO / rel).read_text())
        defs = {n.name for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef)}
        assert set(spec["functions"]) <= defs, rel


# Runs in a fresh interpreter: this test process has imported torch.
_PROBE = """
import importlib, json, sys
sys.modules["torch"] = None        # any `import torch` now raises
sys.modules["jax"] = None
m = json.load(open("ci/torch_lint_manifest.json"))
for rel in m["torch_free"]:
    importlib.import_module(rel[:-3].replace("/", ".").removesuffix(".__init__"))
from mpi_cuda_cnn_tpu_torch.analysis.cli import lint_main
sys.exit(lint_main(["--rule", "MCT001"]))
"""


def test_torch_free_modules_import_without_torch():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
