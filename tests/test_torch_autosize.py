"""The port's `autosize` (`obs/autosize.py`, run as `python -m
mpi_cuda_cnn_tpu_torch autosize`) against the JAX package's on the CPU.

For the same flags the two print the same bytes in both formats, write
the same `--metrics-jsonl` records and exit with the same codes: the
sweep is a pure function of (seed, spec), and every candidate is a
SimCompute storm of the port's fleet, so every CRC (trace, state, blame,
frontier, recommendation) equals the JAX one. The flag sets cover each
sweep axis: topologies at budgets 2-4, `--len-dist both`, `--schedulers
both`, `--prefix both` with `--spill both` and a template mix, `--spec
both`, tenants and deadlines.

The reference's own claims hold on the port too: a candidate's storm
CRCs equal the port's `fleet-bench` for the same flags; the budget-4
frontier ranks 1:3 over 2:2; `--seed-from` a port `fleet-bench` run file
prunes to fewer candidates with the same recommendation; two runs pass
the port's `compare` under ci/autosize_gate.json; and the frontier
record drives the port's `fleet-bench --autoscale on
--autoscale-frontier` to the JAX run's trace CRC.
"""

import contextlib
import io
import json
from pathlib import Path

import pytest

from mpi_cuda_cnn_tpu.obs.autosize import autosize_main as jax_autosize
from mpi_cuda_cnn_tpu.serve.bench import fleet_bench_main as jax_fleet_bench
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.obs.autosize import autosize_main
from mpi_cuda_cnn_tpu_torch.obs.regress import compare_main
from mpi_cuda_cnn_tpu_torch.obs.schema import load_records
from mpi_cuda_cnn_tpu_torch.serve.autoscale import load_frontier
from mpi_cuda_cnn_tpu_torch.serve.bench import fleet_bench_main
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

REPO = Path(__file__).resolve().parents[1]

# The JAX package's tests' sweep: budget 4 (the frontier the 1:3 over
# 2:2 claim is about), 120 requests at 200 req/s, seed 0.
BASE = ["--budget", "4", "--requests", "120", "--rate", "200",
        "--seed", "0"]

FLAG_SETS = {
    "md": BASE,
    "axes": ["--budget", "2", "--requests", "40", "--rate", "250",
             "--seed", "3", "--len-dist", "both", "--schedulers", "both",
             "--prefix", "both", "--spill", "both", "--prefix-mix", "0.6",
             "--templates", "3", "--tenants", "2", "--format", "json"],
    "spec": ["--budget", "3", "--requests", "48", "--rate", "300",
             "--seed", "1", "--spec", "both", "--prefix", "on",
             "--deadline-ms", "400", "--ttft-ms", "60", "--tpot-ms", "8",
             "--format", "json"],
}


def _run(fn, argv) -> tuple[int, str, str]:
    """(exit code, stdout, stderr) of one tool call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = fn(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Each flag set through both packages, with --metrics-jsonl:
    {name: {"jax"|"torch": (rc, stdout, records path)}}."""
    d = tmp_path_factory.mktemp("autosize")
    out = {}
    for name, argv in FLAG_SETS.items():
        out[name] = {}
        for side, fn in (("jax", jax_autosize), ("torch", autosize_main)):
            path = d / f"{name}_{side}.jsonl"
            rc, stdout, _ = _run(fn, argv + ["--metrics-jsonl", str(path)])
            out[name][side] = (rc, stdout, path)
    return out


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_stdout_and_records_are_the_jax_tools(sweeps, name):
    (jrc, jout, jpath), (trc, tout, tpath) = (sweeps[name]["jax"],
                                              sweeps[name]["torch"])
    assert trc == jrc == 0
    assert tout == jout
    assert tpath.read_bytes() == jpath.read_bytes()
    if name != "md":
        res = json.loads(tout)
        assert res["evaluated"] == len(res["frontier"]) > 1


def test_sweep_axes_reach_every_candidate_kind(sweeps):
    """The axis sweep really crossed its axes (spill only with prefix)."""
    res = json.loads(sweeps["axes"]["torch"][1])
    cands = {r["cand"] for r in res["frontier"]}
    assert res["evaluated"] == 2 * 2 * 2 * 3 == len(cands)
    assert any(c.endswith("/prefix/off/spill") for c in cands)
    assert not any("/noprefix/" in c and c.endswith("/spill")
                   for c in cands)
    spec = json.loads(sweeps["spec"]["torch"][1])
    assert {r["spec"] for r in spec["frontier"]} == {"off", "lookup"}


def test_frontier_ranks_one_three_over_two_two(sweeps):
    """The JAX package's claim at this decode-heavy mix, read from the
    port's frontier record."""
    recs = load_records(sweeps["md"]["torch"][2])
    front = next(r for r in recs if r.get("kind") == "frontier")
    order = front["order"]
    assert order.index("1:3/fcfs/uniform/noprefix/off") < \
        order.index("2:2/fcfs/uniform/noprefix/off")
    assert front["evaluated"] == 4 and front["pruned"] == 0


def test_candidate_storms_are_the_fleet_bench_storms(sweeps, tmp_path):
    """The sweep harness changes nothing about the storms it measures:
    the unified candidate's CRCs and tokens/s equal the port's
    fleet-bench run of the same flags."""
    recs = load_records(sweeps["md"]["torch"][2])
    unified = next(r for r in recs if r.get("kind") == "candidate"
                   and r["topology"] == "unified")
    run = tmp_path / "fleet.jsonl"
    rc, _, _ = _run(fleet_bench_main, [
        "--replicas", "4", "--requests", "120", "--rate", "200",
        "--seed", "0", "--log", "summary", "--metrics-jsonl", str(run)])
    assert rc == 0
    serve = next(r for r in load_records(run) if r.get("event") == "serve")
    for key in ("trace_crc", "state_crc", "blame_crc", "tokens_per_s"):
        assert unified[key] == serve[key], key


def test_seed_from_a_port_run_prunes_to_the_same_recommendation(
        sweeps, tmp_path):
    """A port fleet-bench run of a 2:2 split is handoff-bound: seeding
    from its blame record keeps unified and 1:3, half the candidates,
    and picks what the exhaustive sweep picks; the JAX tool reads the
    port's file to the same bytes."""
    run = tmp_path / "split.jsonl"
    rc, _, _ = _run(fleet_bench_main, [
        "--pools", "prefill:2,decode:2", "--requests", "120", "--rate",
        "200", "--seed", "0", "--log", "summary", "--metrics-jsonl",
        str(run)])
    assert rc == 0
    argv = BASE + ["--seed-from", str(run), "--format", "json"]
    rc, out, _ = _run(autosize_main, argv)
    assert rc == 0
    assert _run(jax_autosize, argv) == (0, out, "")
    pruned = json.loads(out)
    full = next(r for r in load_records(sweeps["md"]["torch"][2])
                if r.get("kind") == "frontier")
    assert pruned["seeded_from"] == "handoff_wait"
    assert pruned["evaluated"] == 2 < full["evaluated"]
    assert pruned["pruned"] == 2
    assert pruned["recommendation"]["cand"] == full["recommendation"]
    assert pruned["recommendation_crc"] == full["recommendation_crc"]


def test_two_runs_pass_the_autosize_gate(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    argv = ["autosize", "--budget", "2", "--requests", "40", "--rate",
            "300", "--len-dist", "both", "--seed", "0"]
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    outs = [_run(main, argv + ["--metrics-jsonl", str(p)]) for p in (a, b)]
    assert outs[0] == outs[1] and outs[0][0] == 0
    assert a.read_bytes() == b.read_bytes()
    assert _run(compare_main, [str(a), str(b), "--gate",
                               "ci/autosize_gate.json"])[0] == 0


def test_frontier_drives_fleet_bench_autoscale_to_the_jax_run(sweeps,
                                                               tmp_path):
    """The record `fleet-bench --autoscale-frontier` reads: the port's
    frontier file, fed to the port's autoscaled fleet-bench, gives the
    JAX run's trace_crc from the JAX frontier file."""
    tfront, jfront = sweeps["md"]["torch"][2], sweeps["md"]["jax"][2]
    assert load_frontier(tfront) > 0
    lines = {}
    for side, fn, front in (("torch", fleet_bench_main, tfront),
                            ("jax", jax_fleet_bench, jfront)):
        path = tmp_path / f"{side}.jsonl"
        rc, _, _ = _run(fn, [
            "--replicas", "1", "--requests", "200", "--rate", "300",
            "--slots", "4", "--seed", "5", "--autoscale", "on",
            "--autoscale-frontier", str(front), "--log", "summary",
            "--metrics-jsonl", str(path)])
        assert rc == 0
        lines[side] = next(r for r in load_records(path)
                           if r.get("event") == "serve")
    assert lines["torch"]["trace_crc"] == lines["jax"]["trace_crc"]
    assert lines["torch"]["state_crc"] == lines["jax"]["state_crc"]
    assert lines["torch"]["autoscale"]


def test_missing_frontier_names_the_ports_tool(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"event": "goodput", "kind": "row"}) + "\n")
    with pytest.raises(ValueError, match="mpi_cuda_cnn_tpu_torch autosize"):
        load_frontier(bad)


def test_error_paths_exit_as_the_jax_tool(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps(
        {"schema": 1, "event": "epoch", "t": 0.0, "epoch": 0,
         "seconds": 1.0}) + "\n")
    cases = [["--budget", "1"],
             ["--budget", "2", "--spill", "on"],
             ["--budget", "2", "--requests", "8", "--seed-from", str(empty)],
             ["--budget", "2", "--requests", "8", "--seed-from",
              str(tmp_path / "nope.jsonl")],
             ["--budget", "2", "--slo", str(tmp_path / "nope.json")]]
    for argv in cases:
        trc, tout, terr = _run(autosize_main, argv)
        jrc, jout, jerr = _run(jax_autosize, argv)
        assert trc == jrc == 2, argv
        assert tout == jout == ""
        assert terr.replace("`explain`", "`mctpu explain`") == jerr, argv
