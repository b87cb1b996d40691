"""The port's `chaos` (`chaos/`, run as `python -m mpi_cuda_cnn_tpu_torch
chaos`) against the JAX package's on the CPU.

The search is a pure function of its master seed: each episode's axes
and plan come from a per-ordinal string-seeded stream over
`faults.SITES`, every storm is a SimCompute fleet on a FakeClock, and
the oracle's verdict is folded into each episode's CRC. So for the same
flags the port prints the JAX tool's lines (the repro and diverge
commands name the port's package) and writes the same records: at
`--episodes 12 --seed 7` every episode's axes, plan spelling, verdict
and CRC, and `episodes_crc`. The planted fence-revoke bug and the
transport dedup canary are found and shrunk to the JAX tool's one-line
repro, with the same probe count and the same twin trails, which the
port's `diverge` reads as the JAX one does. Two runs pass the port's
`compare` under ci/chaos_gate.json.
"""

import contextlib
import dataclasses
import io
import json
import random
from pathlib import Path

import pytest

from mpi_cuda_cnn_tpu.chaos.cli import chaos_main as jax_chaos
from mpi_cuda_cnn_tpu.chaos.episode import config_for as jax_config_for
from mpi_cuda_cnn_tpu.chaos.episode import run_episode as jax_run_episode
from mpi_cuda_cnn_tpu.chaos.sampler import sample_axes as jax_sample_axes
from mpi_cuda_cnn_tpu.chaos.sampler import sample_plan as jax_sample_plan
from mpi_cuda_cnn_tpu.faults import parse_plan as jax_parse_plan
from mpi_cuda_cnn_tpu.obs.diverge import diverge_main as jax_diverge
from mpi_cuda_cnn_tpu_torch.chaos import (
    RAISING_KINDS,
    SURFACE,
    EpisodeAxes,
    EpisodeConfig,
    config_for,
    run_episode,
    sample_axes,
    sample_plan,
    shrink,
)
from mpi_cuda_cnn_tpu_torch.chaos.cli import chaos_main
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.faults import (
    format_plan,
    parse_plan,
    validate_plan_sites,
)
from mpi_cuda_cnn_tpu_torch.obs.diverge import diverge_main
from mpi_cuda_cnn_tpu_torch.obs.regress import compare_main
from mpi_cuda_cnn_tpu_torch.serve import fleet as fleet_mod
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

REPO = Path(__file__).resolve().parents[1]


def _run(fn, argv) -> tuple[int, str]:
    """(exit code, stdout) of one tool call; stderr is dropped."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            rc = fn(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def _as_jax(text: str) -> str:
    """The port's stdout with its package's name where the JAX tool
    names its own (the printed repro and diverge commands)."""
    return text.replace("python -m mpi_cuda_cnn_tpu_torch ",
                        "python -m mpi_cuda_cnn_tpu ")


def _records(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()
            if not line.startswith("#")]


# (name, flags, exit code): the search at the JAX package's scale, the
# planted fence-revoke bug (shrunk, trails written), the transport
# dedup canary, and one replayed plan
CASES = {
    "search": (["--episodes", "12", "--seed", "7"], 0),
    "skip_revoke": (["--episodes", "2", "--seed", "7", "--plant",
                     "skip-revoke", "--out-dir", "{dir}"], 1),
    "skip_dedup": (["--episodes", "1", "--seed", "7", "--plant",
                    "skip-dedup"], 1),
    "plan": (["--seed", "5", "--plan",
              "replica_crash@fleet.tick:12?replica=0;"
              "kv_corrupt@fleet.handoff:1?page=2",
              "--pools", "prefill:1,decode:2", "--prefix"], 0),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case through both packages, with --metrics-jsonl (and
    --out-dir where the case writes trails): {name: {"jax"|"torch":
    (rc, stdout, records path, trail dir)}}."""
    root = tmp_path_factory.mktemp("chaos")
    out = {}
    for name, (argv, _) in CASES.items():
        out[name] = {}
        for side, fn in (("jax", jax_chaos), ("torch", chaos_main)):
            d = root / f"{name}_{side}"
            d.mkdir()
            path = d / "chaos.jsonl"
            args = [a.replace("{dir}", str(d / "trails")) for a in argv]
            rc, stdout = _run(fn, args + ["--metrics-jsonl", str(path)])
            out[name][side] = (rc, stdout, path, d / "trails")
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_stdout_and_records_are_the_jax_tools(runs, name):
    (jrc, jout, jpath, jdir), (trc, tout, tpath, tdir) = (
        runs[name]["jax"], runs[name]["torch"])
    assert trc == jrc == CASES[name][1]
    assert _as_jax(tout).replace(str(tdir), str(jdir)) == jout
    assert tpath.read_bytes() == jpath.read_bytes()


def test_search_episodes_and_chain(runs):
    """Every episode's axes, plan, verdict and CRC, and the chain over
    them, in the records; the 12 episodes cross several axes."""
    rows = _records(runs["search"]["torch"][2])
    episodes, summary = rows[:-1], rows[-1]
    assert [r["episode"] for r in episodes] == list(range(12))
    assert summary["kind"] == "summary" and summary["violations"] == 0
    assert summary["episodes_crc"] == _records(
        runs["search"]["jax"][2])[-1]["episodes_crc"]
    labels = " ".join(r["axes"] for r in episodes)
    for axis in ("pools=", "unified", "prefix", "transport"):
        assert axis in labels
    assert all(r["replay_ticks"] > 0 for r in episodes)


@pytest.mark.parametrize("name,plant,check,max_faults",
                         [("skip_revoke", "skip-revoke", "replay", 2),
                          ("skip_dedup", "skip-dedup", "outputs", 1)])
def test_planted_bug_shrinks_to_the_jax_repro(runs, name, plant, check,
                                             max_faults):
    """The minimal plan, its probe count and the failing episode are the
    JAX tool's; the plan fails with the plant armed and passes without
    it, through both packages' episode harnesses."""
    trows, jrows = (_records(runs[name][s][2]) for s in ("torch", "jax"))
    summary = trows[-1]
    assert summary == jrows[-1]
    min_plan = summary["min_plan"]
    assert 1 <= len(parse_plan(min_plan)) <= max_faults
    assert summary["shrink_probes"] >= 1
    repro = next(line for line in runs[name]["torch"][1].splitlines()
                 if line.startswith("repro: "))
    assert repro.startswith("repro: python -m mpi_cuda_cnn_tpu_torch chaos ")
    assert f"--plant {plant} --plan '{min_plan}'" in repro
    ep = summary["failed_episode"]
    axes = sample_axes(random.Random(f"mctpu-chaos:7:{ep}"))
    cfg = config_for(7 * 100003 + ep, min_plan, axes)
    jcfg = jax_config_for(7 * 100003 + ep, min_plan,
                          jax_sample_axes(random.Random(
                              f"mctpu-chaos:7:{ep}")))
    assert run_episode(cfg).ok and jax_run_episode(jcfg).ok
    planted = run_episode(dataclasses.replace(cfg, plant=plant))
    jplanted = jax_run_episode(dataclasses.replace(jcfg, plant=plant))
    assert check in {v["check"] for v in planted.violations}
    assert planted.violations == jplanted.violations
    assert planted.crc == jplanted.crc
    assert fleet_mod.CHAOS_PLANT is None    # flipped around one run only


def test_diverge_reads_the_out_dir_trails(runs):
    """The minimal episode's twin trails, byte for byte the JAX tool's,
    read by the port's diverge as by the JAX one."""
    tdir, jdir = runs["skip_revoke"]["torch"][3], \
        runs["skip_revoke"]["jax"][3]
    names = ("chaos_min_a.jsonl", "chaos_min_b.jsonl")
    for n in names:
        assert (tdir / n).read_bytes() == (jdir / n).read_bytes()
    argv = [str(tdir / n) for n in names]
    rc, out = _run(main, ["diverge", *argv])
    assert (rc, out) == _run(jax_diverge, argv)
    assert out
    # A trail read against a truncated twin: the first disagreement.
    short = tdir / "short.jsonl"
    lines = (tdir / names[0]).read_text().splitlines()
    short.write_text("\n".join(lines[: len(lines) // 2]) + "\n")
    argv = [str(tdir / names[0]), str(short)]
    assert _run(diverge_main, argv) == _run(jax_diverge, argv)


def test_two_runs_pass_the_chaos_gate(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    argv = ["chaos", "--episodes", "4", "--seed", "11"]
    outs = [_run(main, argv + ["--metrics-jsonl", str(p)]) for p in (a, b)]
    assert outs[0] == outs[1] and outs[0][0] == 0
    assert a.read_bytes() == b.read_bytes()
    assert _run(compare_main, [str(a), str(b), "--gate",
                               "ci/chaos_gate.json"])[0] == 0


def test_sampler_draws_are_the_jax_samplers():
    """The same stream gives the same axes and plan spelling, every plan
    re-parses to itself and validates against the port's registry, and
    no draw is a raising kind."""
    for seed in range(40):
        key = f"round-trip:{seed}"
        rng, jrng = random.Random(key), random.Random(key)
        axes, jaxes = sample_axes(rng), jax_sample_axes(jrng)
        assert dataclasses.asdict(axes) == dataclasses.asdict(jaxes)
        spec = sample_plan(rng, axes, replicas=3)
        assert spec == jax_sample_plan(jrng, jaxes, replicas=3)
        plan = parse_plan(spec)
        assert format_plan(plan) == spec
        assert [dataclasses.asdict(f) for f in plan] == \
            [dataclasses.asdict(f) for f in jax_parse_plan(spec)]
        validate_plan_sites(plan, SURFACE)
        assert not any(f.kind in RAISING_KINDS for f in plan)
        if not axes.pools:
            assert all(f.site != "fleet.handoff" for f in plan)


def test_clean_episode_matches_the_jax_episode():
    """The reference's clean multi-fault episode passes the port's full
    oracle with the JAX episode's row (every CRC included)."""
    plan = ("replica_crash@fleet.tick:9?replica=1;"
            "replica_join@fleet.tick:30;kv_corrupt@fleet.resume:0")
    axes = dict(pools=None, prefix=True, spill=True, spec="lookup",
                autoscale=True)
    res = run_episode(config_for(11, plan, EpisodeAxes(**axes)))
    from mpi_cuda_cnn_tpu.chaos.sampler import EpisodeAxes as JaxAxes
    jres = jax_run_episode(jax_config_for(11, plan, JaxAxes(**axes)))
    assert res.ok, res.violations
    assert res.row == jres.row
    assert res.records_a == res.records_b


def test_shrink_refuses_a_passing_episode():
    with pytest.raises(ValueError, match="passing episode"):
        shrink(EpisodeConfig(seed=3, plan="replica_join@fleet.tick:20"))


def test_bad_config_exits_2_as_the_jax_tool():
    for argv in (["--spill"], ["--plan", "nonsense"],
                 ["--plan", "handoff_drop@fleet.nowhere:3"]):
        assert _run(chaos_main, argv)[0] == _run(jax_chaos, argv)[0] == 2
