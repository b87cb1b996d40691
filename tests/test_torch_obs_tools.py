"""The port's run-file tools (`obs/report.py`, `obs/regress.py`,
`obs/causal.py`, `obs/timeline.py`, `obs/health.py`, `obs/top.py`,
`obs/replay.py`, `obs/diverge.py`, run as `python -m
mpi_cuda_cnn_tpu_torch <tool>`) against the JAX package's tools on the
CPU: given the same input files, each prints the JAX tool's bytes on
stdout and exits with its code. The inputs are the committed samples
under tests/data (whose goldens the port renders byte for byte too), and
run files the port's own producers write here: a `train` run, an `lm`
run, `serve-bench` runs and a pair of `fleet-bench` transport storms.

The storm pair is `ci/transport_gate.json`'s command at 2,000 requests
instead of 10^5 (tier-1's time), its fault plan's ticks scaled by the
same 1/50 (a partition, duplicated and dropped commits, a zombie crash:
lease refusals and retransmits still occur).

The producer twins at the end are `scripts/make_obs_sample.py`'s
`build_records` and `build_fleet` on the port's engine and fleet, with
the JAX weights: every record and field, "t" included, equals the JAX
producer's (`test_producer_twin_is_the_jax_producers` says where both
leave the committed samples).
"""

import contextlib
import importlib.util
import io
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

from mpi_cuda_cnn_tpu.obs.causal import explain_main as jax_explain
from mpi_cuda_cnn_tpu.obs.diverge import diverge_main as jax_diverge
from mpi_cuda_cnn_tpu.obs.health import health_main as jax_health
from mpi_cuda_cnn_tpu.obs.regress import compare_main as jax_compare
from mpi_cuda_cnn_tpu.obs.replay import replay_main as jax_replay
from mpi_cuda_cnn_tpu.obs.report import report_main as jax_report
from mpi_cuda_cnn_tpu.obs.timeline import trace_main as jax_trace
from mpi_cuda_cnn_tpu.obs.top import top_main as jax_top
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.obs.schema import dump_records, load_records
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
SERVE = "tests/data/sample_serve_run.jsonl"
FLEET = "tests/data/sample_fleet_run.jsonl"
SLO = "tests/data/sample_slo.json"

JAX_TOOLS = {"report": jax_report, "compare": jax_compare,
             "explain": jax_explain, "trace": jax_trace,
             "health": jax_health, "top": jax_top, "replay": jax_replay,
             "diverge": jax_diverge}

# (tool, arguments, exit code, golden) over the committed samples, with
# the JAX package's tests' flags
SAMPLE_CASES = [
    ("report", [SERVE], 0, "golden_serve_report.md"),
    ("trace", [SERVE, "--width", "80"], 0, "golden_serve_trace.md"),
    ("health", [SERVE, "--slo", SLO, "--verify-alerts"], 1,
     "golden_serve_health.md"),
    ("explain", [SERVE, "--worst", "ttft", "-k", "2"], 0,
     "golden_serve_explain.md"),
    ("replay", [SERVE], 0, "golden_serve_replay.md"),
    ("report", [FLEET], 0, "golden_fleet_report.md"),
    ("top", [FLEET, "--once"], 0, "golden_fleet_top.md"),
    ("trace", [FLEET, "--width", "80"], 0, "golden_fleet_trace.md"),
    ("trace", [FLEET, "--request", "3"], 0, "golden_fleet_trace_detail.md"),
    ("report", [SERVE, FLEET, "--merge", "--format", "json"], 0, None),
    ("top", [SERVE, "--once"], 0, None),
    ("trace", [SERVE, "--tenant", "t1", "--mode", "continuous"], 0, None),
    ("explain", [FLEET], None, None),
    ("explain", [SERVE, "--request", "3", "--format", "json"], 0, None),
    ("replay", [FLEET], 0, None),
    ("replay", [SERVE, "--at-tick", "10", "--format", "json"], 0, None),
    ("health", [FLEET], None, None),
    ("health", [SERVE, "--format", "json"], None, None),
    ("diverge", [SERVE, SERVE], 0, None),
    ("compare", [SERVE, SERVE], 0, None),
    ("compare", [FLEET, FLEET, "--gate", "ci/transport_gate.json"], None,
     None),
]

STORM = ["--replicas", "4", "--requests", "2000", "--rate", "2000",
         "--slots", "8", "--seed", "0", "--transport", "--log", "summary",
         "--fault-plan",
         "partition@fleet.transport:80?replica=1&ticks=12;"
         "msg_dup@fleet.transport:240?count=3;"
         "msg_drop@fleet.transport:320?count=3&kind=commit;"
         "replica_crash@fleet.tick:400?replica=2&zombie_ticks=4"]
SMALL_SERVE = ["--device", "cpu", "--dim", "32", "--depth", "1", "--heads",
               "4", "--kv-heads", "2", "--vocab", "64", "--max-seq", "96",
               "--prompt-min", "8", "--prompt-max", "40", "--out-min", "2",
               "--out-max", "12", "--page-size", "8", "--prefill-chunk",
               "8", "--slots", "3", "--seed", "2", "--requests", "8",
               "--mode", "continuous", "--rate", "0"]

# (tool, arguments, exit code) over the port's run files ({name} is the
# path of run `name` of the `port_runs` fixture)
RUN_CASES = [
    ("report", ["{train}"], 0),
    ("report", ["{train}", "--format", "json"], 0),
    ("health", ["{train}"], None),
    ("top", ["{train}", "--once"], 0),
    ("trace", ["{train}"], None),
    ("report", ["{lm}"], 0),
    ("health", ["{lm}", "--format", "json"], None),
    ("top", ["{lm}", "--once"], 0),
    ("compare", ["ci/serve_baseline.jsonl", "{serve}", "--gate",
                 "ci/serve_gate.json"], 0),
    ("report", ["{serve}"], 0),
    ("explain", ["{serve}"], 0),
    ("trace", ["{serve}"], 0),
    ("replay", ["{serve}"], 0),
    ("health", ["{serve}", "--verify-alerts"], None),
    ("top", ["{serve}", "--once"], 0),
    ("diverge", ["{serve_a}", "{serve_b}"], 1),
    ("diverge", ["{serve_a}", "{serve_a}"], 0),
    ("compare", ["{fleet_a}", "{fleet_b}", "--gate",
                 "ci/transport_gate.json"], 0),
    ("report", ["{fleet_a}"], 0),
    ("health", ["{fleet_a}"], None),
    ("explain", ["{fleet_a}"], None),
]


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


def _same(tool: str, argv: list[str], want_rc: int | None) -> str:
    """The port's tool, through its CLI, against the JAX tool on `argv`:
    equal stdout and exit code (`want_rc` when given). Returns stdout."""
    rc, out = _run(main, [tool, *argv])
    jrc, jout = _run(JAX_TOOLS[tool], argv)
    assert out == jout, (tool, argv)
    assert rc == jrc, (tool, argv, rc, jrc)
    if want_rc is not None:
        assert rc == want_rc, (tool, argv, rc)
    return out


@pytest.mark.parametrize("tool,argv,want_rc,golden", SAMPLE_CASES)
def test_tool_on_the_samples_is_the_references(monkeypatch, tool, argv,
                                               want_rc, golden):
    monkeypatch.chdir(REPO)
    out = _same(tool, argv, want_rc)
    assert out
    if golden is not None:
        assert out == (DATA / golden).read_text()


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's producers' run files, written on the CPU."""
    d = tmp_path_factory.mktemp("port_runs")
    runs = {name: str(d / f"{name}.jsonl") for name in
            ("train", "lm", "serve", "serve_a", "serve_b", "fleet_a",
             "fleet_b")}
    for argv in (
        ["train", "--device", "cpu", "--dataset", "synthetic", "--epochs",
         "1", "--log-every", "2", "--metrics-jsonl", runs["train"]],
        ["lm", "--device", "cpu", "--corpus", "synthetic", "--dim", "32",
         "--depth", "1", "--heads", "2", "--seq-len", "64", "--batch-size",
         "2", "--steps", "4", "--log-every", "1", "--metrics-jsonl",
         runs["lm"]],
        ["serve-bench", "--requests", "12", "--seed", "0", "--device", "cpu",
         "--metrics-jsonl", runs["serve"]],
        ["serve-bench", *SMALL_SERVE, "--metrics-jsonl", runs["serve_a"]],
        ["serve-bench", *SMALL_SERVE, "--fault-plan",
         "squeeze@serve.tick:6?pages=6&ticks=3", "--metrics-jsonl",
         runs["serve_b"]],
        ["fleet-bench", *STORM, "--metrics-jsonl", runs["fleet_a"]],
        ["fleet-bench", *STORM, "--metrics-jsonl", runs["fleet_b"]],
    ):
        assert _run(main, argv)[0] == 0, argv
    return runs


@pytest.mark.parametrize("tool,argv,want_rc", RUN_CASES)
def test_tool_on_port_runs_is_the_references(monkeypatch, port_runs, tool,
                                             argv, want_rc):
    monkeypatch.chdir(REPO)
    _same(tool, [a.format(**port_runs) for a in argv], want_rc)


def test_port_runs_carry_program_and_blame_records(port_runs):
    progs = {name: [r for r in load_records(port_runs[name], strict=True)
                    if r["event"] == "program"] for name in ("train", "lm")}
    assert [p["label"] for p in progs["train"]] == ["scan_epoch"]
    assert [p["label"] for p in progs["lm"]] == ["lm_train_step"]
    for p in progs["train"] + progs["lm"]:
        assert p["backend"] == "cpu" and p["flops"] > 0 and p["bytes"] > 0
        assert p["collectives"] == {} and p["aliased_outputs"] == 0
    blames = [r for r in load_records(port_runs["serve"])
              if r["event"] == "blame"]
    assert [b["mode"] for b in blames] == ["static", "continuous"]
    assert all(b["conserved"] for b in blames)


# ---------------------------------------------------------------------------
# The producer twins of scripts/make_obs_sample.py
# ---------------------------------------------------------------------------


def _sample_slo() -> dict:
    return json.loads((DATA / "sample_slo.json").read_text())


def build_records() -> list[dict]:
    """`make_obs_sample.build_records` on the port's engine, the JAX
    weights converted."""
    from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
    from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
    from mpi_cuda_cnn_tpu_torch.faults import FakeClock, FaultInjector
    from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
    from mpi_cuda_cnn_tpu_torch.obs.alerts import AlertEngine
    from mpi_cuda_cnn_tpu_torch.obs.causal import BlameAccumulator
    from mpi_cuda_cnn_tpu_torch.obs.metrics import MetricsRegistry
    from mpi_cuda_cnn_tpu_torch.obs.schema import make_record, validate_record
    from mpi_cuda_cnn_tpu_torch.obs.slo import SLOSpec
    from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload
    from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine

    dims = dict(vocab=13, dim=32, heads=4, depth=2, max_seq=48)
    jparams = JaxLM(**dims).init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    geom = dict(slots=3, num_pages=10, page_size=4, spec="lookup",
                spec_k=4)
    engine = PagedEngine(TransformerLM(**dims), params, prefill_chunk=8,
                         max_len=40, device="cpu", **geom)
    records: list[dict] = []
    alerts = AlertEngine(slo=SLOSpec.from_dict(_sample_slo()))

    def emit(rec: dict, clock) -> None:
        records.append(validate_record(rec))
        for a in alerts.ingest(rec):
            records.append(validate_record(
                make_record("alert", clock.now, **a)))

    for mode in ("static", "continuous"):
        clock = FakeClock()
        registry = MetricsRegistry(clock=clock)
        blame = BlameAccumulator()

        def sink(rec, clock=clock, registry=registry, blame=blame):
            blame.ingest_tick(rec)
            emit(make_record("tick", clock.now, **rec), clock)
            if (rec["tick"] + 1) % 32 == 0:
                emit(registry.snapshot(mode=rec["mode"]), clock)

        reqs = make_workload(n=8, vocab=13, prompt_min=4, prompt_max=8,
                             out_min=6, out_max=18, rate=40.0, seed=5,
                             deadline_s=0.3, tenants=2, prefix_mix=0.6)
        faults = FaultInjector(
            "slow@serve.tick:10?s=0.15;slow@serve.tick:20?s=0.15;"
            "slow@serve.tick:30?s=0.15", clock=clock)
        res = engine.run(reqs, mode=mode, time_fn=clock,
                         sleep_fn=clock.advance, faults=faults,
                         registry=registry, tick_sink=sink,
                         prefix=(mode == "continuous"),
                         spec=(mode == "continuous"),
                         host_pages=(6 if mode == "continuous" else 0))
        s = res.summary()
        emit(make_record("blame", clock.now, **blame.summary_fields(mode)),
             clock)
        registry.set("serve.tokens_per_s", s["tokens_per_s"])
        emit(registry.snapshot(mode=mode, final=True), clock)
        for rec in res.request_records():
            emit(make_record("request", clock.now, **rec), clock)
        for ev in res.events:
            emit(make_record("fault", clock.now, **{"mode": mode, **ev}),
                 clock)
        emit(make_record("serve", clock.now, bench="serve",
                         slots=geom["slots"], pages=geom["num_pages"],
                         page_size=geom["page_size"], spec=geom["spec"],
                         spec_k=geom["spec_k"],
                         prefix_cache=(mode == "continuous"),
                         host_pages=(6 if mode == "continuous" else 0),
                         **s), clock)
    return records


def build_fleet() -> list[dict]:
    """`make_obs_sample.build_fleet` on the port's fleet."""
    from mpi_cuda_cnn_tpu_torch.faults import FakeClock, FaultInjector
    from mpi_cuda_cnn_tpu_torch.obs.causal import BlameAccumulator
    from mpi_cuda_cnn_tpu_torch.obs.metrics import MetricsRegistry
    from mpi_cuda_cnn_tpu_torch.obs.schema import make_record, validate_record
    from mpi_cuda_cnn_tpu_torch.serve.autoscale import (
        Autoscaler,
        parse_autoscale,
    )
    from mpi_cuda_cnn_tpu_torch.serve.fleet import (
        Fleet,
        SimCompute,
        make_fleet_workload,
    )

    records: list[dict] = []
    clock = FakeClock()

    def emit(ev: str, **rec) -> None:
        records.append(validate_record(make_record(ev, clock.now, **rec)))

    registry = MetricsRegistry(clock=clock)
    blame = BlameAccumulator()

    def fleet_sink(rec):
        blame.ingest_fleet(rec)
        emit("fleet", **rec)

    def tick_sink(rec):
        blame.ingest_tick(rec)
        emit("tick", **rec)

    reqs = make_fleet_workload(
        n=24, vocab=13, prompt_min=8, prompt_max=16, out_min=4,
        out_max=8, rate=300.0, seed=7, sessions=6, prefix_mix=0.7,
        templates=4, turns_dist="uniform:2-3", turn_gap_s=0.01,
        diurnal_amp=0.8, diurnal_period_s=0.15)
    faults = FaultInjector(
        "msg_delay@fleet.transport:6?kind=dispatch&count=2&ticks=3;"
        "partition@fleet.transport:18?replica=0&ticks=6;"
        "msg_dup@fleet.transport:40?count=2", clock=clock)
    fleet = Fleet(
        lambda name: SimCompute(vocab=13, chunk=8, salt=7),
        replicas=1, slots=2, num_pages=9, page_size=4, max_len=24,
        policy="cache_aware", prefix=True, host_pages=6, clock=clock,
        registry=registry, fleet_sink=fleet_sink,
        replica_tick_sink=tick_sink, transport=True, faults=faults,
        autoscale=Autoscaler(parse_autoscale(
            "min=1,max=3,high=2,low=0.2,up=2,down=40,cooldown=0.02")))
    res = fleet.run(reqs)
    s = res.summary()
    emit("blame", **blame.summary_fields("fleet"))
    registry.set("serve.tokens_per_s", s["tokens_per_s"])
    records.append(validate_record(
        registry.snapshot(mode="fleet", final=True)))
    for rec in res.replica_log:
        emit("replica", **rec)
    for rec in res.transport_log:
        emit("transport", **rec)
    for rec in res.request_records():
        emit("request", **rec)
    emit("serve", bench="fleet", policy="cache_aware", autoscale=True,
         redispatch="resume", spec="off", replicas_initial=1,
         rate=300.0, slots=2, page_size=4, pages=9, compute="sim",
         prefix_cache=True, host_pages=6, transport=True, **s)
    return records


def _field_diffs(got: list[dict], want: list[dict]) -> list[str]:
    """Where two record lists differ: "record i (event): field" names."""
    diffs = []
    for i, (g, w) in enumerate(zip(got, want)):
        for k in sorted(set(g) | set(w)):
            if g.get(k, "<absent>") != w.get(k, "<absent>"):
                diffs.append(f"record {i} ({w.get('event')}): {k}")
    if len(got) != len(want):
        diffs.append(f"{len(got)} records, want {len(want)}")
    return diffs


def _jax_producers():
    """scripts/make_obs_sample.py as a module (its build functions)."""
    spec = importlib.util.spec_from_file_location(
        "make_obs_sample", REPO / "scripts" / "make_obs_sample.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (port twin, the script's function, sample file, the first field where
# today's producers leave the committed sample (None: nowhere), renders
# (tool, arguments, exit code, golden))
TWINS = {
    "serve": (build_records, "build_records", "sample_serve_run.jsonl",
              "record 65 (tick): spec", [
                  ("report", [SERVE], 0, None),
                  ("trace", [SERVE, "--width", "80"], 0, None),
                  ("explain", [SERVE, "--worst", "ttft", "-k", "2"], 0,
                   None),
                  ("replay", [SERVE], 0, None),
                  ("health", [SERVE, "--slo", SLO, "--verify-alerts"], 1,
                   None)]),
    "fleet": (build_fleet, "build_fleet", "sample_fleet_run.jsonl", None, [
        ("report", [FLEET], 0, "golden_fleet_report.md"),
        ("trace", [FLEET, "--width", "80"], 0, "golden_fleet_trace.md"),
        ("trace", [FLEET, "--request", "3"], 0,
         "golden_fleet_trace_detail.md"),
        ("top", [FLEET, "--once"], 0, "golden_fleet_top.md"),
        ("explain", [FLEET], None, None),
        ("replay", [FLEET], 0, None)]),
}


@pytest.mark.parametrize("twin", list(TWINS))
def test_producer_twin_is_the_jax_producers(twin, tmp_path, monkeypatch):
    """The twin writes every record and field ("t" included) of the JAX
    producer run here. Against the committed sample: the fleet twin
    writes it whole, so the port's tools render its goldens from the
    twin's file. The committed serve sample is no longer what the JAX
    producer writes on this CPU: from record 65 on (a speculative round
    that accepts 3 proposals where the sample has 0) both producers
    differ from it alike; the port's tools then render the twin's file
    as the JAX tools do."""
    build, jax_build, name, first_stale, renders = TWINS[twin]
    records = build()
    with contextlib.redirect_stdout(io.StringIO()):
        want = getattr(_jax_producers(), jax_build)()
    assert _field_diffs(records, want) == []
    stale = _field_diffs(records, load_records(DATA / name, strict=True))
    assert (stale[0] if stale else None) == first_stale
    # the tools read the twin's file under the committed sample's path,
    # so that the goldens' titles hold
    (tmp_path / "tests" / "data").mkdir(parents=True)
    dump_records(records, tmp_path / "tests" / "data" / name)
    shutil.copy(DATA / "sample_slo.json", tmp_path / SLO)
    monkeypatch.chdir(tmp_path)
    for tool, argv, want_rc, golden in renders:
        out = _same(tool, argv, want_rc)
        if golden is not None:
            assert out == (DATA / golden).read_text(), (tool, argv)
