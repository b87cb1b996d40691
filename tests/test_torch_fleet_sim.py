"""The port's serving fleet on SimCompute against the JAX package's, on the
CPU: seeded storms of at most 300 requests through `Fleet.run` in both
packages, under every failure path the fleet has (crash with resume and
discard, a zombie, join / leave / the circuit breaker, the prefix cache
with its host tier under the session and cache_aware policies, lookup
speculation with the SLO scheduler, a disaggregated fleet under
handoff_drop / kv_corrupt / pool_crash, the lossy transport with a
partition), and `fleet-bench --compute sim` line for line and exit code
for exit code. Every storm gives the JAX fleet's trace_crc, status
counts, outputs, summary, per-tick fleet and replica records, replica /
handoff / transport logs and fault events, compared exactly.
"""

import contextlib
import io
import json
import shlex
import time
from pathlib import Path

import pytest

from mpi_cuda_cnn_tpu.faults import FaultInjector as JaxFaultInjector
from mpi_cuda_cnn_tpu.serve import autoscale as jax_autoscale
from mpi_cuda_cnn_tpu.serve import fleet as jax_fleet
from mpi_cuda_cnn_tpu.serve.bench import fleet_bench_main as jax_fleet_main
from mpi_cuda_cnn_tpu.serve.scheduler import SLOPolicy as JaxSLOPolicy
from mpi_cuda_cnn_tpu_torch.faults import FaultInjector
from mpi_cuda_cnn_tpu_torch.serve import autoscale, fleet
from mpi_cuda_cnn_tpu_torch.serve.bench import fleet_bench_main
from mpi_cuda_cnn_tpu_torch.serve.scheduler import SLOPolicy
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

REPO = Path(__file__).resolve().parents[1]
VOCAB = 97
SIDES = {
    "torch": (fleet, FaultInjector, SLOPolicy, autoscale),
    "jax": (jax_fleet, JaxFaultInjector, JaxSLOPolicy, jax_autoscale),
}

# name: (workload kwargs, Fleet kwargs, fault plan)
STORMS = {
    "crash_resume": (
        dict(n=300, rate=800.0),
        dict(replicas=4),
        "replica_crash@fleet.tick:40?replica=1;"
        "replica_crash@fleet.tick:120?replica=2;replica_join@fleet.tick:160;"
        "kv_corrupt@fleet.resume:0"),
    "crash_discard": (
        dict(n=200, rate=800.0),
        dict(replicas=3, redispatch="discard"),
        "replica_crash@fleet.tick:30?replica=0"),
    "zombie": (
        dict(n=200, rate=800.0),
        dict(replicas=3),
        "replica_crash@fleet.tick:40?replica=1&zombie_ticks=6"),
    "join_leave_breaker": (
        dict(n=250, rate=600.0),
        dict(replicas=2, max_flaps=2, backoff_base=0.002),
        "replica_join@fleet.tick:20?replicas=2;"
        "replica_leave@fleet.tick:60?replica=0;"
        "replica_crash@fleet.tick:30?replica=1;"
        "replica_crash@fleet.tick:90?replica=1;"
        "replica_crash@fleet.tick:150?replica=1"),
    "session_prefix_spill": (
        dict(n=250, rate=800.0, sessions=8, prefix_mix=0.8, templates=6),
        dict(replicas=3, policy="session", prefix=True, num_pages=24,
             host_pages=12),
        "kv_corrupt@tier.spill:120;replica_crash@fleet.tick:80?replica=2"),
    "cache_aware_turns": (
        dict(n=150, rate=600.0, sessions=6, prefix_mix=0.6, templates=4,
             turns_dist="uniform:1-3", turn_gap_s=0.004),
        dict(replicas=3, policy="cache_aware", prefix=True, num_pages=26,
             host_pages=10),
        None),
    "lookup_slo": (
        dict(n=200, rate=800.0, tenants=3, prefix_mix=0.5),
        dict(replicas=2, spec="lookup", spec_k=4, prefix=True,
             sched_policy=dict(priorities={"t1": 2},
                               slot_quota={"t0": 2},
                               page_quota={"t2": 16})),
        "replica_crash@fleet.tick:70?replica=0"),
    "disagg_faults": (
        dict(n=200, rate=800.0),
        dict(pools={"prefill": 2, "decode": 2}, handoff_ticks=2),
        "handoff_drop@fleet.handoff:3;kv_corrupt@fleet.handoff:5?page=0;"
        "replica_crash@fleet.tick:40?replica=0&zombie_ticks=4;"
        "pool_crash@fleet.tick:120?pool=decode;"
        "replica_join@fleet.tick:200?pool=decode"),
    "disagg_prefix": (
        dict(n=150, rate=800.0, prefix_mix=0.7),
        dict(pools={"prefill": 1, "decode": 2}, prefix=True),
        "pool_crash@fleet.tick:60?pool=prefill"),
    "transport_partition": (
        dict(n=200, rate=800.0),
        dict(replicas=3, transport=True),
        "partition@fleet.transport:30?replica=1&ticks=20;"
        "msg_dup@fleet.transport:5?kind=commit&count=4;"
        "msg_delay@fleet.transport:8?ticks=3&count=3;"
        "msg_drop@fleet.transport:12?count=2"),
    "autoscale_diurnal": (
        dict(n=300, rate=3000.0, diurnal_amp=0.8, diurnal_period_s=0.05),
        dict(replicas=1, autoscale="min=1,max=4,up=2,down=15,"
                                   "cooldown=0.002"),
        None),
}


def run_storm(side: str, wl: dict, kw: dict, plan: str | None):
    """One storm (workload kwargs, Fleet kwargs, fault plan) through
    `side`'s fleet; returns its result and the per-tick fleet and replica
    records."""
    mod, injector, policy_cls, scaler = SIDES[side]
    kw = dict(kw)
    wl = {"vocab": VOCAB, "prompt_min": 8, "prompt_max": 48, "out_min": 4,
          "out_max": 32, "seed": 1, **wl}
    for k, v in dict(slots=4, num_pages=33, page_size=8, max_len=96,
                     check_every=8).items():
        kw.setdefault(k, v)
    if "sched_policy" in kw:
        kw["sched_policy"] = policy_cls(**kw["sched_policy"])
    if "autoscale" in kw:
        kw["autoscale"] = scaler.Autoscaler(
            scaler.parse_autoscale(kw["autoscale"]))
    fleet_recs, replica_recs = [], []
    f = mod.Fleet(lambda n: mod.SimCompute(vocab=VOCAB, chunk=16, salt=1),
                  faults=injector(plan) if plan else None,
                  fleet_sink=fleet_recs.append,
                  replica_tick_sink=replica_recs.append, **kw)
    res = f.run(mod.make_fleet_workload(**wl))
    return res, fleet_recs, replica_recs


@pytest.mark.parametrize("name", list(STORMS))
def test_sim_storm_matches_jax(name):
    ours, fr, rr = run_storm("torch", *STORMS[name])
    theirs, jfr, jrr = run_storm("jax", *STORMS[name])
    assert ours.trace_crc == theirs.trace_crc
    assert ours.status_counts() == theirs.status_counts()
    assert ours.outputs() == theirs.outputs()
    assert ours.summary() == theirs.summary()
    assert ours.state_crc == theirs.state_crc
    assert fr == jfr and rr == jrr
    assert ours.replica_log == theirs.replica_log
    assert ours.handoff_log == theirs.handoff_log
    assert ours.transport_log == theirs.transport_log
    assert ours.events == theirs.events
    assert ours.request_records() == theirs.request_records()
    s = ours.summary()
    assert sum(s["statuses"].values()) == len(ours.requests)
    # Every storm exercises the path it is named for.
    want = {
        "crash_resume": (s["crashes"] == 2 and s["redispatches"] > 0
                         and s["kv_refusals"] == 1),
        "crash_discard": s["redispatches"] > 0,
        "zombie": s["fenced_discards"] > 0,
        "join_leave_breaker": (s["joins"] == 2 and s["leaves"] == 1
                               and s["circuit_opens"] == 1),
        "session_prefix_spill": (s["prefix_hits"] > 0 and s["tier_spills"] > 0
                                 and s["tier_refusals"] == 1),
        "cache_aware_turns": s["route_hits"] > 0 and s["tier_readmits"] >= 0,
        "lookup_slo": s["spec_rounds"] > 0 and len(s["tenants"]) == 3,
        "disagg_faults": (s["handoffs"] > 0 and s["handoffs_aborted"] > 0
                          and s["kv_refusals"] >= 1
                          and s["degraded_unified"] > 0),
        "disagg_prefix": s["handoffs"] > 0 and s["prefix_hits"] > 0,
        "transport_partition": (s["msgs_dropped"] > 0 and s["msgs_duped"] > 0
                                and s["lease_refusals"] > 0
                                and s["partitions"] == 1),
        "autoscale_diurnal": s["scale_ups"] > 0,
    }[name]
    assert want, s


def test_zombie_generates_no_token_twice():
    """The zombie storm's committed outputs equal the crash-free storm's
    token for token (SimCompute's tokens are a pure function of request
    and position): every commit the zombie made after failover was
    refused, none landed twice."""
    wl, kw, plan = STORMS["zombie"]
    crashed, _, _ = run_storm("torch", wl, kw, plan)
    clean, _, _ = run_storm("torch", wl, kw, None)
    assert crashed.fenced_discards > 0
    assert crashed.outputs() == clean.outputs()
    assert crashed.status_counts() == clean.status_counts()


def test_zero_fault_transport_equals_direct_calls():
    """--transport with no fault armed is the direct-call fleet bit for
    bit: the same trace_crc and outputs."""
    wl, kw, _ = STORMS["crash_resume"]
    bus, _, _ = run_storm("torch", wl, {**kw, "transport": True}, None)
    direct, _, _ = run_storm("torch", wl, kw, None)
    assert bus.trace_crc == direct.trace_crc
    assert bus.outputs() == direct.outputs()
    assert bus.msgs_sent > 0 and bus.msgs_dropped == 0


# --------------------------------------------------------- fleet-bench


def _main(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = fn(argv)
        except SystemExit as e:
            rc = e.code
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{")]
    return rc, lines, err.getvalue()


def _strip(line):
    return {k: v for k, v in line.items()
            if not k.startswith("wall_")}


BASE = ("--requests 60 --rate 600 --prompt-max 40 --out-max 24 --seed 2 "
        "--slots 4 --page-size 8")
BENCH_CASES = {
    "default": "",
    "crash": "--replicas 3 --redispatch discard --fault-plan "
             "replica_crash@fleet.tick:15?replica=1&zombie_ticks=3",
    "pools": "--pools prefill:1,decode:2 --handoff-ticks 2 --fault-plan "
             "handoff_drop@fleet.handoff:2",
    "cache_aware_spill": "--replicas 3 --policy cache_aware --prefix-cache "
                         "--spill --pages 20 --host-pages 8 --prefix-mix 0.8 "
                         "--templates 3 --sessions 4 --turns-dist "
                         "uniform:1-2 --turn-gap-ms 3",
    "transport": "--replicas 2 --transport --lease-ticks 6 --rto-base 3 "
                 "--fault-plan partition@fleet.transport:10?replica=0&ticks=8",
    "slo_spec_autoscale": "--replicas 2 --scheduler slo --tenants 2 "
                          "--tenant-priority t1=1 --tenant-quota "
                          "t0=slots:2 --spec lookup --spec-k 4 --autoscale "
                          "min=1,max=3,up=2 --diurnal-amp 0.5 "
                          "--diurnal-period 0.05 --deadline-ms 30 "
                          "--max-queue 6 --log summary",
    "slo_alerts": "--replicas 2 --slo tests/data/sample_slo.json "
                  "--tenants 2 --len-dist lognormal",
}
ERROR_CASES = [
    "--handoff-ticks 2", "--pools prefill:1", "--lease-ticks 4",
    "--rto-base 3", "--spill", "--prefix-cache --host-pages 4",
    "--templates 3", "--policy cache_aware", "--turns-dist uniform:1-2",
    "--sessions 2 --turns-dist uniform:x", "--turn-gap-ms 2",
    "--rate 0 --diurnal-amp 0.5", "--diurnal-amp 1.5",
    "--autoscale-frontier f.jsonl", "--autoscale speed=3",
    "--tenant-quota t0=slots:1", "--trace x.jsonl --prefix-mix 0.5",
    "--trace missing.jsonl",
    "--fault-plan handoff_drop@fleet.handoff:1",
    "--fault-plan kv_corrupt@tier.spill:0",
    "--fault-plan msg_drop@fleet.transport:3",
    "--transport --pools prefill:1,decode:1",
    "--transport --heartbeat-miss 4 --lease-ticks 3",
    "--redispatch discard --fault-plan kv_corrupt@fleet.resume:0",
    "--slo missing.json",
]


@pytest.mark.parametrize("case", list(BENCH_CASES))
def test_fleet_bench_lines_match_jax(case, monkeypatch):
    monkeypatch.chdir(REPO)
    argv = shlex.split(BASE + " " + BENCH_CASES[case])
    rc, lines, err = _main(fleet_bench_main, argv)
    jrc, jlines, jerr = _main(jax_fleet_main, argv)
    assert (rc, err) == (jrc, jerr) == (0, "")
    assert [_strip(x) for x in lines] == [_strip(x) for x in jlines]
    assert len(lines) == 2 and lines[0]["bench"] == "fleet"


def test_fleet_bench_errors_match_jax(tmp_path, monkeypatch):
    """Every refused flag combination: the same exit code and, where the
    bench itself words the error, the same message."""
    monkeypatch.chdir(tmp_path)
    for extra in ERROR_CASES:
        argv = shlex.split("--requests 4 " + extra)
        rc, lines, err = _main(fleet_bench_main, argv)
        jrc, jlines, jerr = _main(jax_fleet_main, argv)
        assert rc == jrc and rc in (1, 2), (extra, rc, err, jrc, jerr)
        assert lines == jlines == [], extra
        if jerr.startswith("error: "):
            assert err == jerr, extra
        else:  # argparse's own words, under each package's program name
            assert err.split(": error: ")[-1] == jerr.split(": error: ")[-1]


def test_fleet_bench_metrics_jsonl_matches_jax(tmp_path):
    """--metrics-jsonl at --log full: the same record stream (every
    event, field and value but the wall clock)."""
    from mpi_cuda_cnn_tpu_torch.obs.schema import load_records, validate_record

    argv = shlex.split(BASE + " " + BENCH_CASES["pools"])
    paths = {}
    for side, fn in (("torch", fleet_bench_main), ("jax", jax_fleet_main)):
        paths[side] = tmp_path / f"{side}.jsonl"
        assert _main(fn, argv + ["--metrics-jsonl", str(paths[side])])[0] == 0

    def events(path):
        return [{k: v for k, v in r.items()
                 if k not in ("t", "wall_s", "wall_tokens_per_s")}
                for r in load_records(path, strict=True)]

    ours = events(paths["torch"])
    for r in load_records(paths["torch"], strict=True):
        validate_record(r)
    assert ours == events(paths["jax"])
    assert {"fleet", "tick", "handoff", "request", "serve", "fault",
            "metrics", "blame"} <= {r["event"] for r in ours}


@pytest.mark.slow
def test_ci_fleet_gate_storm_matches_jax():
    """The 10^5-request storm of ci/fleet_gate.json through both packages'
    fleet-bench: equal trace_crc (and every other summary key but the
    wall clock)."""
    doc = json.loads((REPO / "ci" / "fleet_gate.json").read_text())["_doc"]
    cmd = " ".join(line.strip().rstrip("\\") for line in doc[1:4])
    argv = shlex.split(cmd.split("fleet-bench", 1)[1])
    i = argv.index("--metrics-jsonl")
    del argv[i:i + 2]
    t0 = time.perf_counter()
    rc, lines, _ = _main(fleet_bench_main, argv)
    t_ours = time.perf_counter() - t0
    t0 = time.perf_counter()
    jrc, jlines, _ = _main(jax_fleet_main, argv)
    t_theirs = time.perf_counter() - t0
    print(json.dumps({"trace_crc": lines[1]["trace_crc"],
                      "jax_trace_crc": jlines[1]["trace_crc"],
                      "seconds": round(t_ours, 1),
                      "jax_seconds": round(t_theirs, 1)}))
    assert rc == jrc == 0
    assert lines[0]["requests"] == 100000
    assert lines[1]["trace_crc"] == jlines[1]["trace_crc"]
    assert [_strip(x) for x in lines] == [_strip(x) for x in jlines]
