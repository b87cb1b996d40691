"""The port's serve-bench surface against the JAX package's, on the CPU
at a small size: the workload shapes (template prefixes, heavy-tail
lengths, template working sets, multi-turn sessions, trace replay), the
default stream left as it was, the flag errors (exit code 2, the
reference's words), and the summary lines of a run with the new flags:
the reference's keys, and where the schedule does not depend on the wall
clock, the reference's values (counts, prefix/tier/spec blocks and the
state_crc chain).
"""

import json

import numpy as np
import pytest

from mpi_cuda_cnn_tpu.serve import bench as jax_bench
from mpi_cuda_cnn_tpu_torch.obs.schema import load_records, validate_record
from mpi_cuda_cnn_tpu_torch.serve import bench
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

BASE = dict(n=16, vocab=64, prompt_min=4, prompt_max=40, out_min=2,
            out_max=20, rate=30.0)


def _same_requests(got, want):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert (a.rid, a.max_new_tokens, a.arrival, a.deadline, a.tenant,
                a.session) == (b.rid, b.max_new_tokens, b.arrival,
                               b.deadline, b.tenant, b.session)
        assert a.prompt.dtype == b.prompt.dtype
        np.testing.assert_array_equal(a.prompt, b.prompt)


@pytest.mark.parametrize("kw", [
    dict(seed=0, prefix_mix=0.9),
    dict(seed=1, prefix_mix=0.5, prefix_pool=2, tenants=3),
    dict(seed=2, len_dist="lognormal", deadline_s=0.2),
    dict(seed=3, prefix_mix=0.8, templates=6, len_dist="lognormal"),
], ids=["prefix", "pool_tenants", "lognormal", "templates"])
def test_make_workload_shapes_match_jax(kw):
    args = {**BASE, **kw}
    _same_requests(bench.make_workload(**args),
                   jax_bench.make_workload(**args))


def test_default_stream_is_unchanged_by_the_shaping_options():
    """Lengths, arrivals and tenants at any prefix mix or template count
    are the default stream's; the default call is the plain one."""
    base = bench.make_workload(seed=4, tenants=2, **BASE)
    _same_requests(bench.make_workload(seed=4, tenants=2, prefix_mix=0.0,
                                       len_dist="uniform", templates=0,
                                       **BASE), base)
    for kw in (dict(prefix_mix=0.9), dict(prefix_mix=0.9, templates=5)):
        shaped = bench.make_workload(seed=4, tenants=2, **kw, **BASE)
        assert [(r.max_new_tokens, r.arrival, r.tenant, r.prompt.size)
                for r in shaped] == [(r.max_new_tokens, r.arrival, r.tenant,
                                      r.prompt.size) for r in base]
    with pytest.raises(ValueError, match="len_dist"):
        bench.make_workload(seed=0, len_dist="zipf", **BASE)


@pytest.mark.parametrize("dist,gap", [("uniform:2-4", 0.05),
                                      ("geometric:0.4", 0.0)])
def test_session_turns_match_jax(dist, gap):
    out = []
    for mod in (jax_bench, bench):
        reqs = mod.make_workload(seed=5, tenants=2, deadline_s=0.5, **BASE)
        for r in reqs:
            r.session = r.rid % 3
        out.append(mod.add_session_turns(
            reqs, turns_dist=dist, turn_gap_s=gap, vocab=64, out_min=2,
            out_max=20, max_len=80, seed=5))
    _same_requests(out[1], out[0])
    assert len(out[1]) > BASE["n"]
    for spec in ("uniform:3-1", "uniform:x", "geometric:0", "zipf:2", "u"):
        errs = []
        for mod in (jax_bench, bench):
            with pytest.raises(ValueError) as e:
                mod.parse_turns_dist(spec)
            errs.append(str(e.value))
        assert errs[1] == errs[0]


CPU = ["--device", "cpu", "--dim", "32", "--depth", "1", "--heads", "4",
       "--kv-heads", "2", "--vocab", "64", "--max-seq", "96",
       "--prompt-min", "8", "--prompt-max", "40", "--out-min", "2",
       "--out-max", "12", "--page-size", "8", "--prefill-chunk", "8",
       "--slots", "3", "--seed", "2"]
JAX_CPU = [("gather" if a == "cuda" else a) for a in CPU]
# Keys only the port prints.
PORT_ONLY = {"device", "kernel_launches", "draft_forwards",
             "warmup_forwards"}
# Summary values that do not depend on the wall clock at rate 0.
DETERMINISTIC = ("mode", "requests", "statuses", "output_tokens",
                 "decode_ticks", "prefill_chunks", "preemptions",
                 "state_crc", "prefix_hits", "prefix_misses",
                 "prefix_hit_tokens", "prefix_cow", "prefix_inserts",
                 "prefix_evictions", "tier_spills", "tier_readmits",
                 "tier_refusals", "tier_host_evictions", "spec_rounds",
                 "spec_proposed", "spec_accepted", "spec", "spec_k",
                 "cache_dtype", "weights_dtype", "blame_crc",
                 "blame_quota_ticks")


def _lines(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines() if line]


def test_serve_bench_new_flags_print_the_reference_summary(tmp_path, capsys):
    flags = ["--requests", "10", "--mode", "both", "--prefix-mix", "0.9",
             "--templates", "4", "--prefix-cache", "--spill",
             "--host-pages", "6", "--pages", "14", "--spec", "lookup",
             "--spec-k", "4", "--tenants", "2", "--fault-plan",
             "squeeze@serve.tick:3?pages=2&ticks=4"]
    want = _lines(jax_bench.serve_bench_main, JAX_CPU + flags, capsys)
    got = _lines(bench.serve_bench_main,
                 CPU + flags, capsys)
    assert len(got) == len(want) == 3      # static, continuous, comparison
    for g, w in zip(got[:2], want[:2]):
        assert set(g) - PORT_ONLY == set(w)
        for key in DETERMINISTIC:
            assert g[key] == w[key], key
        assert {t: b["statuses"] for t, b in g["tenants"].items()} == \
            {t: b["statuses"] for t, b in w["tenants"].items()}
    cont = got[1]
    assert cont["prefix_hits"] > 0 and cont["tier_spills"] > 0
    assert cont["spec_accepted"] > 0
    assert set(got[2]) == set(want[2])


def test_serve_bench_slo_sessions_trace_and_jsonl(tmp_path, capsys):
    spec_path = tmp_path / "slo.json"
    spec_path.write_text(json.dumps({
        "tenants": {"*": {"availability": 0.9,
                          "ttft_ms": {"target": 0.9, "threshold_ms": 1.0}}},
        "burn": {"windows_s": [[0.5, 0.1]], "max_rate": 2.0},
        "rules": [{"name": "deep", "kind": "threshold", "event": "tick",
                   "field": "queue", "op": ">=", "value": 1}]}))
    jsonl = tmp_path / "run.jsonl"
    flags = ["--requests", "8", "--rate", "200", "--scheduler", "slo",
             "--tenants", "2", "--tenant-priority", "t1=2",
             "--tenant-quota", "t0=slots:1/pages:8", "--slo", str(spec_path),
             "--sessions", "2", "--turns-dist", "uniform:1-3",
             "--turn-gap-ms", "5", "--len-dist", "lognormal",
             "--deadline-ms", "5000", "--max-queue", "6",
             "--watchdog-ms", "1000", "--spec", "draft", "--draft-cache",
             "paged", "--draft-dim", "16", "--spec-k", "3",
             "--metrics-jsonl", str(jsonl)]
    got = _lines(bench.serve_bench_main, CPU + flags, capsys)
    want = _lines(jax_bench.serve_bench_main, JAX_CPU + flags[:-2], capsys)
    assert [line.get("mode") for line in got] == ["continuous", None]
    assert set(got[0]) - PORT_ONLY == set(want[0])
    assert got[0]["requests"] == want[0]["requests"] > 8
    assert got[0]["draft_forwards"] > 0
    assert got[1]["metric"] == "serve_alerts_fired" and got[1]["value"] > 0
    records = load_records(jsonl, strict=True)
    for rec in records:
        validate_record(rec)
    events = {r["event"] for r in records}
    assert {"tick", "request", "metrics", "serve", "alert"} <= events
    # Trace replay: the recorded geometry back through both packages.
    rows = bench.load_trace(str(jsonl))
    assert rows == jax_bench.load_trace(str(jsonl))
    _same_requests(bench.requests_from_trace(rows, vocab=64, seed=3,
                                             deadline_s=0.1),
                   jax_bench.requests_from_trace(rows, vocab=64, seed=3,
                                                 deadline_s=0.1))
    replay = _lines(bench.serve_bench_main,
                    CPU + ["--trace", str(jsonl), "--mode", "continuous"],
                    capsys)
    assert replay[0]["requests"] == len(rows)


@pytest.mark.parametrize("flags", [
    ["--spec", "lookup", "--mode", "static"],
    ["--spec", "lookup", "--spec-k", "1"],
    ["--draft-cache", "paged"],
    ["--spill"],
    ["--prefix-cache", "--spill", "--host-pages", "0", "--host-pages", "4",
     "--mode", "static"],
    ["--host-pages", "4"],
    ["--templates", "4"],
    ["--turns-dist", "uniform:1-2"],
    ["--turn-gap-ms", "5"],
    ["--sessions", "2", "--turns-dist", "zipf:1"],
    ["--tenant-priority", "t0=1"],
    ["--scheduler", "slo", "--tenant-quota", "t0=gpus:1"],
    ["--prefix-cache", "--mode", "static"],
    ["--trace", "missing.jsonl"],
    ["--trace", "x.jsonl", "--prefix-mix", "0.5"],
], ids=lambda f: " ".join(f))
def test_flag_errors_exit_2_in_the_reference_words(flags, capsys, tmp_path):
    rcs, errs = [], []
    for main, base in ((jax_bench.serve_bench_main, JAX_CPU),
                       (bench.serve_bench_main, CPU)):
        argv = [str(tmp_path / a) if a.endswith(".jsonl") else a
                for a in flags]
        rcs.append(main(base + ["--requests", "2"] + argv))
        out = capsys.readouterr()
        assert out.out == ""
        errs.append(out.err.strip().splitlines()[-1])
    assert rcs == [2, 2]
    assert errs[1] == errs[0]


def test_fault_plan_sites_are_checked_at_parse_time(capsys):
    for main, base in ((jax_bench.serve_bench_main, JAX_CPU),
                       (bench.serve_bench_main, CPU)):
        with pytest.raises(SystemExit) as e:
            main(base + ["--fault-plan", "replica_crash@fleet.tick:3"])
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.count("fleet.tick") >= 2
