"""Offline goodput-frontier search: `python -m mpi_cuda_cnn_tpu_torch
autosize` (counterpart of the reference's `obs/autosize.py`, the same
code and output).

Enumerate candidate fleet topologies at a fixed chip budget (the
unified fleet and every prefill:decode split), run each as a seeded
SimCompute storm, score it by SLO-attained goodput (obs/goodput.py),
rank the candidates into a goodput frontier and recommend the top one.
`--len-dist` adds the heavy-tail length mix as a sweep axis, and
`--schedulers`, `--prefix`, `--spec` and `--spill` the others.

Everything is deterministic: the candidate list is a pure function of
the flags (and, under --seed-from, of the blame profile read from a
finished run), every storm runs on a FakeClock with the seeded workload
regenerated per candidate, and the frontier and recommendation carry
CRCs like the trace, blame and state CRCs, so two runs with identical
(seed, spec) give identical output (`ci/autosize_gate.json` compares
them at 0% with direction "equal").

Blame seeding (`--seed-from RUN`): the run's blame profile (its `blame`
record, what `explain` reads) says where the latency ticks went, and
the dominant category picks the part of the topology space worth
searching:

- handoff_wait dominant  -> the decode pool starves KV adoptions: keep
  unified and the decode-heavy splits (decode > prefill);
- queued_behind dominant -> admission-bound: keep unified and the
  balanced splits (|P - D| <= 1);
- preempted_by dominant  -> memory pressure on the decode side: keep
  unified and the splits with decode >= prefill.

The pruned sweep evaluates fewer candidates than the exhaustive one and
selects the same recommendation.

The storms run SimCompute replicas, which compute tokens in closed form
on the host: a 10^5-request sweep needs no card, and the module's own
code imports no torch (`lint`'s torch-free list). Its `kind="frontier"` record is what `fleet-bench
--autoscale-frontier` reads (serve/autoscale.load_frontier).
"""

from __future__ import annotations

import argparse
import json
import sys
import zlib

from .goodput import (
    default_goodput_spec,
    goodput_from_terminals,
    spec_thresholds,
)
from .schema import fmt_cell as _fmt
from .schema import RUN_MARKER, iter_runs, make_record, validate_record
from .slo import SLOSpec, collect_terminals

# Blame categories a dominance read considers, in tie-break priority
# order (a tie is resolved toward the earlier entry — deterministic).
SEED_CATEGORIES = ("handoff_wait", "queued_behind", "preempted_by")


def candidate_topologies(budget: int) -> list[tuple[str, dict | None]]:
    """The exhaustive topology list at a fixed chip budget: the unified
    fleet plus every prefill:decode split. Order is deterministic
    (unified first, then prefill-ascending) — the exhaustive
    evaluation order."""
    topos: list[tuple[str, dict | None]] = [("unified", None)]
    for p in range(1, budget):
        topos.append((f"{p}:{budget - p}",
                      {"prefill": p, "decode": budget - p}))
    return topos


def blame_profile(records: list[dict]) -> dict | None:
    """The newest `blame` record's per-category totals, or None."""
    for rec in reversed(records):
        if rec.get("event") == "blame":
            return dict(rec.get("categories") or {})
    return None


def dominant_category(categories: dict) -> str | None:
    """The dominant seed category of a blame profile (None when every
    considered category is zero — nothing to seed from)."""
    best = max(SEED_CATEGORIES,
               key=lambda c: (categories.get(c, 0) or 0,
                              -SEED_CATEGORIES.index(c)))
    return best if (categories.get(best, 0) or 0) > 0 else None


def seeded_topologies(budget: int, dominant: str | None
                      ) -> list[tuple[str, dict | None]]:
    """Order + prune the topology list from a blame dominance read
    (module docstring rules). No dominance -> exhaustive."""
    topos = candidate_topologies(budget)
    if dominant is None:
        return topos
    unified = [t for t in topos if t[1] is None]
    splits = [t for t in topos if t[1] is not None]
    if dominant == "handoff_wait":
        keep = [t for t in splits if t[1]["decode"] > t[1]["prefill"]]
    elif dominant == "queued_behind":
        keep = [t for t in splits
                if abs(t[1]["prefill"] - t[1]["decode"]) <= 1]
    else:  # preempted_by
        keep = [t for t in splits if t[1]["decode"] >= t[1]["prefill"]]
    # Decode-heaviest first: the blame said the decode side is where
    # capacity decides, so the most likely winners run first.
    keep.sort(key=lambda t: (-t[1]["decode"], t[0]))
    return unified + keep


# Tri-state sweep-axis flags resolved to candidate values: "both"
# sweeps, anything else pins. Values listed off-first so evaluation
# order (and thus candidate numbering) is deterministic.
_PREFIX_AXIS = {"off": [False], "on": [True], "both": [False, True]}
_SPEC_AXIS = {"off": ["off"], "lookup": ["lookup"],
              "both": ["off", "lookup"]}
_LEN_AXIS = {"uniform": ["uniform"], "lognormal": ["lognormal"],
             "both": ["uniform", "lognormal"]}
_SCHED_AXIS = {"fcfs": ["fcfs"], "slo": ["slo"],
               "both": ["fcfs", "slo"]}
_SPILL_AXIS = {"off": [False], "on": [True], "both": [False, True]}


def run_candidate(args, spec: SLOSpec, *, pools: dict | None,
                  scheduler: str, prefix: bool, spec_mode: str,
                  len_dist: str, spill: bool = False) -> dict:
    """One candidate topology as a seeded SimCompute storm — the SAME
    fleet construction fleet-bench uses (defaults and all), so the
    storm's trace/blame/state CRCs are unchanged by the sweep harness
    (pinned by test). Returns the flat candidate row."""
    from ..faults import FakeClock
    from .causal import BlameAccumulator
    from .metrics import MetricsRegistry
    # The one import outside the torch-free modules: serve/fleet.py is
    # torch-free on the SimCompute path (EngineCompute's engine import
    # is lazy) but hosts the engine-compute factory too, so it stays
    # off the manifest's list.
    from ..serve.fleet import (  # mctpu: disable=MCT001
        Fleet,
        SimCompute,
        make_fleet_workload,
    )
    from ..serve.pool import pages_for
    from ..serve.scheduler import SLOPolicy

    budget = args.budget
    max_len = args.prompt_max + args.out_max
    pages = args.pages or args.slots * pages_for(max_len,
                                                 args.page_size) + 1
    reqs = make_fleet_workload(
        n=args.requests, vocab=args.vocab, prompt_min=args.prompt_min,
        prompt_max=args.prompt_max, out_min=args.out_min,
        out_max=args.out_max, rate=args.rate, seed=args.seed,
        deadline_s=args.deadline_ms / 1e3, tenants=args.tenants,
        len_dist=len_dist, prefix_mix=args.prefix_mix,
        templates=args.templates,
    )
    clock = FakeClock()
    registry = MetricsRegistry(clock=clock)
    blame = BlameAccumulator()
    fleet = Fleet(
        lambda name: SimCompute(vocab=args.vocab,
                                chunk=args.prefill_chunk,
                                salt=args.seed),
        replicas=budget, slots=args.slots, num_pages=pages,
        page_size=args.page_size, max_len=max_len,
        policy="least_loaded", heartbeat_miss=3, backoff_base=0.05,
        max_flaps=3, redispatch="resume", tick_s=args.tick_ms / 1e3,
        check_every=16, clock=clock, registry=registry,
        fleet_sink=blame.ingest_fleet,
        replica_tick_sink=blame.ingest_tick,
        prefix=prefix,
        sched_policy=(SLOPolicy(slo_spec=spec) if scheduler == "slo"
                      else None),
        spec=spec_mode, spec_k=8, spec_ngram=2,
        pools=dict(pools) if pools else None, handoff_ticks=1,
        log_handoffs=False,
        host_pages=(args.host_pages or pages) if spill else 0,
    )
    result = fleet.run(reqs)
    s = result.summary()
    bf = blame.summary_fields("fleet")
    terminals = collect_terminals(
        [{"event": "request", **r} for r in result.request_records()])
    g = goodput_from_terminals(terminals, spec,
                               duration_s=s["duration_s"], chips=budget)
    topo = (f"{pools['prefill']}:{pools['decode']}" if pools
            else "unified")
    return {
        "cand": "/".join((topo, scheduler, len_dist,
                          "prefix" if prefix else "noprefix", spec_mode)
                         + (("spill",) if spill else ())),
        "topology": topo,
        "scheduler": scheduler,
        "prefix": prefix,
        "spec": spec_mode,
        "spill": spill,
        "len_dist": len_dist,
        **g.fields(),
        "finished": (s.get("statuses") or {}).get("finished", 0),
        "tokens_per_s": s["tokens_per_s"],
        "ttft_p99_ms": s["ttft_p99_ms"],
        "tpot_p99_ms": s["tpot_p99_ms"],
        "trace_crc": s["trace_crc"],
        "blame_crc": bf["crc"],
        "state_crc": s["state_crc"],
    }


def _rank_key(row: dict):
    """Frontier order: per-chip goodput desc, then TPOT p99 asc, TTFT
    p99 asc, then candidate spelling — total and deterministic."""
    inf = float("inf")
    per = row.get("per_chip_rps")
    return (-(per if per is not None else -inf),
            row.get("tpot_p99_ms") if row.get("tpot_p99_ms") is not None
            else inf,
            row.get("ttft_p99_ms") if row.get("ttft_p99_ms") is not None
            else inf,
            row["cand"])


def _crc(obj) -> int:
    return zlib.crc32(json.dumps(obj, sort_keys=True).encode())


def sweep(args, spec: SLOSpec, dominant: str | None) -> dict:
    """Run the whole sweep; returns {rows, frontier, recommendation,
    ...} — a pure function of (args, spec, dominant)."""
    topos = seeded_topologies(args.budget, dominant)
    exhaustive = len(candidate_topologies(args.budget))
    axes = []
    for ldist in _LEN_AXIS[args.len_dist]:
        for sched in _SCHED_AXIS[args.schedulers]:
            for pfx in _PREFIX_AXIS[args.prefix]:
                for spm in _SPEC_AXIS[args.spec]:
                    for spl in _SPILL_AXIS[args.spill]:
                        if spl and not pfx:
                            # The host tier spills prefix-tree pages;
                            # spill-on/prefix-off has nothing to spill.
                            continue
                        axes.append((ldist, sched, pfx, spm, spl))
    rows = []
    for topo, pools in topos:
        for ldist, sched, pfx, spm, spl in axes:
            rows.append(run_candidate(
                args, spec, pools=pools, scheduler=sched, prefix=pfx,
                spec_mode=spm, len_dist=ldist, spill=spl))
    ranked = sorted(rows, key=_rank_key)
    rec = ranked[0] if ranked else None
    return {
        "rows": rows,
        "ranked": ranked,
        "recommendation": rec,
        "evaluated": len(rows),
        "pruned": (exhaustive - len(topos)) * len(axes),
        "seeded_from": dominant,
        "frontier_crc": _crc(ranked),
        "recommendation_crc": _crc(rec),
        "thresholds": spec_thresholds(spec),
    }


def render_frontier(res: dict, args) -> str:
    """The frontier + recommendation as markdown."""
    lines = [
        f"## Goodput frontier — budget {args.budget} chips, "
        f"{args.requests} requests @ {args.rate:g} req/s, seed "
        f"{args.seed}",
        "",
        "thresholds: " + ", ".join(
            f"{k}<={v:g}ms" for k, v in res["thresholds"].items()),
        "",
        "| rank | topology | sched | len dist | prefix | spec | spill "
        "| good | good frac | per-chip r/s | tok/s | TTFT p99 ms "
        "| TPOT p99 ms |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for i, r in enumerate(res["ranked"], 1):
        lines.append(
            f"| {i} | {r['topology']} | {r['scheduler']} "
            f"| {r['len_dist']} | {'on' if r['prefix'] else 'off'} "
            f"| {r['spec']} | {'on' if r.get('spill') else 'off'} "
            f"| {r['good']} | {_fmt(r['good_fraction'])} "
            f"| {_fmt(r['per_chip_rps'])} | {_fmt(r['tokens_per_s'])} "
            f"| {_fmt(r['ttft_p99_ms'])} | {_fmt(r['tpot_p99_ms'])} |"
        )
    lines.append("")
    rec = res["recommendation"]
    if rec is not None:
        lines.append(
            f"recommendation: {rec['cand']} — "
            f"{_fmt(rec['per_chip_rps'])} good req/s/chip "
            f"({rec['good']}/{rec['requests']} attained)"
        )
    seeded = res["seeded_from"]
    lines.append(
        f"evaluated {res['evaluated']} candidates"
        + (f" (blame-seeded on {seeded}: pruned {res['pruned']})"
           if seeded else " (exhaustive)")
    )
    lines.append(f"frontier crc: {res['frontier_crc']}  "
                 f"recommendation crc: {res['recommendation_crc']}")
    return "\n".join(lines)


def emit_records(res: dict, path: str) -> None:
    """Append the sweep as `goodput` schema records (one run segment:
    candidates in evaluation order, then the frontier summary) — the
    file `report`/`top`/`compare` consume and the determinism gate
    diffs. The run marker keeps the reference's spelling, so both
    packages write the same bytes."""
    from pathlib import Path

    g_fields = ("requests", "good", "duration_s", "chips",
                "goodput_rps", "per_chip_rps", "good_fraction",
                "estimated", "thresholds")
    with Path(path).open("a") as fh:
        fh.write(f"{RUN_MARKER} mctpu autosize\n")
        t = 0.0
        for row in res["rows"]:
            t = max(t, row["duration_s"])
            fh.write(json.dumps(validate_record(make_record(
                "goodput", row["duration_s"], kind="candidate",
                **row))) + "\n")
        rec = res["recommendation"]
        fh.write(json.dumps(validate_record(make_record(
            "goodput", t, kind="frontier",
            evaluated=res["evaluated"], pruned=res["pruned"],
            seeded_from=res["seeded_from"],
            order=[r["cand"] for r in res["ranked"]],
            recommendation=None if rec is None else rec["cand"],
            **({f"best_{k}": rec[k] for k in g_fields}
               if rec is not None else {}),
            frontier_crc=res["frontier_crc"],
            recommendation_crc=res["recommendation_crc"]))) + "\n")


def autosize_main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch autosize",
        description="Offline goodput-frontier capacity search over "
                    "seeded SimCompute fleets: candidate topologies at "
                    "a fixed chip budget, scored by SLO-attained "
                    "goodput, optionally ordered/pruned by a finished "
                    "run's blame profile (--seed-from). Deterministic: "
                    "identical (seed, spec) runs produce bitwise-"
                    "identical frontiers, CRC-stamped.",
    )
    ap.add_argument("--budget", type=int, default=4,
                    help="chips (sim replicas) every candidate spends")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate, fleet-clock req/s")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="pages per replica (0 = size for slots "
                         "full-length sequences)")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--prompt-min", type=int, default=8)
    ap.add_argument("--prompt-max", type=int, default=96)
    ap.add_argument("--out-min", type=int, default=8)
    ap.add_argument("--out-max", type=int, default=96)
    ap.add_argument("--deadline-ms", type=float, default=0.0)
    ap.add_argument("--tenants", type=int, default=0)
    ap.add_argument("--tick-ms", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--len-dist", default="uniform",
                    choices=["uniform", "lognormal", "both"],
                    help="workload length mix axis (both = sweep the "
                         "uniform AND heavy-tail mixes)")
    ap.add_argument("--schedulers", default="fcfs",
                    choices=["fcfs", "slo", "both"],
                    help="per-replica batching policy axis")
    ap.add_argument("--prefix", default="off",
                    choices=["off", "on", "both"],
                    help="prefix-sharing KV cache axis")
    ap.add_argument("--spec", default="off",
                    choices=["off", "lookup", "both"],
                    help="speculative decoding axis")
    ap.add_argument("--spill", default="off",
                    choices=["off", "on", "both"],
                    help="host-tier prefix-cache spill axis (spill-on "
                         "candidates require the prefix axis on; the "
                         "spill-on/prefix-off combos are skipped)")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host-tier capacity for spill-on candidates "
                         "(0 = match the device pool size)")
    ap.add_argument("--prefix-mix", type=float, default=0.0,
                    help="fraction of requests sharing a workload "
                         "prefix template (what gives the prefix and "
                         "spill axes something to hit)")
    ap.add_argument("--templates", type=int, default=0,
                    help="seeded shared-prefix template pool size "
                         "(0 = legacy two-template mix; default "
                         "workload CRCs are bitwise-unchanged)")
    ap.add_argument("--slo", default=None,
                    help="SLO spec JSON (obs.slo grammar) whose latency "
                         "objectives define goodput; default: "
                         "--ttft-ms/--tpot-ms thresholds")
    ap.add_argument("--ttft-ms", type=float, default=500.0,
                    help="TTFT threshold when no --slo names a spec")
    ap.add_argument("--tpot-ms", type=float, default=50.0,
                    help="TPOT threshold when no --slo names a spec")
    ap.add_argument("--seed-from", default=None,
                    help="finished run JSONL whose blame profile "
                         "(`explain` categories) orders and "
                         "prunes the topology sweep")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append `goodput` records here (candidates + "
                         "frontier — what the CI determinism gate "
                         "compares)")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    args = ap.parse_args(argv)

    if args.budget < 2:
        print(f"error: --budget {args.budget}: a capacity search over "
              "one chip has nothing to decide (want >= 2)",
              file=sys.stderr)
        return 2
    if args.spill == "on" and args.prefix == "off":
        print("error: --spill on needs the prefix axis (--prefix "
              "on/both): the host tier spills prefix-tree pages",
              file=sys.stderr)
        return 2
    try:
        spec = (SLOSpec.load(args.slo) if args.slo
                else default_goodput_spec(args.ttft_ms, args.tpot_ms))
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dominant = None
    if args.seed_from:
        try:
            runs = [r for r in iter_runs(args.seed_from) if r]
        except (OSError, ValueError) as e:
            print(f"error: {args.seed_from}: {e}", file=sys.stderr)
            return 2
        profile = blame_profile(runs[-1]) if runs else None
        if profile is None:
            print(f"error: {args.seed_from}: no blame record to seed "
                  "from (run fleet-bench, or `explain` the file "
                  "first)", file=sys.stderr)
            return 2
        dominant = dominant_category(profile)

    res = sweep(args, spec, dominant)
    if args.metrics_jsonl:
        emit_records(res, args.metrics_jsonl)
    if args.format == "json":
        print(json.dumps({
            "budget": args.budget, "seed": args.seed,
            "seeded_from": res["seeded_from"],
            "evaluated": res["evaluated"], "pruned": res["pruned"],
            "thresholds": res["thresholds"],
            "frontier": res["ranked"],
            "recommendation": res["recommendation"],
            "frontier_crc": res["frontier_crc"],
            "recommendation_crc": res["recommendation_crc"],
        }))
    else:
        print(render_frontier(res, args))
    return 0


if __name__ == "__main__":
    sys.exit(autosize_main())
