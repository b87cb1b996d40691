"""Run health verdicts: `python -m mpi_cuda_cnn_tpu_torch health RUN [--slo
slo.json]` (counterpart of the reference's `obs/health.py`, the same
code and output).

Turns a finished run file and a declarative SLO spec into a per-tenant
verdict table (attainment against target, error budget left, worst burn
rate, alerts fired) and an exit code: 0 healthy, 1 violated, 2 a config
or file error. Training runs get the train-stream rules (loss spikes,
restarts, non-finite steps, a step_ms p99 ceiling) in the same call.

--verify-alerts replays the file's SLO alert sequence from its records
(obs.alerts' pure fold) and, when the file carries live alert records
from a full-log run, requires the two sequences to match CRC-exactly.
Summary-only files skip the check even when asked: their live alerts
were fed from sink records the file omits.

Verdict sources, in order of fidelity:

1. per-tick `terminal` entries or `request` records: exact good/bad
   counts and burn rates (obs.slo.verdicts_from_terminals);
2. summary-only: availability from per-tenant status counts, latency
   attainment estimated from the registry's log-bucket histograms
   (rows flagged `est`).

As in `compare`, the last run segment of an append-mode file is the
one judged.
"""

from __future__ import annotations

import argparse
import json
import sys

from .alerts import AlertEngine, alerts_crc, format_alert
from .goodput import tenant_goodput_rps
from .schema import fmt_cell as _fmt
from .schema import iter_runs
from .slo import (
    SLOSpec,
    collect_terminals,
    default_spec,
    train_health,
    verdicts_from_summary,
    verdicts_from_terminals,
)


def evaluate(records: list[dict], spec: SLOSpec,
             verify_alerts: bool = False) -> dict:
    """One run's health evaluation (the JSON output shape)."""
    terminals = collect_terminals(records)
    if terminals:
        verdicts = verdicts_from_terminals(terminals, spec)
        source = "events"
    else:
        verdicts = verdicts_from_summary(records, spec)
        source = "summary" if verdicts else "none"

    engine = AlertEngine(slo=spec)
    replayed = engine.replay(records)
    # Projection keeps the CRC identity keys AND the per-kind context
    # (field/family/metric/value...) the rendered alert lines name.
    live = [{k: v for k, v in r.items()
             if k not in ("schema", "event", "t")}
            for r in records if r.get("event") == "alert"]
    has_ticks = any(r.get("event") == "tick" for r in records)
    live_crc = alerts_crc(live) if live else None
    crc_checked = verify_alerts and bool(live) and has_ticks
    crc_ok = (live_crc == engine.crc) if crc_checked else None
    # The alert set the verdicts judge: live records when the file
    # carries alerts the replay cannot reproduce (a `--log summary`
    # storm fed the live engine from sink records the file omits —
    # replaying such a file finds nothing, and a max_alerts gate that
    # only counted the replay would wave through the very alerts the
    # file shows). With a tick trail, replay and live must agree
    # (--verify-alerts pins it) and the replay is authoritative.
    judged = live if (live and not has_ticks) else replayed
    judged_crc = live_crc if (live and not has_ticks) else engine.crc

    alerts_by_tenant: dict[str, int] = {}
    for a in judged:
        key = a.get("tenant") or a.get("group") or "-"
        alerts_by_tenant[str(key)] = alerts_by_tenant.get(str(key), 0) + 1

    # Per-tenant SLO-attained goodput (obs/goodput.py): the
    # verdict table's capacity column — requests/s per chip whose
    # latency objectives ALL held. Exact-trail only; {} (em-dash
    # column) on summary-only files.
    tenant_rps = tenant_goodput_rps(records, spec)

    trains = train_health(records, spec)
    if source == "none" and trains:
        source = "train"
    violations = [f"{v.tenant}/{v.metric}" for v in verdicts if v.violated]
    violations += [f"train:{t.rule}" for t in trains if t.violated]
    if crc_ok is False:
        violations.append("alert_crc_mismatch")
    if spec.max_alerts is not None and len(judged) > spec.max_alerts:
        violations.append(f"alerts_fired>{spec.max_alerts}")
    return {
        "source": source,
        "verdicts": verdicts,
        "train": trains,
        "alerts": judged,
        "alerts_fired": len(judged),
        "alerts_crc": judged_crc,
        "alert_crc_checked": crc_checked,
        "alert_crc_ok": crc_ok,
        "alerts_by_tenant": alerts_by_tenant,
        "tenant_goodput": tenant_rps,
        "violations": violations,
        "healthy": not violations,
    }


def render_verdicts(ev: dict) -> str:
    lines = []
    if ev["verdicts"]:
        lines += [
            "| tenant | objective | events | good | bad | attainment "
            "| target | budget left | worst burn | goodput r/s "
            "| alerts | verdict |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|",
        ]
        for v in ev["verdicts"]:
            obj = v.metric + (f"<={v.threshold_ms:g}ms"
                              if v.threshold_ms is not None else "")
            att = v.attainment
            lines.append(
                f"| {v.tenant} | {obj}{' (est)' if v.estimated else ''} "
                f"| {v.events} | {v.good} | {v.bad} "
                f"| {_fmt(None if att is None else round(att, 6))} "
                f"| {v.target:g} "
                f"| {_fmt(None if v.budget_left is None else round(v.budget_left, 4))} "
                f"| {_fmt(v.worst_burn)} "
                f"| {_fmt(ev['tenant_goodput'].get(v.tenant))} "
                f"| {ev['alerts_by_tenant'].get(v.tenant, 0)} "
                f"| {'VIOLATED' if v.violated else 'ok'} |"
            )
        lines.append("")
    if ev["train"]:
        lines += ["| train rule | value | bound | verdict |",
                  "|---|---|---|---|"]
        for t in ev["train"]:
            lines.append(
                f"| {t.rule} | {_fmt(t.value)} | {_fmt(t.bound)} "
                f"| {'VIOLATED' if t.violated else 'ok'}"
                f"{' — ' + t.detail if t.detail else ''} |"
            )
        lines.append("")
    crc_note = ""
    if ev["alert_crc_checked"]:
        crc_note = (" (live record cross-check: "
                    + ("ok" if ev["alert_crc_ok"] else "MISMATCH") + ")")
    lines.append(f"alerts fired: {ev['alerts_fired']}  "
                 f"crc: {ev['alerts_crc']}{crc_note}")
    for a in ev["alerts"][:20]:
        lines.append("  " + format_alert(a))
    if len(ev["alerts"]) > 20:
        lines.append(f"  ... {len(ev['alerts']) - 20} more")
    return "\n".join(lines)


def health_main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch health",
        description="Per-tenant SLO verdicts + alert replay for a "
                    "finished run file; exit 1 on violation (the CI "
                    "health gate), 2 on config/file errors.",
    )
    ap.add_argument("path", help="metrics JSONL run file")
    ap.add_argument("--slo", default=None,
                    help="SLO spec JSON (obs.slo grammar); default: "
                         "99%% availability per tenant, no latency "
                         "objectives")
    ap.add_argument("--verify-alerts", action="store_true",
                    help="cross-check the file's live alert records "
                         "against a replay under THIS spec (CRC exact; "
                         "mismatch is a violation) — use when --slo is "
                         "the same spec the run's --slo used")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    args = ap.parse_args(argv)

    try:
        spec = SLOSpec.load(args.slo) if args.slo else default_spec()
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        runs = [r for r in iter_runs(args.path) if r]
    except (OSError, ValueError) as e:
        print(f"error: {args.path}: {e}", file=sys.stderr)
        return 2
    if not runs:
        print(f"error: {args.path}: no records", file=sys.stderr)
        return 2
    ev = evaluate(runs[-1], spec, verify_alerts=args.verify_alerts)
    if ev["source"] == "none" and not ev["train"]:
        print(f"error: {args.path}: no serving or training records to "
              "judge", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps({
            "path": args.path,
            "source": ev["source"],
            "healthy": ev["healthy"],
            "violations": ev["violations"],
            "alerts_fired": ev["alerts_fired"],
            "alerts_crc": ev["alerts_crc"],
            "alert_crc_ok": ev["alert_crc_ok"],
            "tenant_goodput": ev["tenant_goodput"],
            "verdicts": [
                {"tenant": v.tenant, "metric": v.metric,
                 "events": v.events, "good": v.good, "bad": v.bad,
                 "attainment": v.attainment, "target": v.target,
                 "budget_left": v.budget_left,
                 "worst_burn": v.worst_burn, "estimated": v.estimated,
                 "violated": v.violated}
                for v in ev["verdicts"]
            ],
            "train": [
                {"rule": t.rule, "value": t.value, "bound": t.bound,
                 "violated": t.violated}
                for t in ev["train"]
            ],
            "alerts": ev["alerts"],
        }))
    else:
        print(f"## Health — {args.path} [{ev['source']}]\n")
        print(render_verdicts(ev))
        if not ev["healthy"]:
            print(f"\nUNHEALTHY: {', '.join(ev['violations'])}")
    return 0 if ev["healthy"] else 1


if __name__ == "__main__":
    sys.exit(health_main())
