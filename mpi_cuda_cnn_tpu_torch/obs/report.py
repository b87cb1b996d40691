"""A metrics JSONL run summarised as tables: `python -m
mpi_cuda_cnn_tpu_torch report RUN` (counterpart of the reference's
`obs/report.py`, the same code and output; `mfu` is computed for the
card's records, `cuda`, where the reference computes it for its TPU's).

Reads any file of schema records (`obs/schema.py`; lines without a
schema stamp pass through, '#' comments are skipped) and renders one
table per family: the training trajectory, epoch times, the step-phase
split, the counted step (`program` records of `obs/cost.py`: FLOPs,
bytes, collectives, and mfu where the card's peak is known), device
memory peaks, host spans, and the serving, fleet and blame tables.
`--format json` gives the summary as one object; `--merge` folds every
run segment of every file into one report.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from collections.abc import Iterable

from .cost import mfu, peak_flops
from .metrics import Histogram, pct_nearest
from .schema import fmt_cell as _fmt
from .schema import iter_runs


def _merge_hist_fields(a: dict, b: dict) -> dict:
    """Sum two Histogram.to_fields() dicts (same implied bucket edges —
    obs.metrics.log_bucket_bounds): bucket counts added index-wise,
    count/sum added, min/max enveloped. The cross-segment half of
    --merge: one restarted process's histogram continues the other's."""
    counts = {i: c for i, c in a.get("buckets", [])}
    for i, c in b.get("buckets", []):
        counts[i] = counts.get(i, 0) + c
    mins = [m for m in (a.get("min"), b.get("min")) if m is not None]
    maxs = [m for m in (a.get("max"), b.get("max")) if m is not None]
    return {
        "count": a.get("count", 0) + b.get("count", 0),
        "sum": a.get("sum", 0.0) + b.get("sum", 0.0),
        "min": min(mins) if mins else None,
        "max": max(maxs) if maxs else None,
        "buckets": sorted([i, c] for i, c in counts.items()),
    }


def _request_group_row(rs: list[dict]) -> dict:
    """Aggregate one group of `request` records (a mode, or a
    (mode, tenant) pair) into the shared serving-row fields — ONE
    implementation of the finished-only filter, the TPOT formula, and
    the nearest-rank percentiles, so the per-mode and per-tenant tables
    can never drift apart. Latency stats cover FINISHED requests only:
    an aborted request carries null where the moment never happened
    (older records have no status and count finished)."""
    fin = [r for r in rs if r.get("status", "finished") == "finished"]
    ttft = [r["ttft_ms"] for r in fin if r.get("ttft_ms") is not None]
    # Per-output-token latency after the first token (TPOT).
    tpot = [
        (r["latency_ms"] - r["ttft_ms"]) / max(r["output_tokens"] - 1, 1)
        for r in fin
        if r.get("latency_ms") is not None and r.get("ttft_ms") is not None
    ]
    statuses: dict[str, int] = {}
    for r in rs:
        st = r.get("status", "finished")
        statuses[st] = statuses.get(st, 0) + 1
    # Quota skip-over wait: the SLOScheduler policy
    # share of queue wait, split from capacity waits. Absent in
    # older records -> no column data (renders as an em-dash).
    quota = [r["queue_wait_quota_ms"] for r in rs
             if r.get("queue_wait_quota_ms") is not None]
    return {
        "requests": len(rs),
        "statuses": statuses,
        "output_tokens": sum(r["output_tokens"] for r in rs),
        "ttft_p50_ms": _pct(ttft, 50),
        "ttft_p99_ms": _pct(ttft, 99),
        "tpot_p50_ms": _pct(tpot, 50),
        "tpot_p99_ms": _pct(tpot, 99),
        "quota_wait_p99_ms": _pct(quota, 99),
    }


def _by_event(records: Iterable[dict]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for r in records:
        if isinstance(r, dict) and "event" in r:
            out.setdefault(r["event"], []).append(r)
    return out


def summarize(records: Iterable[dict], *,
              peak_tflops: float | None = None) -> dict:
    """Aggregate records into one summary dict (the JSON output form)."""
    ev = _by_event(records)
    summary: dict = {
        "events": {k: len(v) for k, v in sorted(ev.items())},
        "duration_s": max((r.get("t", 0.0) for v in ev.values() for r in v),
                          default=0.0),
    }

    trains = ev.get("train", [])
    if trains:
        losses = [r["loss"] for r in trains if r.get("loss") is not None]
        summary["train"] = {
            "records": len(trains),
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "min_loss": min(losses) if losses else None,
            "last_step": trains[-1].get("step"),
        }

    epochs = ev.get("epoch", [])
    if epochs:
        secs = [r["seconds"] for r in epochs]
        summary["epochs"] = {
            "count": len(epochs),
            "mean_s": statistics.fmean(secs),
            "median_s": statistics.median(secs),
            "best_s": min(secs),
        }

    evals = ev.get("eval", [])
    if evals:
        summary["eval"] = {k: v for k, v in evals[-1].items()
                           if k not in ("schema", "event", "t")}

    phases = ev.get("step_phases", [])
    if phases:
        steps = sum(r["steps"] for r in phases)
        totals: dict[str, float] = {}
        for r in phases:
            for name, ms in r["phases_ms"].items():
                totals[name] = totals.get(name, 0.0) + ms * r["steps"]
        summary["step_phases"] = {
            "steps": steps,
            "per_step_ms": {k: v / max(steps, 1) for k, v in totals.items()},
        }

    programs = ev.get("program", [])
    if programs:
        progs = []
        for r in programs:
            p = {
                "label": r.get("label", "step"),
                "flops": r.get("flops"),
                "bytes": r.get("bytes"),
                "steps_per_dispatch": r.get("steps_per_dispatch", 1),
                "collectives": r.get("collectives", {}),
                "backend": r.get("backend"),
                # Donation ledger + live scratch (obs.cost alias/memory
                # fields; absent in older records -> None).
                "aliased_outputs": r.get("aliased_outputs"),
                "alias_bytes": r.get("alias_bytes"),
                "temp_bytes": r.get("temp_bytes"),
            }
            flops, n = p["flops"], p["steps_per_dispatch"] or 1
            p["flops_per_step"] = flops / n if flops else None
            peak = peak_flops(
                r.get("compute_dtype", "bfloat16"),
                backend=p["backend"], override_tflops=peak_tflops,
            ) if (p["backend"] == "cuda" or peak_tflops) else None
            sp = summary.get("step_phases", {}).get("per_step_ms", {})
            step_s = sum(sp.values()) / 1e3 if sp else None
            p["mfu"] = (mfu(p["flops_per_step"], step_s, peak)
                        if step_s else None)
            progs.append(p)
        summary["programs"] = progs

    memories = ev.get("memory", [])
    if memories:
        peaks = [
            d["stats"]["peak_bytes_in_use"]
            for r in memories for d in r["devices"]
            if d.get("stats") and "peak_bytes_in_use" in d["stats"]
        ]
        summary["memory"] = {
            "records": len(memories),
            "hbm_peak_bytes": max(peaks) if peaks else None,
        }

    requests = ev.get("request", [])
    if requests:
        by_mode: dict[str, list[dict]] = {}
        for r in requests:
            by_mode.setdefault(r.get("mode", "?"), []).append(r)
        rows = []
        for mode, rs in sorted(by_mode.items()):
            rows.append({
                "mode": mode,
                **_request_group_row(rs),
                "prompt_tokens": sum(r["prompt_tokens"] for r in rs),
                "preemptions": sum(r.get("preemptions", 0) for r in rs),
            })
        summary["requests"] = rows
        # Per-tenant serving table: only when any record is
        # tenant-tagged — a single-tenant run must not grow a table
        # that duplicates the per-mode rows above.
        if any(r.get("tenant") not in (None, "default") for r in requests):
            by_mt: dict[tuple[str, str], list[dict]] = {}
            for r in requests:
                key = (r.get("mode", "?"), r.get("tenant") or "default")
                by_mt.setdefault(key, []).append(r)
            summary["tenants"] = [
                {"mode": mode, "tenant": tenant, **_request_group_row(rs)}
                for (mode, tenant), rs in sorted(by_mt.items())
            ]

    blames = ev.get("blame", [])
    if blames:
        # Causal blame summaries (obs/causal.py): one row per
        # `blame` record (per mode, per segment under --merge).
        summary["blame"] = [
            {k: r.get(k) for k in
             ("mode", "requests", "categories", "quota_ticks",
              "tenants", "conserved", "crc")}
            for r in blames
        ]

    goodputs = ev.get("goodput", [])
    if goodputs:
        # Autosize sweep output (obs/autosize.py): candidate
        # rows in frontier order (the frontier record's ranking), plus
        # the recommendation line. Standalone kind="run" measurements
        # surface as candidates of a one-row frontier.
        cands = {r.get("cand", "run"): r for r in goodputs
                 if r.get("kind") in ("candidate", "run")}
        frontier = next((r for r in reversed(goodputs)
                         if r.get("kind") == "frontier"), None)
        order = (frontier or {}).get("order") or sorted(cands)
        summary["autosize"] = {
            "candidates": [
                {k: cands[c].get(k) for k in
                 ("cand", "topology", "scheduler", "len_dist", "prefix",
                  "spec", "requests", "good", "good_fraction",
                  "per_chip_rps", "goodput_rps", "tokens_per_s",
                  "ttft_p99_ms", "tpot_p99_ms", "estimated")}
                for c in order if c in cands
            ],
            **({k: frontier.get(k) for k in
                ("evaluated", "pruned", "seeded_from", "recommendation",
                 "frontier_crc", "recommendation_crc")}
               if frontier else {}),
        }

    chaos = ev.get("chaos", [])
    if chaos:
        # Chaos-search output (chaos/): one row per sampled
        # episode (plan spelling, axes, oracle verdict, CRCs), plus the
        # search summary — and, when the search failed, the minimized
        # repro plan.
        csum = next((r for r in reversed(chaos)
                     if r.get("kind") == "summary"), None)
        summary["chaos"] = {
            "rows": [
                {k: r.get(k) for k in
                 ("episode", "seed", "axes", "plan", "faults",
                  "requests", "violations", "replay_ticks",
                  "episode_crc", "trace_crc", "state_crc", "blame_crc")}
                for r in chaos if r.get("kind") == "episode"
            ],
            **({k: csum.get(k) for k in
                ("episodes", "violations", "failed", "episodes_crc",
                 "min_plan", "shrink_probes")
                if k in csum} if csum else {}),
        }

    alerts = ev.get("alert", [])
    if alerts:
        by_rule: dict[str, int] = {}
        by_sev: dict[str, int] = {}
        for r in alerts:
            by_rule[r.get("rule", "?")] = by_rule.get(r.get("rule", "?"),
                                                      0) + 1
            by_sev[r.get("severity", "?")] = by_sev.get(
                r.get("severity", "?"), 0) + 1
        summary["alerts"] = {
            "count": len(alerts),
            "by_rule": dict(sorted(by_rule.items())),
            "by_severity": dict(sorted(by_sev.items())),
        }

    faults = ev.get("fault", [])
    ckpts = ev.get("ckpt", [])
    if faults or ckpts:
        by_kind: dict[str, int] = {}
        for r in faults:
            kind = r.get("kind", "?")
            by_kind[kind] = by_kind.get(kind, 0) + 1
        summary["robustness"] = {
            "events": len(faults),
            "by_kind": dict(sorted(by_kind.items())),
            "restarts": by_kind.get("restart", 0),
            "nonfinite_steps": by_kind.get("nonfinite_step", 0),
            "checkpoint_fallbacks": by_kind.get("ckpt_fallback", 0),
            # Elasticity trail: preemption snapshots taken,
            # resumes that changed the mesh underneath the run.
            "preemptions": by_kind.get("preempt", 0),
            "topology_changes": by_kind.get("topology_change", 0),
            "ckpt_events": {
                reason: sum(1 for r in ckpts if r.get("reason") == reason)
                for reason in sorted({r.get("reason", "?") for r in ckpts})
            },
        }

    replicas = ev.get("replica", [])
    fleets = ev.get("fleet", [])
    if replicas or fleets:
        # Replica lifecycle: joins/crashes/restarts/circuit
        # opens per replica, plus the last router-tick state. The fleet
        # run's aggregate counters land in the `serve` table below
        # (mode "fleet") like any other serving summary.
        by_replica: dict[str, dict[str, int]] = {}
        for r in replicas:
            per = by_replica.setdefault(r.get("name", "?"), {})
            kind = r.get("kind", "?")
            per[kind] = per.get(kind, 0) + 1
        kinds: dict[str, int] = {}
        for per in by_replica.values():
            for k, v in per.items():
                kinds[k] = kinds.get(k, 0) + v
        last = fleets[-1] if fleets else {}
        summary["fleet"] = {
            "replica_events": len(replicas),
            "by_kind": dict(sorted(kinds.items())),
            "by_replica": {name: dict(sorted(per.items()))
                           for name, per in sorted(by_replica.items())},
            "ticks_logged": len(fleets),
            "replicas_last": last.get("replicas"),
            "pending_last": last.get("pending"),
            # Cache-aware routing: the newest fleet record's
            # cumulative per-replica [routed hits, dispatches] split —
            # the ROUTING table's rows (absent off cache_aware).
            "route_last": last.get("route"),
        }

    # Lossy transport: the bus's cumulative message counters
    # from the run summary (present on every --transport run, faults or
    # not), plus partition open/heal lifecycle counts from the
    # `transport` event records.
    t_serve = next((r for r in ev.get("serve", [])
                    if r.get("msgs_sent") is not None), None)
    t_events = ev.get("transport", [])
    if t_serve is not None or t_events:
        t_kinds: dict[str, int] = {}
        for r in t_events:
            k = r.get("kind", "?")
            t_kinds[k] = t_kinds.get(k, 0) + 1
        summary["transport"] = {
            **({k: t_serve.get(k) for k in
                ("msgs_sent", "msgs_delivered", "msgs_dropped",
                 "msgs_duped", "msgs_delayed", "msgs_deduped",
                 "retransmits", "lease_refusals", "partitions",
                 "lease_ticks")} if t_serve is not None else {}),
            "events": dict(sorted(t_kinds.items())),
        }

    handoffs = ev.get("handoff", [])
    if handoffs:
        # Disaggregated KV handoffs: lifecycle counts by
        # state, aborts broken down by reason.
        by_state: dict[str, int] = {}
        by_reason: dict[str, int] = {}
        for r in handoffs:
            st = r.get("state", "?")
            by_state[st] = by_state.get(st, 0) + 1
            if st == "aborted":
                why = r.get("reason", "?")
                by_reason[why] = by_reason.get(why, 0) + 1
        summary["handoffs"] = {
            "events": len(handoffs),
            "by_state": dict(sorted(by_state.items())),
            "aborts_by_reason": dict(sorted(by_reason.items())),
            "pages": sum(r.get("pages", 0) for r in handoffs
                         if r.get("state") == "done"),
        }

    serves = ev.get("serve", [])
    if serves:
        summary["serve"] = [
            {k: r.get(k) for k in
             ("mode", "requests", "statuses", "output_tokens",
              "decode_ticks", "prefill_chunks", "preemptions",
              "watchdog_slow_ticks", "tokens_per_s",
              "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms",
              "prefix_hits", "prefix_misses", "prefix_hit_tokens",
              "prefix_cow", "prefix_evictions",
              "host_pages", "tier_spills", "tier_readmits",
              "tier_refusals", "tier_host_evictions",
              "policy", "autoscale", "route_hits", "route_misses",
              "route_hit_tokens", "scale_ups", "scale_downs",
              "replica_ticks",
              "spec_rounds", "spec_proposed", "spec_accepted")}
            for r in serves
        ]

    snaps = ev.get("metrics", [])
    if snaps:
        # The NEWEST registry snapshot per (segment, label): within one
        # process counters/histograms are cumulative, so the last
        # snapshot subsumes the earlier ones — but each relaunched
        # process (a supervisor restart under --merge, tagged "_seg" by
        # report_main) restarts its registry at zero, so segment-latest
        # snapshots are FOLDED: counters summed, histograms merged
        # bucket-wise, gauges last-segment-wins. "mode" labels serving
        # registries; trainers default to train.
        latest: dict[tuple[int, str], dict] = {}
        for r in snaps:
            latest[(r.get("_seg", 0), r.get("mode", "train"))] = r
        folded: dict[str, dict] = {}
        for (_, label), r in sorted(latest.items()):
            f = folded.setdefault(
                label, {"counters": {}, "gauges": {}, "histograms": {}})
            for k, v in (r.get("counters") or {}).items():
                f["counters"][k] = f["counters"].get(k, 0) + v
            for k, g in (r.get("gauges") or {}).items():
                f["gauges"][k] = (g or {}).get("value")
            for k, fields in (r.get("histograms") or {}).items():
                prev = f["histograms"].get(k)
                f["histograms"][k] = fields if prev is None \
                    else _merge_hist_fields(prev, fields)
        out: dict[str, dict] = {}
        for label, f in sorted(folded.items()):
            hists = {}
            for name, fields in sorted(f["histograms"].items()):
                h = Histogram.from_fields(fields)
                hists[name] = {
                    "count": h.count,
                    "p50": h.percentile(50),
                    "p95": h.percentile(95),
                    "p99": h.percentile(99),
                    "min": h.min,
                    "max": h.max,
                }
            out[label] = {
                "counters": dict(sorted(f["counters"].items())),
                "gauges": dict(sorted(f["gauges"].items())),
                "histograms": hists,
            }
        summary["metrics"] = out

    spans = ev.get("span", [])
    if spans:
        agg: dict[str, list[float]] = {}
        for r in spans:
            agg.setdefault(r["name"], []).append(r["ms"])
        summary["spans"] = {
            name: {"count": len(ms), "total_ms": sum(ms),
                   "mean_ms": statistics.fmean(ms)}
            for name, ms in sorted(agg.items())
        }
    return summary


_pct = pct_nearest


def render_markdown(summary: dict, title: str = "Run report") -> str:
    """The summary as markdown tables — what PERF.md sections are made
    of, generated instead of hand-assembled."""
    lines = [f"## {title}", ""]
    lines += [
        f"Records: "
        + ", ".join(f"{k}={v}" for k, v in summary["events"].items())
        + f"; duration {summary['duration_s']:.4g} s",
        "",
    ]
    if "train" in summary:
        t = summary["train"]
        lines += [
            "| training | records | first loss | last loss | min loss | last step |",
            "|---|---|---|---|---|---|",
            f"| | {t['records']} | {_fmt(t['first_loss'])} "
            f"| {_fmt(t['last_loss'])} | {_fmt(t['min_loss'])} "
            f"| {_fmt(t['last_step'])} |",
            "",
        ]
    if "epochs" in summary:
        e = summary["epochs"]
        lines += [
            "| epochs | mean s | median s | best s |",
            "|---|---|---|---|",
            f"| {e['count']} | {e['mean_s']:.4g} | {e['median_s']:.4g} "
            f"| {e['best_s']:.4g} |",
            "",
        ]
    if "eval" in summary:
        kv = summary["eval"]
        lines += ["| eval | " + " | ".join(kv) + " |",
                  "|---|" + "---|" * len(kv),
                  "| last | " + " | ".join(_fmt(v) for v in kv.values()) + " |",
                  ""]
    if "step_phases" in summary:
        sp = summary["step_phases"]
        names = sorted(sp["per_step_ms"])
        lines += [
            "| step phases (ms/step) | " + " | ".join(names)
            + " | total | steps |",
            "|---|" + "---|" * (len(names) + 2),
            "| | "
            + " | ".join(f"{sp['per_step_ms'][n]:.4g}" for n in names)
            + f" | {sum(sp['per_step_ms'].values()):.4g} | {sp['steps']} |",
            "",
        ]
    if "programs" in summary:
        lines += [
            "| program | flops/dispatch | bytes | aliased (live-mem) "
            "| temp bytes | steps/dispatch | flops/step | collectives "
            "| MFU |",
            "|---|---|---|---|---|---|---|---|---|",
        ]
        for p in summary["programs"]:
            mfu_s = f"{p['mfu'] * 100:.1f}%" if p.get("mfu") else "—"
            # Donation column: how many outputs alias their inputs and
            # how many bytes update IN PLACE (state that never needs a
            # second live copy at the optimizer update).
            alias_s = "—"
            if p.get("aliased_outputs"):
                ab = p.get("alias_bytes")
                alias_s = f"{p['aliased_outputs']}"
                if ab:
                    alias_s += f" ({_fmt(ab)} B)"
            lines.append(
                f"| {p['label']} | {_fmt(p['flops'])} | {_fmt(p['bytes'])} "
                f"| {alias_s} | {_fmt(p.get('temp_bytes'))} "
                f"| {p['steps_per_dispatch']} | {_fmt(p['flops_per_step'])} "
                f"| {_fmt(p['collectives'])} | {mfu_s} |"
            )
        lines.append("")
    if "requests" in summary:
        lines += [
            "| serving (per-request) | requests | statuses | out tokens "
            "| preempt | TTFT p50 ms | TTFT p99 ms | tok p50 ms "
            "| tok p99 ms | quota wait p99 ms |",
            "|---|---|---|---|---|---|---|---|---|---|",
        ]
        for r in summary["requests"]:
            lines.append(
                f"| {r['mode']} | {r['requests']} "
                f"| {_fmt(r.get('statuses'))} | {r['output_tokens']} "
                f"| {r['preemptions']} | {_fmt(r['ttft_p50_ms'])} "
                f"| {_fmt(r['ttft_p99_ms'])} | {_fmt(r['tpot_p50_ms'])} "
                f"| {_fmt(r['tpot_p99_ms'])} "
                f"| {_fmt(r.get('quota_wait_p99_ms'))} |"
            )
        lines.append("")
    if "tenants" in summary:
        lines += [
            "| tenant traffic | tenant | requests | statuses "
            "| out tokens | TTFT p50 ms | TTFT p99 ms | tok p50 ms "
            "| tok p99 ms | quota wait p99 ms |",
            "|---|---|---|---|---|---|---|---|---|---|",
        ]
        for r in summary["tenants"]:
            lines.append(
                f"| {r['mode']} | {r['tenant']} | {r['requests']} "
                f"| {_fmt(r['statuses'])} | {r['output_tokens']} "
                f"| {_fmt(r['ttft_p50_ms'])} | {_fmt(r['ttft_p99_ms'])} "
                f"| {_fmt(r['tpot_p50_ms'])} | {_fmt(r['tpot_p99_ms'])} "
                f"| {_fmt(r.get('quota_wait_p99_ms'))} |"
            )
        lines.append("")
    if "blame" in summary:
        # Causal blame: aggregate critical-path attribution
        # per mode — where the run's request-latency ticks actually
        # went, with the quota skip-over share split out.
        from .causal import CATEGORIES as _BLAME_CATS

        lines += [
            "| blame (ticks) | requests | "
            + " | ".join(c.replace("_", " ") for c in _BLAME_CATS)
            + " | quota skip | conserved | crc |",
            "|---|" + "---|" * (len(_BLAME_CATS) + 4),
        ]
        for r in summary["blame"]:
            cats = r.get("categories") or {}
            lines.append(
                f"| {r['mode']} | {_fmt(r.get('requests'))} | "
                + " | ".join(_fmt(cats.get(c)) for c in _BLAME_CATS)
                + f" | {_fmt(r.get('quota_ticks'))} "
                f"| {'yes' if r.get('conserved') else 'NO'} "
                f"| {_fmt(r.get('crc'))} |"
            )
        lines.append("")
    if "autosize" in summary:
        # Goodput frontier (obs/autosize.py): candidate rows
        # in frontier order plus the sweep's recommendation line.
        az = summary["autosize"]
        lines += [
            "| frontier | topology | sched | len dist | prefix | spec "
            "| good | good frac | per-chip r/s | tok/s | TTFT p99 ms "
            "| TPOT p99 ms |",
            "|---|" + "---|" * 11,
        ]
        for i, r in enumerate(az["candidates"], 1):
            est = " (est)" if r.get("estimated") else ""
            lines.append(
                f"| {i}{est} | {_fmt(r.get('topology'))} "
                f"| {_fmt(r.get('scheduler'))} | {_fmt(r.get('len_dist'))} "
                f"| {'on' if r.get('prefix') else 'off'} "
                f"| {_fmt(r.get('spec'))} | {_fmt(r.get('good'))} "
                f"| {_fmt(r.get('good_fraction'))} "
                f"| {_fmt(r.get('per_chip_rps'))} "
                f"| {_fmt(r.get('tokens_per_s'))} "
                f"| {_fmt(r.get('ttft_p99_ms'))} "
                f"| {_fmt(r.get('tpot_p99_ms'))} |"
            )
        lines.append("")
        if az.get("recommendation") is not None:
            seeded = az.get("seeded_from")
            lines += [
                "| autosize | recommendation | evaluated | pruned "
                "| seeded from | frontier crc | recommendation crc |",
                "|---|" + "---|" * 6,
                f"| | {az['recommendation']} | {_fmt(az.get('evaluated'))} "
                f"| {_fmt(az.get('pruned'))} | {_fmt(seeded)} "
                f"| {_fmt(az.get('frontier_crc'))} "
                f"| {_fmt(az.get('recommendation_crc'))} |",
                "",
            ]
    if "chaos" in summary:
        # Chaos search (chaos/): one row per sampled episode,
        # then the search summary line (and the minimized repro plan
        # when the search failed).
        ch = summary["chaos"]
        lines += [
            "| chaos ep | axes | plan | faults | violations "
            "| replay ticks | episode crc |",
            "|---|" + "---|" * 6,
        ]
        for r in ch["rows"]:
            viol = r.get("violations") or []
            lines.append(
                f"| {_fmt(r.get('episode'))} | {_fmt(r.get('axes'))} "
                f"| `{r.get('plan') or '(none)'}` "
                f"| {_fmt(r.get('faults'))} "
                f"| {','.join(viol) if viol else 'ok'} "
                f"| {_fmt(r.get('replay_ticks'))} "
                f"| {_fmt(r.get('episode_crc'))} |"
            )
        lines.append("")
        if "episodes" in ch:
            lines += [
                "| chaos | episodes | violating | episodes crc "
                "| min plan | shrink probes |",
                "|---|" + "---|" * 5,
                f"| | {_fmt(ch.get('episodes'))} "
                f"| {_fmt(ch.get('violations'))} "
                f"| {_fmt(ch.get('episodes_crc'))} "
                f"| {'`' + ch['min_plan'] + '`' if ch.get('min_plan') else ''} "
                f"| {_fmt(ch.get('shrink_probes'))} |",
                "",
            ]
    if "alerts" in summary:
        al = summary["alerts"]
        lines += [
            "| alerts | by severity | by rule |",
            "|---|---|---|",
            f"| {al['count']} | {_fmt(al['by_severity'])} "
            f"| {_fmt(al['by_rule'])} |",
            "",
        ]
    if "robustness" in summary:
        rb = summary["robustness"]
        lines += [
            "| robustness | events | restarts | preempted "
            "| topology changes | non-finite steps "
            "| ckpt fallbacks | by kind |",
            "|---|---|---|---|---|---|---|---|",
            f"| | {rb['events']} | {rb['restarts']} "
            f"| {rb.get('preemptions', 0)} "
            f"| {rb.get('topology_changes', 0)} "
            f"| {rb['nonfinite_steps']} | {rb['checkpoint_fallbacks']} "
            f"| {_fmt(rb['by_kind'])} |",
            "",
        ]
        if rb.get("ckpt_events"):
            lines += [
                "| checkpoints | " + " | ".join(rb["ckpt_events"]) + " |",
                "|---|" + "---|" * len(rb["ckpt_events"]),
                "| | " + " | ".join(str(v) for v in
                                    rb["ckpt_events"].values()) + " |",
                "",
            ]
    if "fleet" in summary:
        fl = summary["fleet"]
        bk = fl["by_kind"]
        lines += [
            "| fleet | joins | crashes | restarts | circuit opens "
            "| leaves | last replicas | last pending |",
            "|---|---|---|---|---|---|---|---|",
            f"| | {bk.get('join', 0)} | {bk.get('crash', 0)} "
            f"| {bk.get('restart', 0)} | {bk.get('circuit_open', 0)} "
            f"| {bk.get('leave', 0)} | {_fmt(fl['replicas_last'])} "
            f"| {_fmt(fl['pending_last'])} |",
            "",
        ]
        if fl["by_replica"]:
            lines += ["| replica | lifecycle |", "|---|---|"]
            for name, per in fl["by_replica"].items():
                lines.append(f"| {name} | {_fmt(per)} |")
            lines.append("")
        if fl.get("route_last"):
            # Per-replica routing split: cumulative routed
            # hits / dispatches from the newest fleet record — where
            # the cache-aware wins actually landed.
            lines += ["| replica routing | routed hits | dispatches "
                      "| hit rate |", "|---|---|---|---|"]
            for name, pair in sorted(fl["route_last"].items()):
                hits, disp = (pair + [0, 0])[:2]
                rate = f"{100.0 * hits / disp:.1f}%" if disp else "—"
                lines.append(
                    f"| {name} | {_fmt(hits)} | {_fmt(disp)} | {rate} |")
            lines.append("")
    if "transport" in summary:
        # Lossy transport: bus message totals + lease
        # refusals — the exactly-once machinery's visible work.
        tr = summary["transport"]
        lines += [
            "| transport | sent | delivered | dropped | duped | delayed "
            "| deduped | retransmits | lease refused | partitions |",
            "|---|---|---|---|---|---|---|---|---|---|",
            f"| {'lease %st' % _fmt(tr.get('lease_ticks')) if tr.get('lease_ticks') else 'lease off'} "
            f"| {_fmt(tr.get('msgs_sent'))} "
            f"| {_fmt(tr.get('msgs_delivered'))} "
            f"| {_fmt(tr.get('msgs_dropped'))} "
            f"| {_fmt(tr.get('msgs_duped'))} "
            f"| {_fmt(tr.get('msgs_delayed'))} "
            f"| {_fmt(tr.get('msgs_deduped'))} "
            f"| {_fmt(tr.get('retransmits'))} "
            f"| {_fmt(tr.get('lease_refusals'))} "
            f"| {_fmt(tr.get('partitions'))} |",
        ]
        if tr.get("events"):
            lines.append("partition lifecycle: " + "  ".join(
                f"{k}:{v}" for k, v in tr["events"].items()))
        lines.append("")
    if "handoffs" in summary:
        # Disaggregated KV handoffs.
        ho = summary["handoffs"]
        st = ho["by_state"]
        lines += [
            "| handoffs | started | done | aborted | pages moved "
            "| aborts by reason |",
            "|---|---|---|---|---|---|",
            f"| | {st.get('started', 0)} | {st.get('done', 0)} "
            f"| {st.get('aborted', 0)} | {ho['pages']} "
            f"| {_fmt(ho['aborts_by_reason'])} |",
            "",
        ]
    if "serve" in summary:
        lines += [
            "| serve run | requests | tokens/s | decode ticks "
            "| prefill chunks | preempt | TTFT p99 ms | tok p99 ms "
            "| spec accept |",
            "|---|---|---|---|---|---|---|---|---|",
        ]
        for s in summary["serve"]:
            # Speculative acceptance rate: accepted draft
            # tokens / proposed, em-dash on spec-off runs.
            prop = s.get("spec_proposed") or 0
            acc = (f"{100.0 * (s.get('spec_accepted') or 0) / prop:.1f}%"
                   if prop else "—")
            lines.append(
                f"| {s['mode']} | {_fmt(s['requests'])} "
                f"| {_fmt(s['tokens_per_s'])} | {_fmt(s['decode_ticks'])} "
                f"| {_fmt(s['prefill_chunks'])} | {_fmt(s['preemptions'])} "
                f"| {_fmt(s['ttft_p99_ms'])} | {_fmt(s['tpot_p99_ms'])} "
                f"| {acc} |"
            )
        lines.append("")
        # Prefix-cache table: only for runs that did any
        # matching — an all-zero row on a sharing-off run is noise.
        pruns = [s for s in summary["serve"]
                 if (s.get("prefix_hits") or 0) + (s.get("prefix_misses")
                                                   or 0) > 0]
        if pruns:
            lines += [
                "| prefix cache | hits | misses | hit tokens | cow "
                "| evictions |",
                "|---|---|---|---|---|---|",
            ]
            for s in pruns:
                lines.append(
                    f"| {s['mode']} | {_fmt(s['prefix_hits'])} "
                    f"| {_fmt(s['prefix_misses'])} "
                    f"| {_fmt(s['prefix_hit_tokens'])} "
                    f"| {_fmt(s['prefix_cow'])} "
                    f"| {_fmt(s['prefix_evictions'])} |"
                )
            lines.append("")
        # Host-tier table: only for runs that ran WITH a
        # host tier (host_pages stamped nonzero) — spill-off runs stamp
        # all-zero tier counters and must not grow a table of dashes.
        truns = [s for s in summary["serve"] if s.get("host_pages")]
        if truns:
            lines += [
                "| host tier | host pages | spills | readmits "
                "| refusals | host evictions |",
                "|---|---|---|---|---|---|",
            ]
            for s in truns:
                lines.append(
                    f"| {s['mode']} | {_fmt(s['host_pages'])} "
                    f"| {_fmt(s['tier_spills'])} "
                    f"| {_fmt(s['tier_readmits'])} "
                    f"| {_fmt(s['tier_refusals'])} "
                    f"| {_fmt(s['tier_host_evictions'])} |"
                )
            lines.append("")
        # Cache-aware routing table: only for runs the
        # router actually scored (cache_aware dispatches counted) — a
        # hash-affinity run must not grow a table of zeros.
        rruns = [s for s in summary["serve"]
                 if (s.get("route_hits") or 0) + (s.get("route_misses")
                                                  or 0) > 0]
        if rruns:
            lines += [
                "| routing | policy | routed hits | misses "
                "| hit tokens | hit rate |",
                "|---|---|---|---|---|---|",
            ]
            for s in rruns:
                hits = s.get("route_hits") or 0
                total = hits + (s.get("route_misses") or 0)
                lines.append(
                    f"| {s['mode']} | {s.get('policy', '—')} "
                    f"| {_fmt(hits)} | {_fmt(s.get('route_misses'))} "
                    f"| {_fmt(s.get('route_hit_tokens'))} "
                    f"| {100.0 * hits / total:.1f}% |"
                )
            lines.append("")
        # Autoscale table: runs that scaled (or ran the
        # policy — an autoscaled run that never moved is information).
        aruns = [s for s in summary["serve"] if s.get("autoscale")]
        if aruns:
            lines += [
                "| autoscale | scale ups | scale downs | replica ticks "
                "| final replicas |",
                "|---|---|---|---|---|",
            ]
            for s in aruns:
                lines.append(
                    f"| {s['mode']} | {_fmt(s.get('scale_ups'))} "
                    f"| {_fmt(s.get('scale_downs'))} "
                    f"| {_fmt(s.get('replica_ticks'))} "
                    f"| {_fmt((summary.get('fleet') or {}).get('replicas_last'))} |"
                )
            lines.append("")
    if "metrics" in summary:
        # Runtime-registry snapshots: the p50/p95/p99 tables
        # the serving sections of PERF.md are made from, produced by
        # obs.metrics histograms instead of hand-assembled.
        lines += [
            "| runtime histogram | count | p50 | p95 | p99 | min | max |",
            "|---|---|---|---|---|---|---|",
        ]
        for label, m in summary["metrics"].items():
            for name, h in m["histograms"].items():
                lines.append(
                    f"| {label}: {name} | {h['count']} | {_fmt(h['p50'])} "
                    f"| {_fmt(h['p95'])} | {_fmt(h['p99'])} "
                    f"| {_fmt(h['min'])} | {_fmt(h['max'])} |"
                )
        lines.append("")
        for label, m in summary["metrics"].items():
            kv = {**m["counters"],
                  **{k: v for k, v in m["gauges"].items()
                     if v is not None}}
            if kv:
                lines.append(
                    f"Runtime totals [{label}]: "
                    + ", ".join(f"{k}={_fmt(v)}" for k, v in kv.items())
                )
        lines.append("")
    if "memory" in summary:
        m = summary["memory"]
        peak = m["hbm_peak_bytes"]
        peak_s = f"{peak / 2**20:.1f} MiB" if peak else "—"
        lines += [f"Device memory: peak {peak_s} "
                  f"({m['records']} snapshots)", ""]
    if "spans" in summary:
        lines += ["| span | count | total ms | mean ms |",
                  "|---|---|---|---|"]
        for name, s in summary["spans"].items():
            lines.append(
                f"| {name} | {s['count']} | {s['total_ms']:.4g} "
                f"| {s['mean_ms']:.4g} |"
            )
        lines.append("")
    return "\n".join(lines)


def report_main(argv: list[str] | None = None) -> int:
    """The `report` subcommand."""
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch report",
        description="Summarize a metrics JSONL run as markdown tables "
                    "(or JSON with --format json).",
    )
    ap.add_argument("paths", nargs="+", help="metrics JSONL file(s)")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    ap.add_argument("--merge", action="store_true",
                    help="merge every run segment of every file into ONE "
                         "report — a supervised run's pre/post-restart "
                         "segments (or a multi-file capture) render as "
                         "one table instead of one report per segment")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="the card's bf16 peak for the MFU column "
                         "(defaults to the H100 SXM's, obs/cost.py, when "
                         "records say backend=cuda)")
    args = ap.parse_args(argv)
    rc = 0
    per_path: list[tuple[str, list[list[dict]]]] = []
    for path in args.paths:
        try:
            # Per-run segments ('# run' markers from MetricsLogger's
            # append mode): aggregating across unrelated runs would pair
            # one run's FLOPs with another's step times — unless --merge
            # says the segments ARE one logical run (supervisor
            # restarts resume the same training).
            per_path.append((path, [r for r in iter_runs(path) if r]))
        except (OSError, ValueError) as e:
            print(f"error: {path}: {e}", file=sys.stderr)
            rc = 1
    if args.merge:
        # Tag each record with its run-segment ordinal: registry
        # snapshots are cumulative only WITHIN a process, so summarize
        # needs the segment boundary to fold counters across restarts
        # instead of letting the last segment's totals shadow the rest.
        segments = [records for _, runs in per_path for records in runs]
        merged = [dict(rec, _seg=seg)
                  for seg, records in enumerate(segments)
                  for rec in records]
        nseg = len(segments)
        summary = summarize(merged, peak_tflops=args.peak_tflops)
        label = (f"merged ({nseg} segment(s) from "
                 f"{len(per_path)} file(s))")
        if args.format == "json":
            print(json.dumps({"paths": [p for p, _ in per_path],
                              "segments": nseg, **summary}))
        else:
            print(render_markdown(summary, title=f"Run report — {label}"))
        return rc
    for path, runs in per_path:
        for i, records in enumerate(runs, 1):
            summary = summarize(records, peak_tflops=args.peak_tflops)
            label = path if len(runs) == 1 else f"{path} (run {i}/{len(runs)})"
            if args.format == "json":
                print(json.dumps(
                    {"path": path, "run": i, "runs": len(runs), **summary}
                ))
            else:
                print(render_markdown(summary, title=f"Run report — {label}"))
    return rc
