"""Perf-regression gate: `python -m mpi_cuda_cnn_tpu_torch compare A B
[--gate thresholds.json]` (counterpart of the reference's
`obs/regress.py`, the same code and output).

- `extract_metrics(path)` flattens a run into {name: value}. It reads
  both shapes of run file: a metrics JSONL (obs.schema; the `serve`,
  `train`, `epoch`, `bench` and `metrics` records become
  "serve.continuous.tokens_per_s"-style names, from the last run of the
  file), and a capture JSON (`BENCH_r*.json`: one object whose "parsed"
  field holds {metric, value}).
- `compare(base, cand)` judges each gated metric in its direction
  (tokens/s up is good, ticks/ms down is good) against a per-metric
  tolerance; anything worse than tolerance is a REGRESSION and the
  command exits 1.
- With more than two files the LAST is the candidate and the best of
  the earlier ones in each metric's direction is the baseline.

Thresholds JSON (the files under `ci/`):

    {"default_tol_pct": 10,
     "metrics": {"serve.continuous.decode_ticks": {"tol_pct": 0},
                 "serve.continuous.tokens_per_s":
                     {"tol_pct": 10, "direction": "higher"},
                 "serve.fleet.trace_crc":
                     {"tol_pct": 0, "direction": "equal"}}}

Directions: "higher" (a drop regresses), "lower" (a rise regresses),
or "equal" (any drift regresses: the determinism gate's two-sided
form; never inferred from a name, only explicit).

With --gate only the listed metrics are gated (a listed metric missing
from either side fails loudly). Without --gate, every common metric
whose direction is inferable from its name is gated at 10%.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .schema import fmt_cell as _fmt
from .schema import iter_runs

DEFAULT_TOL_PCT = 10.0

# Direction inference by name fragment, first match wins. "higher"
# means bigger is better (a drop is a regression); "lower" the
# opposite. Metrics matching neither are informational-only unless a
# thresholds file names them with an explicit direction.
_HIGHER = ("tokens_per_s", "samples_per_s", "accuracy", "acc", "mfu",
           "speedup", "vs_baseline", "requests_finished")
_LOWER = ("_ms", "ticks", "chunks", "preemptions", "restarts", "loss",
          "ppl", "bytes", "nonfinite", "wallclock", "seconds",
          "watchdog", "requests_failed", "requests_expired",
          "requests_rejected", "alerts_fired")


def infer_direction(name: str) -> str | None:
    low = name.lower()
    for frag in _HIGHER:
        if frag in low:
            return "higher"
    for frag in _LOWER:
        if frag in low:
            return "lower"
    # A trailing "_s" is a duration (duration_s, epoch.last_s) — but
    # only as a suffix: "last_step" is not a time.
    if low.endswith("_s"):
        return "lower"
    return None


def _num(v) -> float | None:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


# serve-event keys worth gating (the engine summary's numeric columns,
# plus the fleet summary's structural counts — absent keys are skipped,
# so single-engine records don't grow phantom fleet metrics). The
# statuses dict is additionally flattened to serve.<mode>.status.<k>:
# the fleet determinism gate pins per-status totals at exact equality.
_SERVE_KEYS = ("tokens_per_s", "decode_ticks", "prefill_chunks",
               "preemptions", "output_tokens", "requests",
               "watchdog_slow_ticks", "ttft_p50_ms", "ttft_p99_ms",
               "tpot_p50_ms", "tpot_p99_ms", "duration_s",
               "fleet_ticks", "dispatches", "redispatches",
               "fenced_discards", "crashes", "joins", "leaves",
               "restarts", "circuit_opens", "replicas", "trace_crc",
               "alerts_fired", "alerts_crc",
               # Flight recorder: the per-tick state-digest
               # chain — the determinism gates pin it at 0%/equal, and
               # a failure's next step is `diverge A B`.
               "state_crc",
               # Prefix-sharing structural counters.
               "prefix_hits", "prefix_misses", "prefix_hit_tokens",
               "prefix_cow", "prefix_inserts", "prefix_evictions",
               # Causal-blame attribution: the canonical
               # per-request blame CRC plus per-category tick totals —
               # the fleet determinism gate pins them at exact equality.
               "blame_crc", "blame_self_compute", "blame_queued_behind",
               "blame_preempted_by", "blame_redispatch_replay",
               "blame_router_wait", "blame_quota_ticks",
               # Disaggregated serving: handoff / integrity
               # / degradation counters plus the handoff-wait blame
               # category — the disagg determinism gate pins them at
               # exact equality (zeros on a unified fleet).
               "blame_handoff_wait", "handoffs", "handoff_pages",
               "handoffs_aborted", "kv_refusals", "degraded_unified",
               # Batched speculative decoding: rounds run,
               # draft tokens proposed/accepted — the fleet/spec
               # determinism gates pin them at exact equality (zeros
               # on a spec-off run).
               "spec_rounds", "spec_proposed", "spec_accepted",
               # Host-tier KV spill: spill / readmission /
               # CRC-refusal / host-LRU-eviction counters — the
               # fleet/spec/disagg determinism gates pin them at exact
               # equality (zeros on a spill-off run).
               "tier_spills", "tier_readmits", "tier_refusals",
               "tier_host_evictions",
               # Cache-aware routing + autoscaling: routed-
               # dispatch counters, scale-event totals, the cumulative
               # live-replica integral, and the scale-event CRC chain —
               # the fleet/autoscale determinism gates pin them at
               # exact equality (zeros/empty-CRC on a hash-routed or
               # fixed-size fleet).
               "route_hits", "route_misses", "route_hit_tokens",
               "scale_ups", "scale_downs", "replica_ticks", "scale_crc",
               # Lossy transport: bus wire accounting,
               # lease refusals, partition count, and the transport-
               # wait blame category — the fleet/transport determinism
               # gates pin them at exact equality (zeros with the bus
               # off).
               "msgs_sent", "msgs_delivered", "msgs_dropped",
               "msgs_duped", "msgs_delayed", "msgs_deduped",
               "retransmits", "lease_refusals", "partitions",
               "blame_transport_wait")

# Per-tenant summary keys: the "tenants" block of a serve
# summary flattens to serve.<mode>.tenant.<name>.<key> (statuses to
# ...tenant.<name>.status.<k>), so an SLO-class gate can pin one
# tenant's p99 or finished count without gating the rest.
_TENANT_KEYS = ("requests", "output_tokens", "ttft_p50_ms", "ttft_p99_ms",
                "tpot_p50_ms", "tpot_p99_ms")


def metrics_from_records(records: list[dict]) -> dict[str, float]:
    """Flatten one run's records into {metric_name: value}; later
    records of the same name win (the run's final state)."""
    out: dict[str, float] = {}
    for rec in records:
        ev = rec.get("event")
        if ev == "serve":
            mode = rec.get("mode", "?")
            for k in _SERVE_KEYS:
                v = _num(rec.get(k))
                if v is not None:
                    out[f"serve.{mode}.{k}"] = v
            for k, v in (rec.get("statuses") or {}).items():
                v = _num(v)
                if v is not None:
                    out[f"serve.{mode}.status.{k}"] = v
            for tname, block in (rec.get("tenants") or {}).items():
                for k in _TENANT_KEYS:
                    v = _num(block.get(k))
                    if v is not None:
                        out[f"serve.{mode}.tenant.{tname}.{k}"] = v
                for k, v in (block.get("statuses") or {}).items():
                    v = _num(v)
                    if v is not None:
                        out[f"serve.{mode}.tenant.{tname}.status.{k}"] = v
        elif ev == "goodput":
            # Autosize sweep output: candidates flatten
            # under their candidate spelling, the frontier summary
            # under bare autosize.* — where the CI autosize determinism
            # gate pins frontier_crc / recommendation_crc / evaluated
            # at exact equality.
            kind = rec.get("kind")
            if kind == "candidate":
                cand = rec.get("cand", "?")
                for k, v in rec.items():
                    v = _num(v)
                    if v is not None and k not in ("schema", "t"):
                        out[f"autosize.{cand}.{k}"] = v
            elif kind == "frontier":
                for k, v in rec.items():
                    v = _num(v)
                    if v is not None and k not in ("schema", "t"):
                        out[f"autosize.{k}"] = v
            else:  # kind == "run": a single measured run's goodput
                for k, v in rec.items():
                    v = _num(v)
                    if v is not None and k not in ("schema", "t"):
                        out[f"goodput.{k}"] = v
        elif ev == "chaos":
            # Chaos-search output: per-episode records
            # flatten under their episode ordinal, the run summary
            # under bare chaos.* — where the CI chaos gate pins
            # episodes / violations / episodes_crc at exact equality.
            kind = rec.get("kind")
            if kind == "episode":
                ep = rec.get("episode", "?")
                out[f"chaos.ep{ep}.violations"] = float(
                    len(rec.get("violations") or []))
                for k, v in rec.items():
                    v = _num(v)
                    if v is not None and k not in ("schema", "t",
                                                   "episode"):
                        out[f"chaos.ep{ep}.{k}"] = v
            elif kind == "summary":
                out["chaos.failed"] = float(len(rec.get("failed") or []))
                for k, v in rec.items():
                    v = _num(v)
                    if v is not None and k not in ("schema", "t"):
                        out[f"chaos.{k}"] = v
        elif ev == "train":
            v = _num(rec.get("loss"))
            if v is not None:
                out["train.last_loss"] = v
            v = _num(rec.get("step"))
            if v is not None:
                out["train.last_step"] = v
        elif ev == "epoch":
            v = _num(rec.get("seconds"))
            if v is not None:
                out["epoch.last_s"] = v
        elif ev == "eval":
            for k, v in rec.items():
                v = _num(v)
                if v is not None and k not in ("schema", "t"):
                    out[f"eval.{k}"] = v
        elif ev == "bench":
            name, v = rec.get("metric"), _num(rec.get("value"))
            if name and v is not None:
                out[str(name)] = v
                # Secondary numeric fields ride along, namespaced under
                # the headline metric (same convention as the BENCH
                # capture branch below: e.g. decode_tokens_per_s
                # .plain_tokens_per_s).
                for k, sv in rec.items():
                    sv = _num(sv)
                    if sv is not None and k not in ("metric", "value",
                                                    "schema", "t"):
                        out[f"{name}.{k}"] = sv
        elif ev == "metrics":
            label = rec.get("mode", "train")
            for k, v in (rec.get("counters") or {}).items():
                v = _num(v)
                if v is not None:
                    out[f"metrics.{label}.{k}"] = v
            for k, g in (rec.get("gauges") or {}).items():
                v = _num((g or {}).get("value"))
                if v is not None:
                    out[f"metrics.{label}.{k}"] = v
    return out


def extract_metrics(path: str | Path) -> dict[str, float]:
    """Metrics from a file of either shape (capture JSON / run JSONL).

    A bench capture (BENCH_r*.json) is ONE json object spanning
    multiple lines — detected by parsing the whole file first. A run
    JSONL yields its LAST non-empty run (append-mode files accumulate;
    the newest run is the one being compared).
    """
    text = Path(path).read_text()
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        obj = None
    if isinstance(obj, dict):
        # Bench capture: {"parsed": {"metric", "value", ...}} — or a
        # bare {metric, value} object (bench.py's stdout line).
        parsed = obj.get("parsed") if isinstance(obj.get("parsed"), dict) \
            else obj
        out = {}
        name, v = parsed.get("metric"), _num(parsed.get("value"))
        if name and v is not None:
            out[str(name)] = v
            # Secondary numeric fields ride along, namespaced under the
            # headline metric (e.g. mnist_epoch_wallclock.vs_baseline).
            for k, sv in parsed.items():
                sv = _num(sv)
                if sv is not None and k not in ("metric", "value", "schema",
                                                "t", "n", "rc"):
                    out[f"{name}.{k}"] = sv
        return out
    runs = [r for r in iter_runs(path) if r]
    return metrics_from_records(runs[-1]) if runs else {}


def load_thresholds(path: str | Path) -> dict:
    spec = json.loads(Path(path).read_text())
    if not isinstance(spec.get("metrics"), dict) or not spec["metrics"]:
        raise ValueError(
            f"{path}: thresholds file needs a non-empty 'metrics' object"
        )
    return spec


def compare(base: dict[str, float], cand: dict[str, float],
            thresholds: dict | None = None) -> tuple[list[dict], list[str]]:
    """Evaluate candidate vs baseline; returns (rows, regressed names).

    With thresholds: exactly the listed metrics are gated (missing on
    either side = regression). Without: common metrics with inferable
    direction gate at DEFAULT_TOL_PCT; the rest are informational.
    """
    rows: list[dict] = []
    regressed: list[str] = []
    if thresholds is not None:
        default_tol = float(thresholds.get("default_tol_pct",
                                           DEFAULT_TOL_PCT))
        gated = thresholds["metrics"]
        names = sorted(set(gated) | (set(base) & set(cand)))
    else:
        default_tol = DEFAULT_TOL_PCT
        gated = None
        names = sorted(set(base) & set(cand))
    for name in names:
        spec = (gated or {}).get(name)
        a, b = base.get(name), cand.get(name)
        direction = (spec or {}).get("direction") or infer_direction(name)
        tol = float((spec or {}).get("tol_pct", default_tol))
        is_gated = spec is not None if gated is not None \
            else direction is not None
        row = {"metric": name, "base": a, "cand": b,
               "direction": direction, "tol_pct": tol if is_gated else None}
        if a is None or b is None:
            # A vanished metric needs no direction to fail the gate.
            if is_gated:
                row["verdict"] = "MISSING"
                regressed.append(name)
            else:
                row["verdict"] = "info"
            rows.append(row)
            continue
        if spec is not None and direction is None:
            # An explicitly gated, present metric that can't be
            # evaluated is a broken gate, not an info row — demoting it
            # silently is exactly the gate rot this module exists to
            # prevent.
            raise ValueError(
                f"gate metric {name!r}: direction neither specified nor "
                'inferable from the name — add "direction": "higher", '
                '"lower", or "equal" to its thresholds entry'
            )
        delta_pct = (b - a) / abs(a) * 100.0 if a else \
            (0.0 if b == a else float("inf") * (1 if b > a else -1))
        row["delta_pct"] = round(delta_pct, 3) if delta_pct == delta_pct \
            and abs(delta_pct) != float("inf") else delta_pct
        if not is_gated or direction is None:
            row["verdict"] = "info"
        else:
            # "equal" is the determinism direction: ANY drift
            # past tolerance regresses, both ways — two identical-seed
            # fleet runs must match their structural counts exactly, and
            # a one-sided gate would wave through half of all drifts
            # (a trace-crc change moves in a random direction).
            if direction == "equal":
                worse = abs(delta_pct) > tol
            else:
                worse = delta_pct < -tol if direction == "higher" \
                    else delta_pct > tol
            row["verdict"] = "REGRESS" if worse else "ok"
            if worse:
                regressed.append(name)
        rows.append(row)
    return rows, regressed


def render_table(rows: list[dict], base_label: str, cand_label: str) -> str:
    lines = [
        f"| metric | {base_label} | {cand_label} | Δ% | dir | tol% "
        "| verdict |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['metric']} | {_fmt(r['base'])} | {_fmt(r['cand'])} "
            f"| {_fmt(r.get('delta_pct'))} | {_fmt(r['direction'])} "
            f"| {_fmt(r['tol_pct'])} | {r['verdict']} |"
        )
    return "\n".join(lines)


def best_of(metric_sets: list[dict[str, float]]) -> dict[str, float]:
    """Directional best per metric across files — the trajectory
    baseline (unknown-direction metrics take the LAST occurrence)."""
    out: dict[str, float] = {}
    for ms in metric_sets:
        for name, v in ms.items():
            if name not in out:
                out[name] = v
                continue
            d = infer_direction(name)
            if d == "higher":
                out[name] = max(out[name], v)
            elif d == "lower":
                out[name] = min(out[name], v)
            else:
                out[name] = v
    return out


def _has_tick_trail(path: str | Path) -> bool:
    """Whether a run file carries per-tick records (cheap textual scan
    with early exit — the hint below must not re-parse a storm file)."""
    try:
        with Path(path).open() as fh:
            for line in fh:
                if '"event": "tick"' in line or '"event": "fleet"' in line:
                    return True
    except OSError:
        return False
    return False


def _print_diverge_hint(paths: list[str], rows: list[dict],
                        regressed: list[str]) -> None:
    """Determinism-failure next step: when a gated *_crc /
    equal-direction metric regressed between exactly two runs that both
    carry tick trails, name the exact `diverge` invocation that
    localizes the first divergent tick."""
    if len(paths) != 2:
        return
    bad = {r["metric"] for r in rows if r.get("verdict") == "REGRESS"
           and (r.get("direction") == "equal"
                or r["metric"].endswith("_crc"))}
    if not (bad & set(regressed)):
        return
    if _has_tick_trail(paths[0]) and _has_tick_trail(paths[1]):
        print(f"hint: determinism metric(s) drifted "
              f"({', '.join(sorted(bad & set(regressed)))}) and both "
              "runs carry tick trails — localize the first divergent "
              f"tick with:\n  python -m mpi_cuda_cnn_tpu_torch diverge "
              f"{paths[0]} {paths[1]}",
              file=sys.stderr)
    else:
        print("hint: determinism metric(s) drifted "
              f"({', '.join(sorted(bad & set(regressed)))}) — re-run "
              "both storms with --log full and localize the first "
              "divergent tick with `python -m mpi_cuda_cnn_tpu_torch "
              "diverge A B`", file=sys.stderr)


def compare_main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch compare",
        description="Compare run files (metrics JSONL or BENCH_r*.json "
                    "bench captures) on named metrics; exit 1 on "
                    "regression past per-metric tolerance.",
    )
    ap.add_argument("paths", nargs="+",
                    help="2 files: baseline candidate; 3+: trajectory "
                         "(last = candidate, best-of-earlier = baseline)")
    ap.add_argument("--gate", default=None,
                    help="thresholds JSON: gate exactly these metrics "
                         "with per-metric tol_pct/direction")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    args = ap.parse_args(argv)
    if len(args.paths) < 2:
        print("error: need at least two files to compare", file=sys.stderr)
        return 2
    try:
        sets = [extract_metrics(p) for p in args.paths]
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    thresholds = None
    if args.gate:
        try:
            thresholds = load_thresholds(args.gate)
        except (OSError, ValueError) as e:
            print(f"error: {args.gate}: {e}", file=sys.stderr)
            return 2
    if len(sets) == 2:
        base, base_label = sets[0], args.paths[0]
    else:
        base = best_of(sets[:-1])
        base_label = f"best of {len(sets) - 1} earlier"
    cand, cand_label = sets[-1], args.paths[-1]
    try:
        rows, regressed = compare(base, cand, thresholds)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps({"base": base_label, "cand": cand_label,
                          "regressed": regressed, "rows": rows}))
    else:
        print(render_table(rows, base_label, cand_label))
        print()
    if regressed:
        print(f"REGRESSION: {len(regressed)} metric(s) worse than "
              f"tolerance: {', '.join(regressed)}", file=sys.stderr)
        _print_diverge_hint(args.paths, rows, regressed)
        return 1
    n_ok = sum(1 for r in rows if r["verdict"] == "ok")
    if n_ok == 0:
        # Nothing was actually gated (e.g. two files sharing no metric
        # with an inferable direction): exiting 0 would let a gate run
        # vacuously green forever.
        print("error: no metric was gated — nothing was compared",
              file=sys.stderr)
        return 2
    print(f"ok: {n_ok} gated metric(s) within tolerance", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(compare_main())
