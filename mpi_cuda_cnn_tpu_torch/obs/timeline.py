"""Per-request trace timelines: `python -m mpi_cuda_cnn_tpu_torch trace RUN
[--request ID]` (counterpart of the reference's `obs/timeline.py`, the
same code and output).

The serving engine's tick records (one per scheduler iteration, with
its admissions, prefill chunk, decode set, preemptions and terminal
requests) and the per-request `request` records are a complete account
of a run. This module reconstructs each request's lifecycle from them:

    submit -> queued -> admit -> prefill chunks -> first token ->
    decode ticks -> (preempt -> requeue -> readmit -> re-prefill)* ->
    terminal status

and renders a per-slot tick Gantt (P = prefill chunk, D = decode,
. = idle) and a per-request latency breakdown (queued, prefilling,
decoding and preempted-waiting milliseconds).

Reconstruction is also a cross-check: the lifecycle derived from the
ticks must land every request in the terminal status its `request`
record claims, and its token account (one per completed prefill and
one per decode tick) must match `output_tokens`; `trace_main` exits
nonzero when any lifecycle is inconsistent.

Times are approximate to one tick (a tick record's "now" is stamped at
iteration end).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from .schema import fmt_cell as _fmt
from .schema import iter_runs


@dataclasses.dataclass
class Lifecycle:
    """One request's reconstructed history within one mode's run."""

    rid: int
    mode: str
    record: dict | None = None      # its `request` record, when present
    # (tick index, now, kind, detail) in tick order; kinds: admitted,
    # prefill, first_token, decode, preempted, finished, aborted.
    events: list[tuple] = dataclasses.field(default_factory=list)
    admissions: int = 0
    prefill_chunks: int = 0
    decode_ticks: int = 0
    preemptions: int = 0
    handoffs: int = 0
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0
    # Speculative decoding: rounds this request ran and
    # draft tokens its target accepted — a spec round's decode event
    # carries [slot, emitted] detail instead of the bare slot, which is
    # what keeps tokens_accounted exact under variable-length commits.
    spec_rounds: int = 0
    spec_accepted: int = 0
    # Host-tier readmissions: admissions whose device-tree
    # miss was served from the spilled host tier — the prefix_hit's
    # sibling marker (a readmitted chunk counts as a hit at bind, so
    # the hit marker still fires; this one says WHERE the pages came
    # from).
    tier_readmits: int = 0
    tier_readmit_tokens: int = 0
    derived_status: str | None = None
    terminal_now: float | None = None
    # Milliseconds spent per state, summed across segments.
    breakdown: dict = dataclasses.field(default_factory=dict)

    @property
    def tokens_accounted(self) -> int:
        """Tokens the tick trail accounts for: one at each completed
        prefill (the engine emits the first token at prefill
        completion, per readmission) + one per decode tick — except a
        SPECULATIVE decode round, whose [slot, emitted]
        detail carries the round's variable-length commit (1..k
        tokens). A fleet re-dispatch under the "discard" policy throws
        the dead replica's partial output away — the trail records the
        fact (a `redispatched` event with detail "discard", ordered
        BEFORE the new replica's first emission), so the account
        resets with it. Under "resume" the committed tokens carry over
        and the count just keeps accumulating across replicas."""
        n = 0
        for e in self.events:
            if e[2] == "first_token":
                n += 1
            elif e[2] == "decode":
                n += e[3][1] if isinstance(e[3], list) else 1
            elif e[2] == "redispatched":
                d = e[3]
                if isinstance(d, list):
                    # [policy, outlen]: reset to the
                    # authoritative committed count — discard throws
                    # everything away; resume replays from outlen, and
                    # any tokens the trail emitted past it were lost
                    # undelivered commits the new replica re-emits.
                    n = 0 if d[0] == "discard" else d[1]
                elif d == "discard":
                    n = 0
        return n

    @property
    def consistent(self) -> bool:
        """The reconstruction agrees with the request record: same
        terminal status, and (for requests that produced tokens) the
        tick-derived token count matches output_tokens."""
        if self.record is None:
            return False
        if self.derived_status != self.record.get("status", "finished"):
            return False
        return self.tokens_accounted == self.record.get("output_tokens", 0)

    def arrival_s(self) -> float | None:
        return self.record.get("arrival_s") if self.record else None


def reconstruct(records: list[dict]) -> dict[str, dict[int, Lifecycle]]:
    """Lifecycles per mode per rid from one run's records.

    Reads `tick` events (the per-iteration trail) and `request` events
    (the terminal claims being cross-checked). A file with request
    records but no tick records (older) yields lifecycles with
    record-only data and consistent=False — trace needs the trail.
    """
    out: dict[str, dict[int, Lifecycle]] = {}

    def life(mode: str, rid: int) -> Lifecycle:
        per = out.setdefault(mode, {})
        lc = per.get(rid)
        if lc is None:
            lc = per[rid] = Lifecycle(rid=rid, mode=mode)
        return lc

    for rec in records:
        ev = rec.get("event")
        if ev == "request":
            life(rec.get("mode", "?"), rec["id"]).record = rec
        elif ev == "fleet":
            # Router tick: a re-dispatch moves the request to
            # another replica. The marker lands between the old
            # replica's last record and the new one's first (the fleet
            # emits it before stepping replicas), so the lifecycle
            # stays ordered across the failover.
            tick, now = rec.get("tick"), rec.get("now")
            # redispatched_to carries the authoritative
            # committed-token count at failover — under the lossy bus
            # that can be SMALLER than the tokens the dead
            # replica's trail emitted (undelivered commits are lost and
            # re-emitted), so the token account resets to it.
            outls = {rid: outl
                     for rid, _n, outl in rec.get("redispatched_to") or []}
            for rid in rec.get("redispatched") or []:
                lc = life("fleet", rid)
                policy = rec.get("redispatch", "resume")
                lc.events.append((tick, now, "redispatched",
                                  [policy, outls.get(rid, 0)]
                                  if rid in outls else policy))
            # Lossy-transport lifecycle markers: a
            # retransmitted dispatch/commit/terminal for the rid, and a
            # commit the replica refused past its lease — display rows
            # that explain a wire gap in the surrounding segments.
            for kind, _dst, rid in rec.get("t_retransmits") or []:
                if rid >= 0:
                    life("fleet", rid).events.append(
                        (tick, now, "retransmit", kind))
            for rid, name in rec.get("lease_refused") or []:
                life("fleet", rid).events.append(
                    (tick, now, "lease_refused", name))
            # Cache-aware routing marker: the router placed
            # rid on `name` expecting `matched` hot prefix tokens —
            # ordered before the replica's first emission for the rid
            # (the fleet emits its record before stepping replicas),
            # so the marker explains the prefix_hit that follows.
            for rid, name, matched in rec.get("route_hits") or []:
                life("fleet", rid).events.append(
                    (tick, now, "routed", [name, matched]))
            # Disaggregated handoff markers: the fleet emits
            # its record before stepping replicas, so the phase
            # transition (handoff/handoff_done) is ordered BEFORE the
            # decode pool's first emission for the rid.
            for rid, src in rec.get("handoff_started") or []:
                lc = life("fleet", rid)
                lc.handoffs += 1
                lc.events.append((tick, now, "handoff", src))
            for rid, dst in rec.get("handoff_done") or []:
                life("fleet", rid).events.append(
                    (tick, now, "handoff_done", dst))
            for rid, why in rec.get("handoff_aborted") or []:
                life("fleet", rid).events.append(
                    (tick, now, "handoff_aborted", why))
        elif ev == "tick":
            mode = rec.get("mode", "?")
            if mode.startswith("fleet/"):
                # Per-replica trail of one fleet: all replicas fold
                # into the ONE logical mode "fleet" — a request's
                # lifecycle spans every replica that ever held it.
                mode = "fleet"
            tick, now = rec.get("tick"), rec.get("now")
            for slot, rid in rec.get("admitted") or []:
                lc = life(mode, rid)
                lc.admissions += 1
                lc.events.append((tick, now, "admitted", slot))
            for rid, matched in rec.get("prefix_hits") or []:
                # Prefix-cache hit: this admission shared
                # `matched` prompt tokens' pages and prefilled only the
                # suffix — the marker that explains a short prefill
                # segment in the breakdown.
                lc = life(mode, rid)
                lc.prefix_hits += 1
                lc.prefix_hit_tokens += matched
                lc.events.append((tick, now, "prefix_hit", matched))
            for rid, depth in rec.get("prefix_readmits") or []:
                # Host-tier readmission: the chunk ending at
                # `depth` prompt tokens came back from the spilled host
                # tier instead of re-prefilling — the marker that
                # explains a device-tree miss that still prefilled only
                # the suffix.
                lc = life(mode, rid)
                lc.tier_readmits += 1
                lc.tier_readmit_tokens = max(lc.tier_readmit_tokens,
                                             depth)
                lc.events.append((tick, now, "tier_readmit", depth))
            pf = rec.get("prefill")
            if pf:
                lc = life(mode, pf[1])
                lc.prefill_chunks += 1
                lc.events.append((tick, now, "prefill", pf[2]))
                if pf[-1] == "emit":
                    lc.events.append((tick, now, "first_token", None))
            # Speculative rounds: [rid, proposed, accepted]
            # per slot — the decode event's detail becomes
            # [slot, emitted] (= 1 + accepted) so the token account
            # stays exact, and the round itself is the trace's
            # spec-round marker.
            spec_acc = {e[0]: e[2] for e in rec.get("spec") or []}
            for slot, rid in rec.get("decoded") or []:
                lc = life(mode, rid)
                lc.decode_ticks += 1
                if rid in spec_acc:
                    lc.spec_rounds += 1
                    lc.spec_accepted += spec_acc[rid]
                    lc.events.append((tick, now, "decode",
                                      [slot, 1 + spec_acc[rid]]))
                else:
                    lc.events.append((tick, now, "decode", slot))
            for rid in rec.get("preempted") or []:
                lc = life(mode, rid)
                lc.preemptions += 1
                lc.events.append((tick, now, "preempted", None))
            for rid in rec.get("finished") or []:
                lc = life(mode, rid)
                lc.derived_status = "finished"
                lc.terminal_now = now
                lc.events.append((tick, now, "finished", None))
            for rid, status in rec.get("aborted") or []:
                lc = life(mode, rid)
                lc.derived_status = status
                lc.terminal_now = now
                lc.events.append((tick, now, "aborted", status))

    for per in out.values():
        for lc in per.values():
            _compute_breakdown(lc)
    return out


def _compute_breakdown(lc: Lifecycle) -> None:
    """Attribute the request's wall-clock to states by walking its
    events: queued (arrival -> first admit), prefilling (admit ->
    first token / last chunk), decoding, preempted-waiting (preempt ->
    readmit). Milliseconds, rounded; None arrival -> empty breakdown."""
    arrival = lc.arrival_s()
    if arrival is None or lc.terminal_now is None:
        return
    acc = {"queued_ms": 0.0, "prefill_ms": 0.0, "decode_ms": 0.0,
           "preempted_ms": 0.0, "handoff_ms": 0.0}
    state, since = "queued", arrival
    state_key = {"queued": "queued_ms", "prefill": "prefill_ms",
                 "decode": "decode_ms", "preempted": "preempted_ms",
                 "handoff": "handoff_ms"}
    for _tick, now, kind, _detail in lc.events:
        if kind == "admitted":
            acc[state_key[state]] += now - since
            state, since = "prefill", now
        elif kind == "first_token":
            acc[state_key[state]] += now - since
            state, since = "decode", now
        elif kind in ("preempted", "redispatched", "handoff_aborted"):
            # Crash failover is accounted like a preemption wait: the
            # request holds no slot between losing a replica and
            # readmission elsewhere. An aborted handoff enters the
            # same wait (its re-dispatch re-prefills).
            acc[state_key[state]] += now - since
            state, since = "preempted", now
        elif kind == "handoff":
            # Disaggregated phase transition: sealed in
            # flight between the pools.
            acc[state_key[state]] += now - since
            state, since = "handoff", now
        elif kind == "handoff_done":
            acc[state_key[state]] += now - since
            state, since = "decode", now
        elif kind in ("finished", "aborted"):
            acc[state_key[state]] += now - since
            since = now
    lc.breakdown = {k: round(1e3 * v, 3) for k, v in acc.items()}


# -- rendering ---------------------------------------------------------


def render_gantt(records: list[dict], mode: str, *, width: int = 96,
                 rid: int | None = None) -> str:
    """Per-slot tick Gantt for one mode: one row per engine slot, one
    column per tick (bucketed down to `width` columns for long runs).
    P = prefill chunk, D = decode, both = '#', idle = '.'. With `rid`,
    only that request's activity is drawn (its queue time shows as
    'q', preempted-waiting as 'x', on the row of the slot it next
    occupies). Mode "fleet" draws every replica's trail (tick modes
    "fleet/<name>") as replica-qualified rows ("r0:2" = replica r0,
    slot 2) — a re-dispatched request's activity visibly jumps rows at
    the failover."""
    ticks = [r for r in records if r.get("event") == "tick"
             and (r.get("mode", "?") == mode
                  or r.get("mode", "?").startswith(mode + "/"))]
    if not ticks:
        return "(no tick records)"
    n_ticks = max(t["tick"] for t in ticks) + 1

    def rkey(t: dict, slot: int) -> tuple[str, int]:
        # ("", slot) for the exact mode; ("r0", slot) for "fleet/r0".
        return (t.get("mode", "?")[len(mode) + 1:], slot)

    keys: set[tuple[str, int]] = set()
    for t in ticks:
        for s, _ in (t.get("admitted") or []):
            keys.add(rkey(t, s))
        for s, _ in (t.get("decoded") or []):
            keys.add(rkey(t, s))
        if t.get("prefill"):
            keys.add(rkey(t, t["prefill"][0]))
    if not keys:
        keys = {("", 0)}
    rows = sorted(keys)
    row_of = {k: i for i, k in enumerate(rows)}
    per_col = max(1, -(-n_ticks // width))  # ceil: ticks per column
    cols = -(-n_ticks // per_col)
    # grid[row][col] accumulates flags: 1 = prefill, 2 = decode.
    grid = [[0] * cols for _ in rows]
    for t in ticks:
        col = t["tick"] // per_col
        pf = t.get("prefill")
        if pf and (rid is None or pf[1] == rid):
            grid[row_of[rkey(t, pf[0])]][col] |= 1
        for s, r in (t.get("decoded") or []):
            if rid is None or r == rid:
                grid[row_of[rkey(t, s)]][col] |= 2
    if rid is not None:
        # Waiting intervals for the focused request, drawn on the row of
        # the slot it lands on NEXT: arrival -> first admission is queue
        # time (flag 4, 'q'), preemption -> readmission is preempted-
        # waiting (flag 8, 'x'). Activity flags win inside a bucketed
        # column; 'x' outranks 'q' (a requeue is the rarer signal).
        admits = [(t["tick"], row_of[rkey(t, s)]) for t in ticks
                  for s, r in (t.get("admitted") or []) if r == rid]
        req = next((r for r in records if r.get("event") == "request"
                    and r.get("id") == rid
                    and r.get("mode", "?") == mode), None)
        waits = []  # (start_tick, end_tick_exclusive, flag)
        if admits and req and req.get("arrival_s") is not None:
            arrive = next((t["tick"] for t in ticks
                           if t["now"] >= req["arrival_s"]), admits[0][0])
            waits.append((arrive, admits[0][0], 4))
        preempt_ticks = [t["tick"] for t in ticks
                         if rid in (t.get("preempted") or [])]
        for pt in preempt_ticks:
            readmit = next((a for a, _ in admits if a > pt), n_ticks)
            waits.append((pt, readmit, 8))
        for start, end, flag in waits:
            row = next((r for a, r in admits if a >= end),
                       admits[-1][1] if admits else 0)
            for tick in range(start, end):
                grid[row][tick // per_col] |= flag
    chars = {0: ".", 4: "q", 8: "x", 12: "x"}

    def cell(c: int) -> str:
        # Activity (P/D/#) beats waiting flags within a bucket.
        return {1: "P", 2: "D", 3: "#"}[c & 3] if c & 3 else chars[c]
    lines = [f"ticks 0..{n_ticks - 1}"
             + (f" ({per_col} ticks/column)" if per_col > 1 else "")
             + f" — mode {mode}"
             + (f", request {rid}" if rid is not None else "")]
    for (sub, s), row in zip(rows, grid):
        label = f"{sub}:{s}" if sub else f"slot {s:>2}"
        lines.append(f"{label:>7} |" + "".join(cell(c) for c in row))
    return "\n".join(lines)


def render_request_table(lifecycles: dict[int, Lifecycle]) -> str:
    lines = [
        "| rid | status | tenant | arrival s | queued ms | prefill ms "
        "| decode ms "
        "| preempt wait ms | handoff ms | preempts | chunks | dticks "
        "| pfx tok "
        "| tokens | ok |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for rid in sorted(lifecycles):
        lc = lifecycles[rid]
        b = lc.breakdown
        rec = lc.record or {}
        lines.append(
            f"| {rid} | {_fmt(lc.derived_status)} "
            f"| {rec.get('tenant', 'default')} | {_fmt(lc.arrival_s())} "
            f"| {_fmt(b.get('queued_ms'))} | {_fmt(b.get('prefill_ms'))} "
            f"| {_fmt(b.get('decode_ms'))} | {_fmt(b.get('preempted_ms'))} "
            f"| {_fmt(b.get('handoff_ms'))} "
            f"| {lc.preemptions} | {lc.prefill_chunks} | {lc.decode_ticks} "
            f"| {lc.prefix_hit_tokens} "
            f"| {lc.tokens_accounted}/{_fmt(rec.get('output_tokens'))} "
            f"| {'yes' if lc.consistent else 'NO'} |"
        )
    return "\n".join(lines)


def render_request_detail(lc: Lifecycle) -> str:
    rec = lc.record or {}
    head = [
        f"request {lc.rid} [{lc.mode}] — status {_fmt(lc.derived_status)} "
        f"(record: {_fmt(rec.get('status'))}), "
        f"prompt {_fmt(rec.get('prompt_tokens'))} tokens, "
        f"out {_fmt(rec.get('output_tokens'))} tokens, "
        f"ttft {_fmt(rec.get('ttft_ms'))} ms, "
        f"latency {_fmt(rec.get('latency_ms'))} ms",
        "breakdown: " + ", ".join(f"{k}={_fmt(v)}"
                                  for k, v in lc.breakdown.items()),
        f"arrival t={_fmt(lc.arrival_s())} s; lifecycle:",
    ]
    body = [
        f"  tick {tick:>5} t={now:.4f}s  {kind}"
        + (f" ({detail})" if detail is not None else "")
        for tick, now, kind, detail in lc.events
    ]
    return "\n".join(head + body)


def trace_main(argv: list[str] | None = None) -> int:
    """`trace RUN [--request ID]` — lifecycle reconstruction.

    Exits 1 when any reconstructed lifecycle disagrees with its
    request record (missing tick trail counts as disagreement): the
    engine and its telemetry drifting apart is a failure, not a
    rendering choice.
    """
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch trace",
        description="Reconstruct per-request lifecycles from a serving "
                    "run's metrics JSONL: per-slot tick Gantt + latency "
                    "breakdown (queued/prefill/decode/preempted).",
    )
    ap.add_argument("path", help="metrics JSONL with tick + request records")
    ap.add_argument("--request", type=int, default=None,
                    help="detail one request id instead of the summary")
    ap.add_argument("--slowest", type=int, default=None,
                    help="show only the N slowest requests, keyed on "
                         "recorded latency_ms (ttft_ms for requests "
                         "that never finished) — the same worst-k "
                         "selector `explain --worst` uses, with "
                         "latency as the key (explain --worst ttft/"
                         "tpot keys on those metrics)")
    ap.add_argument("--mode", default=None,
                    help="restrict to one scheduler mode "
                         "(default: every mode in the file)")
    ap.add_argument("--tenant", default=None,
                    help="restrict the request table and consistency "
                         "check to one tenant's requests ("
                         "untagged requests are tenant 'default'; the "
                         "Gantt still draws the whole schedule — slots "
                         "are shared)")
    ap.add_argument("--width", type=int, default=96,
                    help="Gantt width in columns (ticks are bucketed)")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    args = ap.parse_args(argv)

    try:
        runs = [r for r in iter_runs(args.path) if r]
    except (OSError, ValueError) as e:
        print(f"error: {args.path}: {e}", file=sys.stderr)
        return 2
    rc = 0
    for i, records in enumerate(runs, 1):
        by_mode = reconstruct(records)
        if args.mode is not None:
            by_mode = {m: v for m, v in by_mode.items() if m == args.mode}
        if not by_mode:
            continue
        label = args.path if len(runs) == 1 \
            else f"{args.path} (run {i}/{len(runs)})"
        for mode, lifecycles in sorted(by_mode.items()):
            if args.tenant is not None:
                lifecycles = {
                    rid: lc for rid, lc in lifecycles.items()
                    if (lc.record or {}).get("tenant", "default")
                    == args.tenant
                }
                if not lifecycles:
                    continue
            bad = [rid for rid, lc in lifecycles.items() if not lc.consistent]
            if args.slowest is not None and args.request is None:
                # Worst-k drill-down: the shared
                # selector, keyed on the request record's latency (ttft
                # as the fallback for aborted requests that emitted but
                # never finished). The consistency check above already
                # ran over EVERY lifecycle — drift is never hidden by
                # the display filter.
                from .causal import worst_k

                def _lat(lc):
                    rec = lc.record or {}
                    if rec.get("latency_ms") is not None:
                        return rec["latency_ms"]
                    return rec.get("ttft_ms")  # FakeClock latencies can be 0

                keep = worst_k(list(lifecycles.values()), _lat,
                               args.slowest)
                lifecycles = {lc.rid: lc for lc in keep}
                if not lifecycles:
                    continue
            if args.format == "json":
                print(json.dumps({
                    "path": args.path, "run": i, "mode": mode,
                    "requests": len(lifecycles),
                    "inconsistent": sorted(bad),
                    "statuses": _status_counts(lifecycles),
                    "lifecycles": {
                        str(rid): {
                            "status": lc.derived_status,
                            "breakdown": lc.breakdown,
                            "preemptions": lc.preemptions,
                            "handoffs": lc.handoffs,
                            "prefill_chunks": lc.prefill_chunks,
                            "decode_ticks": lc.decode_ticks,
                            "prefix_hits": lc.prefix_hits,
                            "prefix_hit_tokens": lc.prefix_hit_tokens,
                            "tier_readmits": lc.tier_readmits,
                            "spec_rounds": lc.spec_rounds,
                            "spec_accepted": lc.spec_accepted,
                            "tokens": lc.tokens_accounted,
                            "consistent": lc.consistent,
                        }
                        for rid, lc in sorted(lifecycles.items())
                    },
                }))
            elif args.request is not None:
                lc = lifecycles.get(args.request)
                if lc is None:
                    print(f"error: no request {args.request} in mode "
                          f"{mode} of {label}", file=sys.stderr)
                    rc = max(rc, 2)
                    continue
                print(f"## Trace — {label}\n")
                print(render_request_detail(lc))
                print()
                print(render_gantt(records, mode, width=args.width,
                                   rid=args.request))
                print()
            else:
                print(f"## Trace — {label} [{mode}]\n")
                print(render_gantt(records, mode, width=args.width))
                print()
                print(render_request_table(lifecycles))
                print()
            if bad:
                print(f"error: {len(bad)} request(s) with inconsistent "
                      f"lifecycles in mode {mode}: {sorted(bad)[:10]}",
                      file=sys.stderr)
                rc = max(rc, 1)
    return rc


def _status_counts(lifecycles: dict[int, Lifecycle]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for lc in lifecycles.values():
        st = lc.derived_status or "unknown"
        counts[st] = counts.get(st, 0) + 1
    return counts


if __name__ == "__main__":
    sys.exit(trace_main())
