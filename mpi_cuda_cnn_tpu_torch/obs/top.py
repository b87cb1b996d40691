"""A terminal dashboard over a metrics JSONL: `python -m
mpi_cuda_cnn_tpu_torch top RUN` (counterpart of the reference's
`obs/top.py`, the same code and frames, headed `mctpu top` as the
reference's are).

Tails a run file while a bench or trainer writes it, or replays a
finished one, and renders the engine and trainer gauges: queue depth
with a sparkline of its recent history, running and prefilling slots,
free pages, the prefill backlog, counter totals, the latency
percentiles of the newest `metrics` snapshot, and the router, scale,
transport, blocker and alert panels. It imports only obs.schema,
obs.metrics and obs.alerts, so it runs while the trainer owns the card.

Modes:
- default: follow: re-read appended records every --refresh seconds
  and redraw in place; Ctrl-C exits.
- --once:  ingest the whole file, print one frame without ANSI control
  codes, exit.
- --replay: step through a finished file frame by frame at --refresh
  per frame.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import deque
from pathlib import Path

from .alerts import format_alert
from .metrics import percentiles_from_record
from .schema import RUN_MARKER, fmt_cell, validate_record

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 24) -> str:
    """Last `width` values as block characters, scaled to their max."""
    vals = list(values)[-width:]
    if not vals:
        return ""
    hi = max(max(vals), 1e-9)
    return "".join(_SPARK[min(int(v / hi * (len(_SPARK) - 1)), 7)]
                   for v in vals)


def bar(value, hi, width: int = 16) -> str:
    """A [####....] gauge bar of value against its running max."""
    if value is None:
        return " " * (width + 2)
    hi = max(hi if hi else value, value, 1e-9)
    n = int(round(value / hi * width))
    return "[" + "#" * n + "." * (width - n) + "]"


class TopState:
    """Aggregated view of the records seen so far (one run)."""

    def __init__(self, history: int = 48):
        self.records = 0
        self.t = 0.0
        self.metrics: dict[str, dict] = {}   # newest snapshot per label
        self.tick: dict[str, dict] = {}      # newest tick per mode
        self.queue_hist: dict[str, deque] = {}
        self.train: dict | None = None
        self.epochs = 0
        self.epoch_s = None
        self.serve: dict[str, dict] = {}
        self.faults: dict[str, int] = {}
        self.fleet: dict | None = None       # newest fleet-router tick
        self.pending_hist: deque = deque(maxlen=history)
        self.replica_kinds: dict[str, int] = {}
        # ROUTER panel: newest per-replica cumulative
        # [routed hits, dispatches] split (cache_aware fleet records
        # only) and the live-replica-count trail the scale-event
        # sparkline renders from.
        self.route: dict[str, list] | None = None
        self.replicas_hist: deque = deque(maxlen=history)
        # Alert stream: rolling recent window + per-rule and
        # per-severity totals for the ALERTS panel.
        self.alerts_recent: deque = deque(maxlen=6)
        self.alerts_total = 0
        self.alerts_by_rule: dict[str, int] = {}
        self.alerts_by_sev: dict[str, int] = {}
        # Per-replica free-pages high-water (an empty replica's free
        # count = its pool size): the fixed scale its pressure bar
        # renders against.
        self.free_hi: dict[str, float] = {}
        # Host-tier occupancy high-water per mode: the scale
        # the host-tier bar renders against until the serve record's
        # host_pages stamp gives the true capacity.
        self.tier_hi: dict[str, float] = {}
        # TOP-BLOCKERS: ticks each holder rid kept a blocked
        # admission waiting (joint attribution over the tick records'
        # `blocked` entries), plus the block-reason mix.
        self.blockers: dict[int, int] = {}
        self.block_reasons: dict[str, int] = {}
        # GOODPUT: autosize sweep candidates in arrival
        # order, plus the newest frontier summary record.
        self.goodput_cands: deque = deque(maxlen=8)
        self.goodput_frontier: dict | None = None
        # TRANSPORT panel: newest per-tick bus block from
        # the fleet records (cumulative counters + live partitions),
        # running lease-refusal/retransmit-marker totals, and the
        # partition open/heal lifecycle counts.
        self.transport: dict | None = None
        self.lease_refused = 0
        self.transport_kinds: dict[str, int] = {}
        self._history = history

    def reset(self) -> None:
        self.__init__(self._history)

    def ingest(self, rec: dict) -> None:
        self.records += 1
        self.t = max(self.t, rec.get("t", 0.0) or 0.0)
        ev = rec.get("event")
        if ev == "metrics":
            self.metrics[rec.get("mode", "train")] = rec
        elif ev == "tick":
            mode = rec.get("mode", "?")
            self.tick[mode] = rec
            self.queue_hist.setdefault(
                mode, deque(maxlen=self._history)
            ).append(rec.get("queue", 0))
            hu = (rec.get("prefix") or {}).get("host_used")
            if hu is not None:
                self.tier_hi[mode] = max(self.tier_hi.get(mode, 0.0), hu)
            for entry in rec.get("blocked") or []:
                rid, reason, holders = entry[0], entry[1], entry[2]
                self.block_reasons[reason] = \
                    self.block_reasons.get(reason, 0) + 1
                for h in holders:
                    self.blockers[h] = self.blockers.get(h, 0) + 1
        elif ev == "train":
            self.train = rec
        elif ev == "epoch":
            self.epochs += 1
            self.epoch_s = rec.get("seconds")
        elif ev == "serve":
            self.serve[rec.get("mode", "?")] = rec
        elif ev == "fault":
            kind = rec.get("kind", "?")
            self.faults[kind] = self.faults.get(kind, 0) + 1
        elif ev == "fleet":
            self.fleet = rec
            self.pending_hist.append(rec.get("pending", 0))
            self.replicas_hist.append(rec.get("replicas", 0))
            if rec.get("transport") is not None:
                self.transport = rec["transport"]
            self.lease_refused += len(rec.get("lease_refused") or [])
            if rec.get("route") is not None:
                self.route = rec["route"]
            for name, triple in (rec.get("load") or {}).items():
                free = (triple + [None, None, None])[2]
                if free is not None:
                    self.free_hi[name] = max(self.free_hi.get(name, 0.0),
                                             free)
        elif ev == "replica":
            kind = rec.get("kind", "?")
            self.replica_kinds[kind] = self.replica_kinds.get(kind, 0) + 1
        elif ev == "transport":
            kind = rec.get("kind", "?")
            self.transport_kinds[kind] = \
                self.transport_kinds.get(kind, 0) + 1
        elif ev == "goodput":
            if rec.get("kind") == "frontier":
                self.goodput_frontier = rec
            else:  # candidate / run measurements stream in live
                self.goodput_cands.append(rec)
        elif ev == "alert":
            self.alerts_total += 1
            self.alerts_recent.append(rec)
            rule = rec.get("rule", "?")
            sev = rec.get("severity", "?")
            self.alerts_by_rule[rule] = self.alerts_by_rule.get(rule, 0) + 1
            self.alerts_by_sev[sev] = self.alerts_by_sev.get(sev, 0) + 1


def _fmt(v) -> str:
    # 4 significant digits, not the tables' 6 — a refreshing dashboard
    # column must not jitter in width.
    return fmt_cell(v, prec=4)


def _pcts(snap: dict, name: str) -> str:
    p = percentiles_from_record(snap, name)
    if p["p50"] is None:
        return "—"
    return "/".join(_fmt(p[k]) for k in ("p50", "p95", "p99"))


def render(state: TopState, path: str, width: int = 96) -> str:
    """One dashboard frame (pure string — no ANSI; callers position)."""
    lines = [f"mctpu top — {path}  records={state.records}  "
             f"t={state.t:.2f}s"]
    for mode in sorted(set(state.tick) | set(m for m in state.metrics
                                             if m != "train")):
        if mode == "fleet" or mode.startswith("fleet/"):
            continue  # fleet + per-replica ticks render in FLEET below
        tk = state.tick.get(mode, {})
        snap = state.metrics.get(mode, {})
        counters = snap.get("counters", {})
        gauges = snap.get("gauges", {})
        free = tk.get("free_pages")
        free_hi = (gauges.get("serve.free_pages") or {}).get("hi")
        lines.append("")
        lines.append(
            f"ENGINE [{mode}]  tick {_fmt(tk.get('tick'))}  "
            f"queue {_fmt(tk.get('queue')):>4} "
            f"{sparkline(state.queue_hist.get(mode, []))}"
        )
        lines.append(
            f"  running {_fmt(tk.get('running'))}  "
            f"prefilling {_fmt(tk.get('prefilling'))}  "
            f"free pages {_fmt(free)} {bar(free, free_hi)}  "
            f"backlog {_fmt(tk.get('backlog'))} tok"
        )
        # Always-on health counts: a zero is information (nothing
        # preempted, no slow ticks).
        lines.append(
            f"  preemptions {_fmt(counters.get('serve.preemptions', 0))}  "
            "watchdog-slow "
            f"{_fmt(counters.get('serve.watchdog_slow_ticks', 0))}"
        )
        pfx = tk.get("prefix")
        if pfx:
            # Prefix-cache panel: hit/COW/evict totals plus
            # shared / LRU-retained / free page bars — the residency
            # picture behind the hit rate.
            total = pfx.get("hits", 0) + pfx.get("misses", 0)
            rate = pfx.get("hits", 0) / total if total else 0.0
            pool_hi = (gauges.get("serve.free_pages") or {}).get("hi")
            lines.append(
                f"  prefix: hit rate {rate:.0%} "
                f"({_fmt(pfx.get('hit_tokens'))} tok)  "
                f"cow {_fmt(pfx.get('cow_copies'))}  "
                f"evict {_fmt(pfx.get('evictions'))}  "
                f"shared {_fmt(pfx.get('shared_pages'))} "
                f"{bar(pfx.get('shared_pages'), pool_hi, width=8)} "
                f"lru {_fmt(pfx.get('retained_pages'))} "
                f"{bar(pfx.get('retained_pages'), pool_hi, width=8)} "
                f"free {_fmt(free)} {bar(free, pool_hi, width=8)}"
            )
        if pfx and "host_used" in pfx:
            # Host-tier panel: spilled-page occupancy bar
            # against the tier capacity (the serve record's host_pages
            # stamp, or the running high-water while the run is live)
            # plus the spill/readmit/refusal/eviction totals.
            cap = ((state.serve.get(mode) or {}).get("host_pages")
                   or state.tier_hi.get(mode))
            lines.append(
                f"  host tier: used {_fmt(pfx.get('host_used'))} "
                f"{bar(pfx.get('host_used'), cap, width=10)}  "
                f"spill {_fmt(pfx.get('spills'))}  "
                f"readmit {_fmt(pfx.get('readmits'))}  "
                f"refused {_fmt(pfx.get('refusals'))}  "
                f"host-evict {_fmt(pfx.get('host_evictions'))}"
            )
        if counters:
            lines.append(
                "  totals: "
                + "  ".join(
                    f"{k.removeprefix('serve.')} {_fmt(v)}"
                    for k, v in counters.items()
                    if k.startswith("serve.")
                )
            )
        if snap.get("histograms"):
            lines.append(
                f"  ms p50/p95/p99 — ttft {_pcts(snap, 'serve.ttft_ms')}"
                f"  tpot {_pcts(snap, 'serve.tpot_ms')}"
                f"  queue-wait {_pcts(snap, 'serve.queue_wait_ms')}"
            )
        sv = state.serve.get(mode)
        if sv:
            lines.append(
                f"  final: {_fmt(sv.get('tokens_per_s'))} tok/s  "
                f"ticks {_fmt(sv.get('decode_ticks'))}  "
                f"preempt {_fmt(sv.get('preemptions'))}  "
                f"wd-slow {_fmt(sv.get('watchdog_slow_ticks'))}  "
                f"statuses {json.dumps(sv.get('statuses'))}"
            )
    if state.fleet is not None or state.replica_kinds:
        fl = state.fleet or {}
        lines.append("")
        lines.append(
            f"FLEET  tick {_fmt(fl.get('tick'))}  "
            f"replicas {_fmt(fl.get('replicas'))}  "
            f"pending {_fmt(fl.get('pending')):>5} "
            f"{sparkline(state.pending_hist)}"
            # Disaggregated serving: KV transfers in flight.
            + (f"  handoffs-inflight {fl['handoffs_inflight']}"
               if fl.get("handoffs_inflight") is not None else "")
        )
        # Per-replica load rows: what least-loaded dispatch reads —
        # queue depth, occupied slots, free pages — plus each replica's
        # recent queue sparkline from its own tick trail.
        load = fl.get("load") or {}
        for name in sorted(load):
            q, running, free = (load[name] + [None, None, None])[:3]
            hist = state.queue_hist.get(f"fleet/{name}", [])
            lines.append(
                f"  {name:<4} queue {_fmt(q):>4} {sparkline(hist, 16):<16} "
                f"running {_fmt(running)}  free pages {_fmt(free)} "
                f"{bar(free, state.free_hi.get(name), width=10)}"
            )
        if state.replica_kinds:
            lines.append("  lifecycle: " + "  ".join(
                f"{k}:{v}" for k, v in sorted(state.replica_kinds.items())))
        if state.route is not None:
            # ROUTER panel: per-replica routed-hit-rate bars
            # (cumulative routed hits / dispatches — where cache-aware
            # scoring is landing its overlap wins) plus the scale-event
            # trail: live replica count sparkline + applied up/down
            # totals from the lifecycle stream.
            sv = state.serve.get("fleet") or {}
            rh, rm = sv.get("route_hits"), sv.get("route_misses")
            tot = (rh or 0) + (rm or 0)
            lines.append(
                "  ROUTER  "
                + (f"routed {rh}/{tot} ({100.0 * rh / tot:.0f}%)  "
                   f"hit tokens {_fmt(sv.get('route_hit_tokens'))}"
                   if tot else "routing live")
            )
            for name in sorted(state.route):
                hits, disp = (state.route[name] + [0, 0])[:2]
                frac = hits / disp if disp else 0.0
                lines.append(
                    f"    {name:<4} hits {_fmt(hits):>5}/{_fmt(disp):<5} "
                    f"{bar(frac, 1.0, width=16)} {frac:.0%}"
                )
            ups = state.replica_kinds.get("scale_up", 0)
            downs = state.replica_kinds.get("scale_down", 0)
            if ups or downs or len(state.replicas_hist) > 1:
                lines.append(
                    f"  SCALE  ups {ups}  downs {downs}  replicas "
                    f"{sparkline(state.replicas_hist)} "
                    f"now {_fmt(fl.get('replicas'))}"
                )
        sv0 = state.serve.get("fleet") or {}
        if state.transport is not None or sv0.get("msgs_sent") is not None:
            # TRANSPORT panel: the lossy bus live — per-tick
            # cumulative counters from the fleet records (full log),
            # falling back to the run summary's msgs_* totals.
            t = state.transport or {
                "sent": sv0.get("msgs_sent"),
                "delivered": sv0.get("msgs_delivered"),
                "dropped": sv0.get("msgs_dropped"),
                "duped": sv0.get("msgs_duped"),
                "deduped": sv0.get("msgs_deduped"),
                "retransmits": sv0.get("retransmits"),
                "partitions": sv0.get("partitions"),
                "inflight": 0, "unacked": 0, "links": [],
                "partitioned": [],
            }
            lines.append(
                f"  TRANSPORT  sent {_fmt(t['sent'])}  "
                f"delivered {_fmt(t['delivered'])}  "
                f"dropped {_fmt(t['dropped'])}  duped {_fmt(t['duped'])}  "
                f"deduped {_fmt(t['deduped'])}  "
                f"retransmits {_fmt(t['retransmits'])}"
            )
            open_p = t.get("partitioned") or []
            lines.append(
                f"    wire inflight {_fmt(t['inflight'])}  "
                f"unacked {_fmt(t['unacked'])}  "
                f"links {len(t.get('links') or [])}  "
                f"partitions {_fmt(t['partitions'])}"
                + ("  OPEN: " + ", ".join(f"{n} heals@{u}"
                                          for n, u in open_p)
                   if open_p else "")
                + f"  lease refused "
                  f"{state.lease_refused or sv0.get('lease_refusals') or 0}"
            )
            if state.transport_kinds:
                lines.append("    lifecycle: " + "  ".join(
                    f"{k}:{v}"
                    for k, v in sorted(state.transport_kinds.items())))
        snap = state.metrics.get("fleet", {})
        if snap.get("counters"):
            lines.append(
                "  totals: "
                + "  ".join(
                    f"{k.removeprefix('fleet.')} {_fmt(v)}"
                    for k, v in snap["counters"].items()
                    if k.startswith("fleet.")
                )
            )
        if snap.get("histograms"):
            lines.append(
                f"  ms p50/p95/p99 — ttft {_pcts(snap, 'serve.ttft_ms')}"
                f"  tpot {_pcts(snap, 'serve.tpot_ms')}"
                f"  queue-wait {_pcts(snap, 'serve.queue_wait_ms')}"
            )
        sv = state.serve.get("fleet")
        if sv:
            lines.append(
                f"  final: {_fmt(sv.get('tokens_per_s'))} tok/s  "
                f"dispatches {_fmt(sv.get('dispatches'))}  "
                f"redispatches {_fmt(sv.get('redispatches'))}  "
                f"fenced {_fmt(sv.get('fenced_discards'))}  "
                f"statuses {json.dumps(sv.get('statuses'))}"
            )
    if state.goodput_cands or state.goodput_frontier:
        # GOODPUT: the autosize sweep as it streams — most
        # recent candidates with their SLO-attained per-chip rate, then
        # the frontier's recommendation once the sweep folds.
        lines.append("")
        fr = state.goodput_frontier or {}
        lines.append(
            "GOODPUT  evaluated "
            f"{_fmt(fr.get('evaluated', len(state.goodput_cands)))}"
            + (f"  pruned {_fmt(fr['pruned'])}" if fr.get("pruned")
               else "")
            + (f"  seeded {fr['seeded_from']}" if fr.get("seeded_from")
               else "")
        )
        for r in state.goodput_cands:
            est = " est" if r.get("estimated") else ""
            lines.append(
                f"  {r.get('cand', 'run'):<36} "
                f"good {_fmt(r.get('good')):>5}/{_fmt(r.get('requests'))}"
                f"  {_fmt(r.get('per_chip_rps'))} r/s/chip{est}  "
                f"ttft p99 {_fmt(r.get('ttft_p99_ms'))}  "
                f"tpot p99 {_fmt(r.get('tpot_p99_ms'))}"
            )
        if fr.get("recommendation"):
            lines.append(
                f"  ➤ recommend {fr['recommendation']}  "
                f"{_fmt(fr.get('best_per_chip_rps'))} good r/s/chip  "
                f"crc {_fmt(fr.get('recommendation_crc'))}"
            )
    snap = state.metrics.get("train")
    if state.train or snap or state.epochs:
        tr = state.train or {}
        lines.append("")
        lines.append(
            f"TRAIN  step {_fmt(tr.get('step'))}  "
            f"loss {_fmt(tr.get('loss'))}  epochs {state.epochs}"
            + (f"  last epoch {_fmt(state.epoch_s)}s" if state.epoch_s
               else "")
        )
        if snap:
            c, g = snap.get("counters", {}), snap.get("gauges", {})
            tps = (g.get("train.tokens_per_s") or {}).get("value")
            lines.append(
                f"  heartbeats {_fmt(c.get('train.heartbeats'))}  "
                f"restarts {_fmt(c.get('train.restarts'))}  "
                f"steps {_fmt(c.get('train.steps'))}"
                + (f"  tokens/s {_fmt(tps)}" if tps is not None else "")
            )
            if snap.get("histograms"):
                lines.append(
                    f"  step ms p50/p95/p99 {_pcts(snap, 'train.step_ms')}"
                )
    if state.blockers:
        # TOP-BLOCKERS: who is holding admissions up RIGHT
        # NOW — the live twin of `explain`'s blocker table.
        top = sorted(state.blockers.items(),
                     key=lambda kv: (-kv[1], kv[0]))[:8]
        lines.append("")
        lines.append(
            "TOP BLOCKERS  blocked-attempt ticks by holder — "
            + "  ".join(f"rid {rid}:{n}" for rid, n in top)
        )
        lines.append("  reasons: " + "  ".join(
            f"{k}:{v}" for k, v in sorted(state.block_reasons.items())))
    if state.alerts_total:
        # ALERTS panel: totals plus the rolling tail — the
        # live view of what the streaming rule engine fired so far.
        lines.append("")
        lines.append(
            f"ALERTS  fired {state.alerts_total}  "
            + "  ".join(f"{k}:{v}"
                        for k, v in sorted(state.alerts_by_sev.items()))
        )
        lines.append("  rules: " + "  ".join(
            f"{k}:{v}" for k, v in sorted(state.alerts_by_rule.items())))
        for a in state.alerts_recent:
            # ONE alert-line spelling, shared with `health`
            # (obs.alerts.format_alert).
            lines.append("  " + format_alert(a))
    if state.faults:
        lines.append("")
        lines.append("FAULTS  " + "  ".join(
            f"{k}:{v}" for k, v in sorted(state.faults.items())))
    return "\n".join(line[:width] for line in lines)


def _parse_line(line: str):
    """(is_run_marker, record | None) — the tail-follow twin of
    schema._iter_lines, tolerant of torn/partial writes."""
    line = line.strip()
    if line.startswith(RUN_MARKER):
        return True, None
    if not line or line.startswith("#"):
        return False, None
    try:
        rec = json.loads(line)
    except json.JSONDecodeError:
        return False, None
    if isinstance(rec, dict) and "schema" in rec:
        try:
            validate_record(rec)
        except ValueError:
            return False, None
    return False, rec if isinstance(rec, dict) else None


def top_main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch top",
        description="Live dashboard over a metrics JSONL: tail a "
                    "running bench/trainer (default), print one frame "
                    "(--once), or replay a finished run (--replay).",
    )
    ap.add_argument("path", help="metrics JSONL to tail")
    ap.add_argument("--refresh", type=float, default=0.5,
                    help="seconds between redraws (follow/replay)")
    ap.add_argument("--once", action="store_true",
                    help="ingest everything, print one frame, exit "
                         "(no ANSI — safe in pipes/CI)")
    ap.add_argument("--replay", action="store_true",
                    help="replay a finished file one frame per "
                         "--refresh instead of tailing")
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N redraws (0 = until Ctrl-C / "
                         "end of replay) — the bounded-session escape "
                         "hatch for scripts")
    ap.add_argument("--width", type=int, default=110)
    args = ap.parse_args(argv)

    path = Path(args.path)
    if not path.exists():
        print(f"error: {path}: no such file", file=sys.stderr)
        return 2
    state = TopState()

    if args.once or args.replay:
        with path.open() as fh:
            lines = fh.readlines()
        if args.once:
            for line in lines:
                marker, rec = _parse_line(line)
                if marker:
                    state.reset()  # frame shows the file's LAST run
                elif rec is not None:
                    state.ingest(rec)
            print(render(state, str(path), width=args.width))
            return 0
        # Replay: one frame per tick/metrics record batch.
        frames = 0
        for line in lines:
            marker, rec = _parse_line(line)
            if marker:
                state.reset()
                continue
            if rec is None:
                continue
            state.ingest(rec)
            if rec.get("event") in ("tick", "metrics", "train", "epoch"):
                sys.stdout.write("\x1b[2J\x1b[H"
                                 + render(state, str(path),
                                          width=args.width) + "\n")
                sys.stdout.flush()
                frames += 1
                if args.frames and frames >= args.frames:
                    return 0
                time.sleep(args.refresh)
        print(render(state, str(path), width=args.width))
        return 0

    # Follow: poll for appended complete lines, redraw in place.
    frames = 0
    buf = ""
    try:
        with path.open() as fh:
            while True:
                chunk = fh.read()
                if chunk:
                    buf += chunk
                    *complete, buf = buf.split("\n")
                    for line in complete:
                        marker, rec = _parse_line(line)
                        if marker:
                            state.reset()
                        elif rec is not None:
                            state.ingest(rec)
                sys.stdout.write("\x1b[2J\x1b[H"
                                 + render(state, str(path),
                                          width=args.width) + "\n")
                sys.stdout.flush()
                frames += 1
                if args.frames and frames >= args.frames:
                    return 0
                time.sleep(args.refresh)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(top_main())
