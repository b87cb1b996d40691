"""Causal critical-path attribution: `python -m mpi_cuda_cnn_tpu_torch
explain RUN` (counterpart of the reference's `obs/causal.py`, the same
code and output).

`trace` says what happened to a request and `health` whether the run
met its targets; this module says why a request was slow. The serving
producers record the causality of their schedule: which rids held the
slots or pages a blocked admission queued behind (`blocked` tick
entries), which decoding request a preemption evicted for
(`preempted_for`), which failover stranded a request (`failed_over`
fleet entries), and when each request arrived (`arrived`). This module
folds that trail into a per-request account whose critical path is
blamed category by category:

- self_compute:       the request held a slot and was progressing
                      (prefill chunks, decode ticks, scheduling gaps
                      while resident);
- queued_behind:      waiting for admission behind named holder rids;
                      SLOScheduler quota skip-overs are their own edge
                      kind ("quota": the request waits on its own
                      tenant's occupancy, not the fleet's);
- preempted_by:       evicted and waiting, blamed on the beneficiary
                      whose page need forced the eviction;
- redispatch_replay:  crash failover, from the moment a dead replica
                      stranded the request until it produces new
                      tokens again;
- router_wait:        fleet arrival to first dispatch;
- handoff_wait:       the disaggregated prefill->decode KV transfer,
                      sealed on the prefill replica until bound
                      decode-ready on the receiver;
- transport_wait:     the dispatch message's time on a lossy bus.

Attribution is in integer ticks on the producer's own tick axis, so
for every terminal request the category ticks sum exactly to its
end-to-end tick span. `blame_check` verifies that conservation, and
`explain_main` also runs `obs.timeline.reconstruct`'s lifecycle
cross-check against the request records (drift exits 1). Wall-clock
milliseconds ride along for display only.

The fold is streaming (one pass, no retained tick records), so the
benches run it live (`BlameAccumulator` on the tick and fleet sinks),
and every serve summary carries `blame_crc` and per-category totals.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import zlib

from .schema import fmt_cell as _fmt
from .schema import iter_runs

# Category order is part of the CRC contract — append only.
# handoff_wait: disaggregated serving's prefill->decode KV
# transfer — from the sealed detach on the prefill replica to the
# decode-ready bind on the receiver (or to the abort that sends the
# request back through redispatch_replay).
# transport_wait: the dispatch message's wire time on the
# lossy bus — router send to replica delivery, retransmits and
# partition block included. Zero with the bus off OR faultless (inline
# delivery lands in the same tick), so older trails fold to
# bitwise-identical rows.
CATEGORIES = ("self_compute", "queued_behind", "preempted_by",
              "redispatch_replay", "router_wait", "handoff_wait",
              "transport_wait")

# Internal wait states -> blame category.
_STATE_CAT = {"active": "self_compute", "queued": "queued_behind",
              "preempt_wait": "preempted_by", "replay": "redispatch_replay",
              "router": "router_wait", "handoff": "handoff_wait",
              "transport": "transport_wait"}


def worst_k(rows, key, k: int):
    """Top-k rows by `key` descending, None-valued rows excluded — THE
    worst-k selector `explain --worst` and `trace
    --slowest` share: one ordering, so the two
    tools drill into the same requests."""
    scored = [(key(r), i, r) for i, r in enumerate(rows)
              if key(r) is not None]
    scored.sort(key=lambda t: (-t[0], t[1]))
    return [r for _, _, r in scored[:k]]


@dataclasses.dataclass
class RequestBlame:
    """One request's finished causal account."""

    rid: int
    mode: str
    status: str | None = None
    tenant: str = "default"
    start_tick: int | None = None
    terminal_tick: int | None = None
    ttft_ms: float | None = None
    tpot_ms: float | None = None
    # Integer ticks per category — sums bitwise to span_ticks.
    cats: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(CATEGORIES, 0))
    # Display-only wall-clock per category (tick `now` stamps).
    cats_ms: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(CATEGORIES, 0.0))
    # Joint blocker attribution: holder rid -> ticks this request spent
    # queued behind it (a segment blames its whole holder set).
    blockers: dict = dataclasses.field(default_factory=dict)
    # Quota skip-over ticks (the "quota"-reason subset of queued_behind
    # — SLOScheduler policy wait, not capacity wait).
    quota_ticks: int = 0
    # Beneficiary rid -> ticks this request waited after being
    # preempted for it.
    preemptors: dict = dataclasses.field(default_factory=dict)
    # (category, start_tick, end_tick, detail) critical-path segments
    # in time order; detail names blockers/beneficiary/replica.
    edges: list = dataclasses.field(default_factory=list)

    @property
    def terminal(self) -> bool:
        return self.terminal_tick is not None

    @property
    def span_ticks(self) -> int | None:
        if self.start_tick is None or self.terminal_tick is None:
            return None
        return self.terminal_tick - self.start_tick

    @property
    def conserved(self) -> bool:
        """THE invariant: category ticks sum exactly to the span."""
        span = self.span_ticks
        return span is not None and span >= 0 \
            and sum(self.cats.values()) == span

    def to_fields(self) -> dict:
        return {
            "rid": self.rid, "status": self.status, "tenant": self.tenant,
            "start_tick": self.start_tick,
            "terminal_tick": self.terminal_tick,
            "span_ticks": self.span_ticks,
            "categories": dict(self.cats),
            "categories_ms": {k: round(v, 3)
                              for k, v in self.cats_ms.items()},
            "quota_ticks": self.quota_ticks,
            "blockers": {str(k): v for k, v in sorted(self.blockers.items())},
            "preemptors": {str(k): v
                           for k, v in sorted(self.preemptors.items())},
            "conserved": self.conserved,
        }


class _ReqState:
    """Mutable per-request fold state. Kept deliberately lean — at
    storm scale tens of thousands of these are live at once, and every
    GC-tracked container here is heap the collector re-scans on every
    full collection (the measured cost at 10^5 requests, PERF.md):
    two fixed lists for the category accounts, lazy dicts only when a
    blocker/beneficiary actually appears, and edges only when a caller
    asked for detail (`explain`); terminal requests are folded
    into flat canonical rows and freed."""

    __slots__ = ("state", "since_tick", "since_now", "start_tick",
                 "cats", "cats_ms", "last_blocked", "beneficiary",
                 "replica", "blockers", "preemptors", "quota_ticks",
                 "edges", "status", "tenant", "ttft_ms", "tpot_ms")

    def __init__(self, state: str, tick: int, now: float,
                 detail: bool):
        self.state = state
        self.since_tick = tick
        self.since_now = now
        self.start_tick = tick
        self.cats = [0] * len(CATEGORIES)
        self.cats_ms = [0.0] * len(CATEGORIES)
        self.last_blocked = None   # (reason, holders) newest block note
        self.beneficiary = None    # rid a preemption victimized this for
        self.replica = None        # replica name a failover stranded it on
        self.blockers = None       # holder rid -> ticks (lazy)
        self.preemptors = None     # beneficiary rid -> ticks (lazy)
        self.quota_ticks = 0
        self.edges = [] if detail else None
        self.status = None
        self.tenant = "default"
        self.ttft_ms = None
        self.tpot_ms = None

    def close(self, tick: int, now: float, new_state: str | None) -> None:
        """End the current segment at `tick` and enter `new_state`."""
        cat = _CAT_IDX[_STATE_CAT[self.state]]
        ticks = tick - self.since_tick
        self.cats[cat] += ticks
        self.cats_ms[cat] += 1e3 * (now - self.since_now)
        detail = None
        if ticks != 0 or self.state in ("preempt_wait", "replay"):
            if self.state == "queued" and self.last_blocked is not None:
                reason, holders = self.last_blocked
                detail = (reason, holders)
                if self.blockers is None:
                    self.blockers = {}
                for h in holders:
                    self.blockers[h] = self.blockers.get(h, 0) + ticks
                if reason == "quota":
                    self.quota_ticks += ticks
            elif self.state == "preempt_wait":
                detail = self.beneficiary
                if self.beneficiary is not None:
                    if self.preemptors is None:
                        self.preemptors = {}
                    self.preemptors[self.beneficiary] = \
                        self.preemptors.get(self.beneficiary, 0) + ticks
            elif self.state == "replay":
                detail = self.replica
            if ticks != 0 and self.edges is not None:
                self.edges.append((CATEGORIES[cat], self.since_tick,
                                   tick, detail))
        if new_state is not None:
            self.state = new_state
        self.since_tick = tick
        self.since_now = now

    def to_blame(self, rid: int, mode: str,
                 terminal_tick: int | None) -> RequestBlame:
        return RequestBlame(
            rid=rid, mode=mode, status=self.status, tenant=self.tenant,
            start_tick=self.start_tick, terminal_tick=terminal_tick,
            ttft_ms=self.ttft_ms, tpot_ms=self.tpot_ms,
            cats=dict(zip(CATEGORIES, self.cats)),
            cats_ms=dict(zip(CATEGORIES, self.cats_ms)),
            blockers=dict(self.blockers or {}),
            quota_ticks=self.quota_ticks,
            preemptors=dict(self.preemptors or {}),
            edges=list(self.edges or []),
        )


_CAT_IDX = {c: i for i, c in enumerate(CATEGORIES)}


class BlameAccumulator:
    """Streaming blame fold over tick/fleet records (one pass, nothing
    retained per tick). Feed it schema records via `ingest`, or raw
    sink dicts via `ingest_tick` / `ingest_fleet` — the benches tap
    the live sinks exactly like the alert engine, which is what makes
    blame available on `--log summary` storms whose per-tick records
    never reach the JSONL.

    Memory discipline (the 10^5-storm requirement): an announced-but-
    idle request costs one tuple in `_announce` (no state object until
    its first real event), and a terminal request is folded into one
    flat canonical row (tuples of atoms — the GC untracks them) with
    its `_ReqState` freed, so the tracked live set is bounded by
    requests actually in flight, not by the run's total.

    `detail=True` (the `explain` path) additionally retains a
    full RequestBlame per terminal request — segment edges included —
    for the blame-tree renderings; the canonical rows and CRC are
    identical either way (live == replay, the alerts_crc discipline).
    """

    def __init__(self, detail: bool = False):
        self.detail = detail
        # mode -> rid -> _ReqState, live (in-flight) requests only;
        # per-replica fleet ticks fold into the ONE logical mode
        # "fleet" (a lifecycle spans replicas).
        self._states: dict[str, dict[int, _ReqState]] = {}
        # mode -> rid -> (announce tick, now): arrival fell due, no
        # event yet. The fold's only trace of a quietly queued request.
        self._announce: dict[str, dict[int, tuple]] = {}
        # mode -> rid -> canonical row (the CRC/aggregate substrate):
        # (rid, status, tenant, start, end, cats tuple, quota ticks,
        #  blockers items, preemptors items, conserved).
        self._rows: dict[str, dict[int, tuple]] = {}
        # mode -> rid -> RequestBlame (detail mode only).
        self._blames: dict[str, dict[int, RequestBlame]] = {}
        self.saw_causal_fields = False
        self.saw_ticks = False

    # -- record ingestion ----------------------------------------------

    def ingest(self, rec: dict) -> None:
        ev = rec.get("event")
        if ev == "tick":
            self.ingest_tick(rec)
        elif ev == "fleet":
            self.ingest_fleet(rec)

    def _st(self, mode: str, rid: int, tick: int, now: float,
            state: str) -> _ReqState:
        """The rid's live state, materialized on first use: anchored at
        its announce moment when one was recorded (initial state is
        router for the fleet, queued for an engine), else defensively
        at the current tick in `state`."""
        per = self._states.setdefault(mode, {})
        st = per.get(rid)
        if st is None:
            ann = self._announce.setdefault(mode, {}).pop(rid, None)
            if ann is not None:
                st = _ReqState("router" if mode == "fleet" else "queued",
                               ann[0], ann[1], self.detail)
            else:
                st = _ReqState(state, tick, now, self.detail)
            per[rid] = st
        return st

    def ingest_fleet(self, rec: dict) -> None:
        tick, now = rec.get("tick"), rec.get("now", 0.0)
        if tick is None:
            return
        if "arrived" in rec:
            self.saw_causal_fields = True
        ann = self._announce.setdefault("fleet", {})
        for rid in rec.get("arrived") or []:
            ann[rid] = (tick, now)
        # Lossy transport: with the bus on ("transport" block
        # present), a dispatched/redispatched marker is the router's
        # SEND — the request is on the wire until its t_delivered
        # marker, and those ticks are transport_wait. Inline zero-fault
        # delivery puts both markers in the same record (0-tick
        # segments), so faultless bus trails fold identically to direct.
        bus = "transport" in rec
        for rid in rec.get("dispatched") or []:
            st = self._st("fleet", rid, tick, now, "router")
            if st.state == "router":
                st.close(tick, now, "transport" if bus else "queued")
        for rid, name in rec.get("failed_over") or []:
            st = self._st("fleet", rid, tick, now, "replay")
            if st.state != "replay":
                st.close(tick, now, "replay")
            st.replica = name
        # Disaggregated handoff markers, processed BEFORE
        # redispatched: an aborted handoff's re-dispatch can land in
        # the same fleet record, and the replay segment must start at
        # the abort, not absorb the handoff wait.
        for rid, _src in rec.get("handoff_started") or []:
            st = self._st("fleet", rid, tick, now, "handoff")
            if st.state != "handoff":
                st.close(tick, now, "handoff")
        for rid, _dst in rec.get("handoff_done") or []:
            st = self._st("fleet", rid, tick, now, "handoff")
            if st.state == "handoff":
                st.close(tick, now, "active")
        for rid, _why in rec.get("handoff_aborted") or []:
            st = self._st("fleet", rid, tick, now, "handoff")
            if st.state == "handoff":
                st.close(tick, now, "replay")
        for rid in rec.get("redispatched") or []:
            st = self._st("fleet", rid, tick, now, "replay")
            if bus:
                if st.state != "transport":
                    st.close(tick, now, "transport")
            elif st.state != "replay":
                # Defensive: a redispatch always follows a failed_over
                # marker; an out-of-order trail still folds, it just
                # starts the replay here.
                st.close(tick, now, "replay")
        # Wire deliveries LAST: a same-tick send+delivery (the inline
        # zero-fault path) must close its 0-tick transport segment
        # after the send opened it. st.replica (set by failed_over)
        # discriminates a redispatch delivery — the re-prefill ahead is
        # crash-caused work, so it re-enters replay, not queued.
        for rid, _name in rec.get("t_delivered") or []:
            st = self._st("fleet", rid, tick, now, "queued")
            if st.state == "transport":
                st.close(tick, now,
                         "replay" if st.replica is not None else "queued")

    def ingest_tick(self, rec: dict) -> None:
        mode = rec.get("mode", "?")
        if mode.startswith("fleet/"):
            mode = "fleet"
        tick, now = rec.get("tick"), rec.get("now", 0.0)
        if tick is None:
            return
        self.saw_ticks = True
        if "arrived" in rec or "blocked" in rec:
            self.saw_causal_fields = True
        per = self._states.setdefault(mode, {})
        arrived = rec.get("arrived")
        if arrived:
            ann = self._announce.setdefault(mode, {})
            for rid in arrived:
                ann[rid] = (tick, now)
        for entry in rec.get("blocked") or []:
            st = self._st(mode, entry[0], tick, now, "queued")
            if st.state in ("queued", "preempt_wait", "replay"):
                note = (entry[1], list(entry[2]))
                if st.state == "queued" and st.last_blocked is not None \
                        and st.last_blocked != note:
                    # The block CHANGED (holders released, or quota
                    # became a capacity wait): split the queued segment
                    # here so the ticks waited so far are billed to the
                    # holders/reason that actually blocked them — the
                    # newest note must not absorb the whole wait.
                    st.close(tick, now, "queued")
                st.last_blocked = note
        terminal = rec.get("terminal")
        if terminal:
            # Tenant/latency land BEFORE finalization below builds the
            # canonical row (the row carries the tenant).
            for t in terminal:
                st = self._st(mode, t["id"], tick, now, "queued")
                st.tenant = t.get("tenant", "default")
                st.ttft_ms = t.get("ttft_ms")
                st.tpot_ms = t.get("tpot_ms")
        for _slot, rid in rec.get("admitted") or []:
            st = self._st(mode, rid, tick, now, "active")
            if st.state in ("queued", "preempt_wait"):
                st.close(tick, now, "active")
            # A replay readmission stays replay until it produces a new
            # token: the re-prefill is crash-caused work, not progress.
        preempted = rec.get("preempted")
        if preempted:
            benef = {v: b for v, b in rec.get("preempted_for") or []}
            for rid in preempted:
                st = per.get(rid)
                if st is None or st.state == "replay":
                    continue  # replay absorbs mid-replay evictions
                st.close(tick, now, "preempt_wait")
                st.beneficiary = benef.get(rid)
        pf = rec.get("prefill")
        if pf and pf[-1] == "emit":
            st = per.get(pf[1])
            if st is not None and st.state == "replay":
                st.close(tick, now, "active")
        for rid in rec.get("finished") or []:
            self._terminal(mode, rid, tick, now, "finished")
        for rid, status in rec.get("aborted") or []:
            self._terminal(mode, rid, tick, now, status)
        if terminal:
            # A terminal entry whose rid never hit the finished/aborted
            # lists (fence-accepted sync only) still finalizes.
            for t in terminal:
                if t["id"] in per:
                    self._terminal(mode, t["id"], tick, now,
                                   t.get("status", "finished"))

    def _terminal(self, mode: str, rid: int, tick: int, now: float,
                  status: str) -> None:
        if rid in self._rows.get(mode, ()):
            return
        st = self._st(mode, rid, tick, now, "queued")
        st.close(tick, now, None)
        st.status = status
        span = tick - st.start_tick
        conserved = span >= 0 and sum(st.cats) == span
        self._rows.setdefault(mode, {})[rid] = (
            rid, status, st.tenant, st.start_tick, tick,
            tuple(st.cats), st.quota_ticks,
            tuple(sorted((st.blockers or {}).items())),
            tuple(sorted((st.preemptors or {}).items())),
            conserved,
        )
        if self.detail:
            self._blames.setdefault(mode, {})[rid] = \
                st.to_blame(rid, mode, tick)
        # Freed: the live set tracks in-flight requests only.
        del self._states[mode][rid]

    # -- results -------------------------------------------------------

    def blames(self) -> dict[str, dict[int, RequestBlame]]:
        """Per-request blame for rendering (detail mode). Non-terminal
        leftovers are included with status None so an incomplete trail
        is visible, not silently dropped."""
        if not self.detail:
            raise ValueError(
                "per-request blame needs BlameAccumulator(detail=True) "
                "— the streaming bench fold keeps aggregates only"
            )
        modes = set(self._blames) | set(self._states) | set(self._rows)
        out: dict[str, dict[int, RequestBlame]] = {}
        for mode in sorted(modes):
            per = dict(self._blames.get(mode, {}))
            for rid, st in self._states.get(mode, {}).items():
                per[rid] = st.to_blame(rid, mode, None)
            out[mode] = dict(sorted(per.items()))
        return out

    def check(self, mode: str) -> list[str]:
        """Conservation + completeness problems for one mode (empty =
        every request terminal and its categories sum bitwise to its
        span — the conservation invariant)."""
        problems = []
        open_rids = sorted(set(self._states.get(mode, ()))
                           | set(self._announce.get(mode, ())))
        for rid in open_rids:
            problems.append(f"rid {rid}: no terminal status in trail")
        for rid, row in sorted(self._rows.get(mode, {}).items()):
            if not row[9]:
                cats = dict(zip(CATEGORIES, row[5]))
                problems.append(
                    f"rid {rid}: blame ticks {sum(row[5])} != "
                    f"span {row[4] - row[3]} "
                    f"({', '.join(f'{k}={v}' for k, v in cats.items())})"
                )
        return problems

    def crc(self, mode: str) -> int:
        """crc32 over the canonical per-request blame of one mode — ONE
        number the determinism gate pins at exact equality (category
        order and field order are part of the contract)."""
        canon = [[row[0], row[1], row[2], row[3], row[4], list(row[5]),
                  row[6], [list(kv) for kv in row[7]],
                  [list(kv) for kv in row[8]]]
                 for _, row in sorted(self._rows.get(mode, {}).items())]
        return zlib.crc32(json.dumps(canon).encode())

    def summary_fields(self, mode: str) -> dict:
        """The `blame` event record's fields (obs.schema family) for
        one mode: aggregate category totals, per-tenant breakdown, and
        the CRC the CI gate pins."""
        rows = self._rows.get(mode, {})
        cats = dict.fromkeys(CATEGORIES, 0)
        tenants: dict[str, dict] = {}
        quota = 0
        for row in rows.values():
            per = tenants.setdefault(row[2], dict.fromkeys(CATEGORIES, 0))
            for c, v in zip(CATEGORIES, row[5]):
                cats[c] += v
                per[c] += v
            quota += row[6]
        open_n = len(self._states.get(mode, ())) \
            + len(self._announce.get(mode, ()))
        return {
            "mode": mode, "requests": len(rows) + open_n,
            "categories": cats, "quota_ticks": quota,
            "tenants": {t: v for t, v in sorted(tenants.items())},
            "conserved": open_n == 0 and all(r[9] for r in rows.values()),
            "crc": self.crc(mode),
        }

    def top_blockers(self, mode: str, k: int = 8) -> list[tuple]:
        """(holder rid, ticks it held others up, victims) ranked — the
        aggregate form of the blocker edges (`top`'s panel is the
        live twin, fed straight off the tick stream)."""
        held: dict[int, int] = {}
        victims: dict[int, set] = {}
        for row in self._rows.get(mode, {}).values():
            for h, ticks in row[7]:
                held[h] = held.get(h, 0) + ticks
                victims.setdefault(h, set()).add(row[0])
            for h, ticks in row[8]:
                held[h] = held.get(h, 0) + ticks
                victims.setdefault(h, set()).add(row[0])
        ranked = sorted(held.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        return [(h, t, len(victims[h])) for h, t in ranked]


# -- rendering ---------------------------------------------------------


def render_blame_tree(b: RequestBlame) -> str:
    """One request's blame, category totals then the critical-path
    segments in time order."""
    span = b.span_ticks
    head = [
        f"request {b.rid} [{b.mode}] — {_fmt(b.status)}, "
        f"tenant {b.tenant}, span {_fmt(span)} ticks "
        f"(ticks {_fmt(b.start_tick)}..{_fmt(b.terminal_tick)}), "
        f"ttft {_fmt(b.ttft_ms)} ms, "
        f"conserved {'yes' if b.conserved else 'NO'}",
    ]
    for cat in CATEGORIES:
        ticks = b.cats[cat]
        if ticks == 0 and cat != "self_compute":
            continue
        pct = 100.0 * ticks / span if span else 0.0
        extra = ""
        if cat == "queued_behind" and b.blockers:
            extra = "  behind " + ", ".join(
                f"rid {h} ({t}t)" for h, t in sorted(
                    b.blockers.items(), key=lambda kv: (-kv[1], kv[0])))
            if b.quota_ticks:
                extra += f"  [quota skip-over {b.quota_ticks}t]"
        elif cat == "preempted_by" and b.preemptors:
            extra = "  by " + ", ".join(
                f"rid {h} ({t}t)" for h, t in sorted(
                    b.preemptors.items(), key=lambda kv: (-kv[1], kv[0])))
        head.append(f"  {cat:<18} {ticks:>6} ticks  {pct:5.1f}%  "
                    f"{_fmt(b.cats_ms[cat])} ms{extra}")
    for cat, start, end, detail in b.edges:
        d = ""
        if detail is not None:
            if cat == "queued_behind":
                reason, holders = detail
                d = f"  [{reason}: " + ", ".join(map(str, holders)) + "]"
            elif cat == "preempted_by":
                d = f"  [for rid {detail}]"
            elif cat == "redispatch_replay":
                d = f"  [replica {detail}]"
        head.append(f"    tick {start:>6}..{end:<6} {cat}{d}")
    return "\n".join(head)


def render_aggregate(fields: dict) -> str:
    """Aggregate blame tables: categories, then per-tenant rows."""
    cats = fields["categories"]
    total = sum(cats.values()) or 1
    lines = [
        "| blame (ticks) | " + " | ".join(CATEGORIES) + " | quota | crc |",
        "|---|" + "---|" * (len(CATEGORIES) + 2),
        f"| {fields['mode']} ({fields['requests']} reqs) | "
        + " | ".join(f"{cats[c]} ({100.0 * cats[c] / total:.1f}%)"
                     for c in CATEGORIES)
        + f" | {fields['quota_ticks']} | {_fmt(fields['crc'])} |",
        "",
    ]
    tenants = fields.get("tenants") or {}
    if len(tenants) > 1 or (tenants and "default" not in tenants):
        lines += [
            "| tenant blame (ticks) | " + " | ".join(CATEGORIES) + " |",
            "|---|" + "---|" * len(CATEGORIES),
        ]
        for t, per in tenants.items():
            lines.append(f"| {t} | "
                         + " | ".join(str(per[c]) for c in CATEGORIES)
                         + " |")
        lines.append("")
    return "\n".join(lines)


def render_top_blockers(rows: list[tuple]) -> str:
    if not rows:
        return "(no blocker edges — nothing ever waited behind a holder)"
    lines = ["| top blockers | held others up (ticks) | victims |",
             "|---|---|---|"]
    for rid, ticks, n in rows:
        lines.append(f"| rid {rid} | {ticks} | {n} |")
    return "\n".join(lines)


# -- the CLI -----------------------------------------------------------


def explain_main(argv: list[str] | None = None) -> int:
    """`explain RUN` — causal blame for a serving run.

    Exits 1 when the trail drifts from the engine's own records (the
    `trace` lifecycle cross-check) or any terminal request's
    blame fails conservation; 2 on config/legacy-file errors.
    """
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch explain",
        description="Causal critical-path attribution from a serving "
                    "run's metrics JSONL: per-request blame trees "
                    "(self/queued-behind/preempted-by/replay/router) "
                    "that sum exactly to end-to-end latency, plus "
                    "aggregate blame and top-blocker tables.",
    )
    ap.add_argument("path", help="metrics JSONL with tick (+ fleet) records")
    ap.add_argument("--request", type=int, default=None,
                    help="blame tree for one request id")
    ap.add_argument("--worst", choices=("ttft", "tpot"), default=None,
                    help="blame trees for the worst-k requests by this "
                         "latency metric")
    ap.add_argument("-k", type=int, default=5,
                    help="how many worst requests (--worst; default 5)")
    ap.add_argument("--tenant", default=None,
                    help="restrict blame accounting to one tenant's "
                         "requests (untagged = 'default')")
    ap.add_argument("--mode", default=None,
                    help="restrict to one scheduler mode")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    args = ap.parse_args(argv)

    # Lazy sibling import: explain reuses trace's
    # reconstruction as the drift check against the request records.
    from .timeline import reconstruct

    try:
        runs = [r for r in iter_runs(args.path) if r]
    except (OSError, ValueError) as e:
        print(f"error: {args.path}: {e}", file=sys.stderr)
        return 2
    rc = 0
    any_mode = False
    for i, records in enumerate(runs, 1):
        acc = BlameAccumulator(detail=True)
        for rec in records:
            acc.ingest(rec)
        if not acc.saw_ticks:
            continue
        if not acc.saw_causal_fields:
            print(f"error: {args.path}: tick records carry no causal "
                  "fields (arrived/blocked) — regenerate the run with "
                  "a producer that records them", file=sys.stderr)
            return 2
        lifecycles = reconstruct(records)
        label = args.path if len(runs) == 1 \
            else f"{args.path} (run {i}/{len(runs)})"
        blames = acc.blames()
        for mode in sorted(blames):
            if args.mode is not None and mode != args.mode:
                continue
            per = blames[mode]
            if args.tenant is not None:
                per = {rid: b for rid, b in per.items()
                       if b.tenant == args.tenant}
                if not per:
                    continue
            any_mode = True
            # Drift checks: conservation (this module's invariant) and
            # the lifecycle cross-check vs the engine's own records.
            problems = [p for p in acc.check(mode)
                        if args.tenant is None
                        or p.split(":")[0].removeprefix("rid ").strip()
                        in {str(r) for r in per}]
            lcs = lifecycles.get(mode, {})
            bad = [rid for rid, lc in lcs.items() if not lc.consistent
                   and (args.tenant is None or rid in per)]
            agg = _aggregate(per, mode, acc,
                             full=len(per) == len(blames[mode]))
            if args.format == "json":
                print(json.dumps({
                    "path": args.path, "run": i, "mode": mode,
                    "requests": len(per),
                    "aggregate": agg,
                    "top_blockers": acc.top_blockers(mode),
                    "problems": problems,
                    "inconsistent": sorted(bad),
                    "blames": {str(rid): b.to_fields()
                               for rid, b in sorted(per.items())},
                }))
            elif args.request is not None:
                b = per.get(args.request)
                if b is None:
                    print(f"error: no request {args.request} in mode "
                          f"{mode} of {label}", file=sys.stderr)
                    rc = max(rc, 2)
                    continue
                print(f"## Explain — {label} [{mode}]\n")
                print(render_blame_tree(b))
                print()
            else:
                print(f"## Explain — {label} [{mode}]\n")
                print(render_aggregate(agg))
                print(render_top_blockers(acc.top_blockers(mode)))
                print()
                if args.worst is not None:
                    key = (lambda b: b.ttft_ms) if args.worst == "ttft" \
                        else (lambda b: b.tpot_ms)
                    for b in worst_k(list(per.values()), key, args.k):
                        print(render_blame_tree(b))
                        print()
            if problems:
                print(f"error: {len(problems)} blame account(s) violate "
                      f"conservation/completeness in mode {mode}: "
                      + "; ".join(problems[:5]), file=sys.stderr)
                rc = max(rc, 1)
            if bad:
                print(f"error: {len(bad)} request(s) with lifecycles "
                      f"inconsistent vs engine records in mode {mode}: "
                      f"{sorted(bad)[:10]}", file=sys.stderr)
                rc = max(rc, 1)
    if not any_mode:
        print(f"error: {args.path}: no tick trail to explain "
              "(run with --metrics-jsonl and full logging)",
              file=sys.stderr)
        return 2
    return rc


def _aggregate(per: dict[int, RequestBlame], mode: str,
               acc: BlameAccumulator, *, full: bool) -> dict:
    """Aggregate fields for a (possibly tenant-filtered) request set —
    the full-set form (`full`, decided by the caller that already holds
    the unfiltered mapping) delegates to summary_fields so the rendered
    table and the stamped `blame` record can never disagree."""
    if full:
        return acc.summary_fields(mode)
    cats = dict.fromkeys(CATEGORIES, 0)
    tenants: dict[str, dict] = {}
    quota = 0
    for b in per.values():
        t = tenants.setdefault(b.tenant, dict.fromkeys(CATEGORIES, 0))
        for c in CATEGORIES:
            cats[c] += b.cats[c]
            t[c] += b.cats[c]
        quota += b.quota_ticks
    return {"mode": mode, "requests": len(per), "categories": cats,
            "quota_ticks": quota,
            "tenants": {t: v for t, v in sorted(tenants.items())},
            "conserved": all(b.conserved for b in per.values()),
            # No CRC on a filtered view: the canonical CRC covers the
            # whole mode, and stamping it next to a subset's numbers
            # would invite comparing the two.
            "crc": None}


if __name__ == "__main__":
    sys.exit(explain_main())
