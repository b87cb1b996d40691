"""Streaming alert rules over the live JSONL event stream (a copy of the
JAX package's `obs/alerts.py`, stdlib only).

A rule engine that folds the SAME records the metrics file gets (`tick`,
`metrics`, `fault`, ... families) and emits an `alert` record the moment
a rule trips. The engine is a pure fold over the record sequence (no
clock reads, no randomness), so replaying the finished file reproduces
the identical alert sequence, and `alerts_crc` pins it as one number.
`serve-bench --slo` attaches it to the MetricsLogger (`attach`). The
engine ignores `alert` records on ingest.

Rule kinds (spec objects in the "rules" list of an SLO file, or passed
directly):

- threshold:      {"name", "kind": "threshold", "event", "field",
                   "op": ">|>=|<|<=|==|!=", "value", "for_count": 1,
                   "per": null|"mode", "each": false, "severity"};
                  edge-triggered unless "each": true.
- rate_of_change: {"kind": "rate_of_change", "event", "field",
                   "max_rise_pct", "max_fall_pct"}: each record's field
                  against the previous one (per group).
- absence:        {"kind": "absence", "event", "max_gap_s",
                   "per": "mode"}: the watched family went quiet for
                  longer than max_gap_s on the run timeline (only
                  records carrying "now" advance it).
- burn_rate:      built from an SLOSpec: per (tenant, objective)
                  multi-window burn, fires when EVERY window of a
                  [long, short] pair burns faster than the spec's
                  max_rate, re-arms when the long window recovers.

Alert record fields: seq (emission index), rule, kind, severity, at
(the triggering record's timeline stamp), plus context.
"""

from __future__ import annotations

import json
import zlib

from .slo import Accountant, SLOSpec, run_mode

ALERT_KINDS = ("threshold", "rate_of_change", "absence", "burn_rate")
_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


def event_time(rec: dict) -> float:
    """A record's position on its producer's timeline: engine/fleet
    records carry "now" (run-relative, FakeClock-deterministic), the
    rest only their logger "t" stamp."""
    now = rec.get("now")
    return float(now if now is not None else rec.get("t", 0.0) or 0.0)


class _ThresholdRule:
    def __init__(self, spec: dict):
        self.name = spec["name"]
        self.event = spec["event"]
        self.field = spec["field"]
        op = spec.get("op", ">")
        if op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {op!r}")
        self.op, self._cmp = op, _OPS[op]
        self.value = spec["value"]
        self.for_count = int(spec.get("for_count", 1))
        self.per = spec.get("per")
        self.each = bool(spec.get("each", False))
        self.severity = spec.get("severity", "warn")
        self._streak: dict = {}
        self._firing: dict = {}

    def ingest(self, event: str, rec: dict) -> list[dict]:
        if event != self.event or self.field not in rec:
            return []
        group = rec.get(self.per) if self.per else None
        v = rec[self.field]
        try:
            hit = self._cmp(v, self.value)
        except TypeError:
            return []
        if not hit:
            self._streak[group] = 0
            self._firing[group] = False
            return []
        if self.each:
            return [self._alert(rec, group, v)]
        self._streak[group] = self._streak.get(group, 0) + 1
        if self._streak[group] >= self.for_count \
                and not self._firing.get(group):
            self._firing[group] = True
            return [self._alert(rec, group, v)]
        return []

    def _alert(self, rec: dict, group, v) -> dict:
        a = {"rule": self.name, "kind": "threshold",
             "severity": self.severity, "at": round(event_time(rec), 4),
             "field": f"{self.event}.{self.field}", "value": v,
             "threshold": self.value, "op": self.op}
        if group is not None:
            a["group"] = group
        if rec.get("tick") is not None:
            a["tick"] = rec["tick"]
        return a


class _RateRule:
    def __init__(self, spec: dict):
        self.name = spec["name"]
        self.event = spec["event"]
        self.field = spec["field"]
        self.max_rise = spec.get("max_rise_pct")
        self.max_fall = spec.get("max_fall_pct")
        if self.max_rise is None and self.max_fall is None:
            raise ValueError(
                f"rule {self.name!r}: rate_of_change needs max_rise_pct "
                "and/or max_fall_pct"
            )
        self.per = spec.get("per")
        self.severity = spec.get("severity", "warn")
        self._prev: dict = {}

    def ingest(self, event: str, rec: dict) -> list[dict]:
        if event != self.event:
            return []
        v = rec.get(self.field)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            return []
        group = rec.get(self.per) if self.per else None
        prev, self._prev[group] = self._prev.get(group), v
        if prev is None or prev == 0:
            return []
        delta_pct = (v - prev) / abs(prev) * 100.0
        breach = ((self.max_rise is not None and delta_pct > self.max_rise)
                  or (self.max_fall is not None
                      and delta_pct < -self.max_fall))
        if not breach:
            return []
        a = {"rule": self.name, "kind": "rate_of_change",
             "severity": self.severity, "at": round(event_time(rec), 4),
             "field": f"{self.event}.{self.field}", "value": v,
             "prev": prev, "delta_pct": round(delta_pct, 3)}
        if group is not None:
            a["group"] = group
        if rec.get("tick") is not None:
            a["tick"] = rec["tick"]
        return [a]


class _AbsenceRule:
    """Staleness: the watched family stopped arriving. Driven only by
    records that carry "now" (one shared run timeline); gap checks run
    on EVERY such record, watched family or not — another family's
    heartbeat is what reveals the watched one went quiet."""

    def __init__(self, spec: dict):
        self.name = spec["name"]
        self.event = spec["event"]
        self.max_gap_s = float(spec["max_gap_s"])
        self.per = spec.get("per")
        self.severity = spec.get("severity", "warn")
        self._last_seen: dict = {}
        self._fired: dict = {}
        # Stalest (group, last-seen) cache: the common no-gap record
        # costs one subtraction instead of a scan over every group.
        self._stale_t: float | None = None
        self._stale_g = None

    def ingest(self, event: str, rec: dict) -> list[dict]:
        now = rec.get("now")
        if now is None:
            return []
        out = []
        # Gap check BEFORE this record updates its own group: a watched
        # record arriving late is itself the proof of the gap it ends
        # (the FakeClock serve runs surface a `slow` fault exactly this
        # way — the next tick lands max_gap_s late). The cached stalest
        # time makes the scan conditional: if even the stalest group is
        # fresh, nobody can fire.
        if self._stale_t is not None and now - self._stale_t > self.max_gap_s:
            for group, seen in self._last_seen.items():
                gap = now - seen
                if gap > self.max_gap_s and not self._fired.get(group):
                    self._fired[group] = True
                    a = {"rule": self.name, "kind": "absence",
                         "severity": self.severity, "at": round(now, 4),
                         "family": self.event, "gap_s": round(gap, 4),
                         "max_gap_s": self.max_gap_s}
                    if group is not None:
                        a["group"] = group
                    if rec.get("tick") is not None:
                        a["tick"] = rec["tick"]
                    out.append(a)
        if event == self.event:
            group = rec.get(self.per) if self.per else None
            prev = self._last_seen.get(group)
            self._last_seen[group] = now
            self._fired[group] = False
            if self._stale_t is None or prev is None \
                    or group == self._stale_g:
                # The stalest group moved (or membership changed):
                # re-derive the cache. Amortized O(1): each group takes
                # its turn as stalest once per heartbeat round.
                self._stale_g, self._stale_t = min(
                    self._last_seen.items(), key=lambda kv: kv[1])
        return out


class _BurnRule:
    """Multi-window multi-burn-rate over the SLO accountant: one
    logical rule spanning every (mode, tenant, objective, window-pair)
    combination, each with its own firing latch. One Accountant per
    run MODE — a serve-bench file's static and continuous halves live
    on independent timelines (obs.slo.verdicts_from_terminals makes
    the same split), while a fleet's per-replica modes share one clock
    and fold together."""

    def __init__(self, slo: SLOSpec):
        self.slo = slo
        self._accs: dict[str, Accountant] = {}
        self._firing: dict[tuple, bool] = {}

    def ingest(self, event: str, rec: dict) -> list[dict]:
        if event != "tick" or not rec.get("terminal"):
            return []
        now = event_time(rec)
        mode = run_mode(rec)
        acc = self._accs.get(mode)
        if acc is None:
            acc = self._accs[mode] = Accountant(self.slo)
        out = []
        for tenant, obj, we, good in acc.observe_all(rec, now):
            if good:
                continue  # burn can only rise on a bad event
            for lo, sh in self.slo.windows:
                key = (mode, tenant, obj.metric, lo, sh)
                b_lo = we.burn_rate(lo, obj.target)
                b_sh = we.burn_rate(sh, obj.target)
                if b_lo > self.slo.max_burn and b_sh > self.slo.max_burn:
                    if not self._firing.get(key):
                        self._firing[key] = True
                        a = {"rule": f"burn:{tenant}:{obj.metric}",
                             "kind": "burn_rate", "severity": "page",
                             "at": round(now, 4), "group": mode,
                             "tenant": tenant, "metric": obj.metric,
                             "windows_s": [lo, sh],
                             "burn": round(max(b_lo, b_sh), 3),
                             "max_rate": self.slo.max_burn,
                             "target": obj.target}
                        if rec.get("tick") is not None:
                            a["tick"] = rec["tick"]
                        out.append(a)
                elif b_lo <= self.slo.max_burn:
                    # The long window recovered: re-arm.
                    self._firing[key] = False
        return out


_RULE_CLASSES = {
    "threshold": _ThresholdRule,
    "rate_of_change": _RateRule,
    "absence": _AbsenceRule,
}


def parse_rules(specs: list[dict]) -> list:
    rules = []
    names = set()
    for spec in specs:
        kind = spec.get("kind")
        if kind == "burn_rate":
            raise ValueError(
                "burn_rate rules are derived from the SLO spec's "
                '"tenants"/"burn" sections, not spelled in "rules"'
            )
        cls = _RULE_CLASSES.get(kind)
        if cls is None:
            raise ValueError(
                f"alert rule {spec.get('name')!r}: unknown kind {kind!r} "
                f"(want one of {ALERT_KINDS})"
            )
        if not spec.get("name"):
            raise ValueError(f"alert rule missing a name: {spec}")
        if spec["name"] in names:
            raise ValueError(f"duplicate alert rule name {spec['name']!r}")
        names.add(spec["name"])
        try:
            rules.append(cls(spec))
        except KeyError as e:
            raise ValueError(
                f"alert rule {spec['name']!r}: missing key {e}"
            ) from e
    return rules


class AlertEngine:
    """The streaming fold: rules + (optionally) SLO burn accounting.

    `ingest(record)` returns the alert field dicts the record tripped,
    each stamped with a monotonically increasing "seq"; `alerts`
    accumulates them all and `crc` pins the sequence. Attach live with
    `attach(metrics_logger)` (observes every record the logger writes
    and logs the resulting alerts back through it), or fold a finished
    file with `replay(records)`.
    """

    def __init__(self, rules: list[dict] | None = None,
                 slo: SLOSpec | None = None):
        specs = list(rules or ())
        if slo is not None:
            specs = specs + list(slo.rules)
        self.rules = parse_rules(specs)
        if slo is not None:
            self.rules.append(_BurnRule(slo))
        self.slo = slo
        self.alerts: list[dict] = []
        # Event-indexed dispatch: threshold/rate rules see only their
        # own family; absence (any timeline record is its clock) and
        # burn rules see everything.
        self._timeline_rules = [r for r in self.rules
                                if isinstance(r, (_AbsenceRule, _BurnRule))]
        self._by_event: dict[str, list] = {}
        for r in self.rules:
            if not isinstance(r, (_AbsenceRule, _BurnRule)):
                self._by_event.setdefault(r.event, []).append(r)

    def ingest(self, rec: dict, event: str | None = None) -> list[dict]:
        """Fold one record; `event` overrides rec["event"] (the benches'
        sink tee passes bare tick/fleet field dicts without copying)."""
        if not isinstance(rec, dict):
            return []
        ev = event if event is not None else rec.get("event")
        if ev == "alert":
            return []
        fired = []
        for rule in self._by_event.get(ev, ()):
            fired.extend(rule.ingest(ev, rec))
        for rule in self._timeline_rules:
            fired.extend(rule.ingest(ev, rec))
        for a in fired:
            a["seq"] = len(self.alerts)
            self.alerts.append(a)
        return fired

    def replay(self, records) -> list[dict]:
        for rec in records:
            self.ingest(rec)
        return self.alerts

    def attach(self, metrics) -> None:
        """Wire into a MetricsLogger: every record it logs is ingested,
        and fired alerts are logged straight back (the reentrant log of
        an `alert` record is ignored by ingest, so this terminates)."""

        def observer(rec: dict) -> None:
            for a in self.ingest(rec):
                metrics.log("alert", **a)

        metrics.observer = observer

    @property
    def crc(self) -> int:
        return alerts_crc(self.alerts)


def alert_site(a: dict) -> str:
    """The alert's location label, by specificity: tenant (burn),
    per-group (grouped rules), field (threshold/rate), watched family
    (absence)."""
    return (a.get("tenant") or a.get("group") or a.get("field")
            or a.get("family") or "")


def format_alert(a: dict) -> str:
    """The one-line alert rendering `health` and the `top` ALERTS panel
    share, so the two cannot drift as alert kinds grow context
    fields."""
    tick = f" tick {a['tick']}" if a.get("tick") is not None else ""
    return (f"[{a.get('seq')}] {a.get('rule')} "
            f"({a.get('kind')}, {a.get('severity')}) "
            f"{alert_site(a)} at t={a.get('at'):g}{tick}")


def alerts_crc(alerts: list[dict]) -> int:
    """crc32 over the canonical identity of every alert in sequence —
    the one number that pins it. The identity covers (seq, rule, kind,
    group, tenant, tick, at): enough to pin ordering, cause, and timing
    without depending on rounding of derived context fields — absent
    keys hash as null, so the CRC of a sequence rebuilt from logged
    records matches the live engine's."""
    key = [[a.get("seq"), a.get("rule"), a.get("kind"), a.get("group"),
            a.get("tenant"), a.get("tick"), a.get("at")]
           for a in alerts]
    return zlib.crc32(json.dumps(key).encode())
