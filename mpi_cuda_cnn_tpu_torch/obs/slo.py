"""Declarative SLOs: per-tenant objectives, error budgets, burn rates
and the end-of-run verdicts (counterpart of the reference's
`obs/slo.py`, stdlib only).

Every number is a pure fold over terminal-request events on the run's
own timeline (the engine's clock, a FakeClock in deterministic runs), so
two identical-seed runs give identical burn rates and verdicts, and the
SLO scheduler that reads them makes identical decisions.

The spec is a JSON file::

    {"tenants": {"*": {"availability": 0.999,
                       "ttft_ms":  {"target": 0.95, "threshold_ms": 500},
                       "tpot_ms":  {"target": 0.95, "threshold_ms": 100},
                       "queue_wait_ms": {"target": 0.9,
                                         "threshold_ms": 1000}},
                 "t0": {"availability": 0.9999}},
     "burn": {"windows_s": [[60, 5], [300, 30]], "max_rate": 10.0},
     "train": {"loss_spike_pct": 100.0, "max_restarts": 0,
               "max_nonfinite": 0, "step_ms_p99_ms": null},
     "rules": [ ...extra obs.alerts rules... ],
     "max_alerts": 0}

- `tenants` maps a tenant name (or the "*" wildcard) to its objectives:
  `availability` is a bare target fraction; the latency objectives pair
  a target with the threshold that separates good from bad.
- `burn` configures multi-window multi-burn-rate alerting: each
  [long_s, short_s] pair fires only when BOTH windows burn faster than
  `max_rate` (burn rate 1.0 = spending exactly the error budget over
  the window).
- `train` bounds the training-run rules `health` applies to the
  `train` records (`train_health`).
- `rules` is extra obs.alerts rule specs appended to the burn rules.
- `max_alerts`: a run firing more alerts than this is a health
  violation.

Good/bad: availability counts finished as good and expired/failed/
rejected as bad (cancelled is no event); latency objectives count
finished requests only, good iff the value is at or under the threshold.
"""

from __future__ import annotations

import dataclasses
import json
import math
from collections import deque
from pathlib import Path

# Objective metrics a spec may name. "availability" classifies by
# status; the rest compare a terminal-event latency to a threshold.
LATENCY_METRICS = ("ttft_ms", "tpot_ms", "queue_wait_ms")

DEFAULT_BURN_WINDOWS = ((60.0, 5.0), (300.0, 30.0))
DEFAULT_MAX_BURN = 10.0


@dataclasses.dataclass(frozen=True)
class Objective:
    """One SLO objective: `target` fraction of events must be good.
    threshold_ms separates good from bad for latency metrics; None for
    availability."""

    metric: str
    target: float
    threshold_ms: float | None = None

    def __post_init__(self):
        if self.metric != "availability" and self.metric not in LATENCY_METRICS:
            raise ValueError(
                f"objective metric {self.metric!r}: want 'availability' "
                f"or one of {LATENCY_METRICS}"
            )
        if not (0.0 < self.target < 1.0):
            raise ValueError(
                f"objective {self.metric}: target must be in (0, 1), "
                f"got {self.target}"
            )
        if self.metric != "availability" and self.threshold_ms is None:
            raise ValueError(
                f"objective {self.metric}: latency objectives need "
                "threshold_ms"
            )

    def classify(self, term: dict) -> bool | None:
        """good True / bad False / None (not an event for this
        objective) for one terminal-request field dict (the tick
        `terminal` entry / `request` record shape)."""
        status = term.get("status", "finished")
        if status == "cancelled":
            return None
        if self.metric == "availability":
            return status == "finished"
        if status != "finished":
            return None
        v = term.get(self.metric)
        if v is None:
            # The null-moment convention: a moment that was never
            # measured is not an event; calling it bad would fail a
            # healthy run.
            return None
        return v <= self.threshold_ms


def budget_remaining(good: int, bad: int, target: float) -> float | None:
    """Fraction of the run's error budget left: 1.0 = untouched, 0.0 =
    exactly exhausted, negative = overspent. The budget is
    (1 - target) * events; None with no events (nothing to judge)."""
    total = good + bad
    if total == 0:
        return None
    allowed = (1.0 - target) * total
    return 1.0 - bad / allowed


class WindowedEvents:
    """Good/bad events on one timeline with sliding-window counts.

    observe() is O(amortized 1) per (event, window); the deques hold
    (t, good) pairs inside each window and evict as time advances. The
    math reads only event times the producer stamped — no clock, no
    randomness — which is what makes burn evaluation replay-identical.
    """

    __slots__ = ("windows_s", "_dq", "_bad", "good", "bad", "max_burn")

    def __init__(self, windows_s):
        # Flat, deduplicated window lengths (a [long, short] pair shares
        # storage with any other pair naming the same length).
        self.windows_s = tuple(sorted({float(w) for pair in windows_s
                                       for w in pair}, reverse=True))
        self._dq = {w: deque() for w in self.windows_s}
        self._bad = {w: 0 for w in self.windows_s}
        self.good = 0
        self.bad = 0
        self.max_burn = {w: 0.0 for w in self.windows_s}

    def observe(self, t: float, good: bool, target: float) -> None:
        self.good += good
        self.bad += not good
        for w in self.windows_s:
            dq = self._dq[w]
            dq.append((t, good))
            self._bad[w] += not good
            while dq and dq[0][0] <= t - w:
                _, g = dq.popleft()
                self._bad[w] -= not g
            self.max_burn[w] = max(self.max_burn[w],
                                   self.burn_rate(w, target))

    def burn_rate(self, window_s: float, target: float) -> float:
        """Error-budget burn multiple over the window: bad fraction
        divided by the budgeted bad fraction (1 - target). 1.0 = the
        budget spends exactly at its sustainable rate."""
        dq = self._dq[window_s]
        if not dq:
            return 0.0
        return (self._bad[window_s] / len(dq)) / (1.0 - target)

    def worst_burn(self) -> float:
        return max(self.max_burn.values(), default=0.0)


class Accountant:
    """Per-(tenant, objective) windowed good/bad accounting: the one
    fold the streaming burn-rate alert rule (obs.alerts) and the SLO
    scheduler's burn pressure both drive."""

    def __init__(self, spec: "SLOSpec"):
        self.spec = spec
        # (tenant, metric) -> WindowedEvents
        self.events: dict[tuple[str, str], WindowedEvents] = {}

    def observe(self, term: dict, t: float):
        """Fold one terminal-request field dict at event time `t`;
        yields (tenant, objective, window_events, good) per objective
        the event scored under (the alert rule hooks this)."""
        tenant = term.get("tenant") or "default"
        for obj in self.spec.objectives(tenant):
            good = obj.classify(term)
            if good is None:
                continue
            key = (tenant, obj.metric)
            we = self.events.get(key)
            if we is None:
                we = self.events[key] = WindowedEvents(self.spec.windows)
            we.observe(t, good, obj.target)
            yield tenant, obj, we, good

    def observe_all(self, rec: dict, now: float):
        """Fold every `terminal` entry of one tick record at time
        `now` — the per-record form the streaming burn rule drives."""
        for term in rec.get("terminal") or ():
            yield from self.observe(term, now)

    def tenants(self) -> list[str]:
        return sorted({t for t, _ in self.events})


class SLOSpec:
    """Parsed SLO spec (module docstring grammar)."""

    def __init__(self, *, tenants: dict[str, list[Objective]],
                 windows=DEFAULT_BURN_WINDOWS,
                 max_burn: float = DEFAULT_MAX_BURN,
                 train: dict | None = None, rules: list[dict] | None = None,
                 max_alerts: int | None = None):
        if not tenants:
            raise ValueError("SLO spec: need at least one tenant entry "
                             '("*" covers every tenant)')
        self.tenants = tenants
        self.windows = tuple((float(lo), float(sh)) for lo, sh in windows)
        for lo, sh in self.windows:
            if not (lo > sh > 0):
                raise ValueError(
                    f"burn window [{lo}, {sh}]: want long_s > short_s > 0"
                )
        self.max_burn = float(max_burn)
        self.train = dict(train or {})
        self.rules = list(rules or ())
        self.max_alerts = max_alerts

    def objectives(self, tenant: str) -> list[Objective]:
        """The tenant's objectives (exact entry, else the "*" wildcard,
        else none — an unlisted tenant with no wildcard is not judged)."""
        return self.tenants.get(tenant, self.tenants.get("*", []))

    @classmethod
    def from_dict(cls, spec: dict) -> SLOSpec:
        tenants: dict[str, list[Objective]] = {}
        raw = spec.get("tenants")
        if not isinstance(raw, dict) or not raw:
            raise ValueError(
                'SLO spec: need a non-empty "tenants" object '
                '(use "*" for an all-tenants default)'
            )
        for tenant, objs in raw.items():
            if not isinstance(objs, dict):
                raise ValueError(
                    f"SLO spec: tenant {tenant!r} entry must be an object"
                )
            parsed = []
            for metric, v in objs.items():
                if metric == "availability":
                    parsed.append(Objective("availability", float(v)))
                else:
                    if not isinstance(v, dict):
                        raise ValueError(
                            f"SLO spec: {tenant}.{metric} must be "
                            '{"target": ..., "threshold_ms": ...}'
                        )
                    parsed.append(Objective(
                        metric, float(v["target"]),
                        threshold_ms=float(v["threshold_ms"]),
                    ))
            tenants[tenant] = parsed
        burn = spec.get("burn") or {}
        return cls(
            tenants=tenants,
            windows=burn.get("windows_s", DEFAULT_BURN_WINDOWS),
            max_burn=burn.get("max_rate", DEFAULT_MAX_BURN),
            train=spec.get("train"),
            rules=spec.get("rules"),
            max_alerts=spec.get("max_alerts"),
        )

    @classmethod
    def load(cls, path: str | Path) -> SLOSpec:
        try:
            return cls.from_dict(json.loads(Path(path).read_text()))
        except (KeyError, TypeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: bad SLO spec: {e}") from e


def default_spec() -> SLOSpec:
    """The spec applied with no --slo: availability 99% for every
    tenant, no latency objectives (thresholds are deployment-specific),
    default burn windows."""
    return SLOSpec(tenants={"*": [Objective("availability", 0.99)]})


def run_mode(rec: dict) -> str:
    """A record's run-scope key: its mode, with every "fleet/<name>"
    replica mode folded into the one logical mode "fleet" (the replicas
    of a fleet share one clock)."""
    mode = rec.get("mode", "?")
    return "fleet" if isinstance(mode, str) and mode.startswith("fleet/") \
        else mode


@dataclasses.dataclass
class Verdict:
    """One (tenant, objective) SLO verdict row."""

    tenant: str
    metric: str
    target: float
    threshold_ms: float | None
    events: int
    good: int
    bad: int
    worst_burn: float | None
    estimated: bool = False  # True when derived from histogram buckets

    @property
    def attainment(self) -> float | None:
        total = self.good + self.bad
        return self.good / total if total else None

    @property
    def budget_left(self) -> float | None:
        return budget_remaining(self.good, self.bad, self.target)

    @property
    def violated(self) -> bool:
        a = self.attainment
        return a is not None and a < self.target


def verdicts_from_terminals(terminals: list[tuple[float, str, dict]],
                            spec: SLOSpec) -> list[Verdict]:
    """Exact verdicts from (event_time, mode, terminal-field) triples —
    the full-log path (tick `terminal` entries or `request` records).

    Accounting is MODE-scoped before merging: a serve-bench file holds
    static and continuous runs of the same workload on two independent
    timelines, and windowed burn math assumes one non-decreasing clock
    — so each mode folds its own Accountant, then the verdict sums the
    good/bad counts and takes the worst burn across modes (the table
    stays per-tenant, as the health contract promises)."""
    accs: dict[str, Accountant] = {}
    for t, mode, term in terminals:
        acc = accs.get(mode)
        if acc is None:
            acc = accs[mode] = Accountant(spec)
        for _ in acc.observe(term, t):
            pass
    merged: dict[tuple[str, str], Verdict] = {}
    for acc in accs.values():
        for (tenant, metric), we in sorted(acc.events.items()):
            obj = next(o for o in spec.objectives(tenant)
                       if o.metric == metric)
            v = merged.get((tenant, metric))
            if v is None:
                v = merged[(tenant, metric)] = Verdict(
                    tenant=tenant, metric=metric, target=obj.target,
                    threshold_ms=obj.threshold_ms, events=0, good=0,
                    bad=0, worst_burn=0.0,
                )
            v.events += we.good + we.bad
            v.good += we.good
            v.bad += we.bad
            v.worst_burn = round(max(v.worst_burn, we.worst_burn()), 3)
    out = [merged[k] for k in sorted(merged)]
    judged = {v.tenant for v in out}
    # Spec-named tenants that saw no traffic still get zero-event rows:
    # a tenant silently receiving nothing is a finding, not a blank.
    for tenant in sorted(set(spec.tenants) - judged - {"*"}):
        for obj in spec.objectives(tenant):
            out.append(Verdict(
                tenant=tenant, metric=obj.metric, target=obj.target,
                threshold_ms=obj.threshold_ms, events=0, good=0, bad=0,
                worst_burn=None,
            ))
    return out


def hist_good_fraction(fields: dict, bounds: list[float],
                       threshold: float) -> tuple[int, float] | None:
    """(total, good fraction) of a Histogram.to_fields() dict against a
    threshold: full buckets at-or-under the threshold count good, the
    straddling bucket contributes linearly (the same interpolation the
    percentile estimator uses). Deterministic; None with no counts."""
    total = fields.get("count", 0)
    if not total:
        return None
    good = 0.0
    for i, c in fields.get("buckets", []):
        lo = bounds[i - 1] if i > 0 else 0.0
        hi = bounds[i] if i < len(bounds) else math.inf
        if hi <= threshold:
            good += c
        elif lo < threshold < hi:
            good += c * (threshold - lo) / (hi - lo)
    return total, good / total


def verdicts_from_summary(records: list[dict],
                          spec: SLOSpec) -> list[Verdict]:
    """Approximate verdicts for a summary-only run (`--log summary`
    storms keep per-tick JSONL out of the file): availability from the
    per-tenant status counts in the `serve` summaries, latency
    attainment ESTIMATED from the registry's log-bucket histograms
    (flagged `estimated` in the table — bucket interpolation, not exact
    counts). Burn rates need the event stream and stay None here.
    Multiple `serve` summaries (serve-bench's two modes) sum; the
    newest `metrics` snapshot per mode contributes its histograms
    (registries are per-mode and cumulative within one)."""
    from .metrics import log_bucket_bounds

    serves = [r for r in records if r.get("event") == "serve"]
    if not serves:
        return []
    statuses: dict[str, dict[str, int]] = {}
    for rec in serves:
        blocks = rec.get("tenants") or {
            "default": {"statuses": rec.get("statuses") or {}},
        }
        for tenant, block in blocks.items():
            per = statuses.setdefault(tenant, {})
            for st, n in (block.get("statuses") or {}).items():
                per[st] = per.get(st, 0) + n
    snaps: dict[str, dict] = {}
    for rec in records:
        if rec.get("event") == "metrics":
            snaps[run_mode(rec)] = rec  # newest per mode wins
    bounds = log_bucket_bounds()
    out = []
    for tenant, per in sorted(statuses.items()):
        for obj in spec.objectives(tenant):
            if obj.metric == "availability":
                good = per.get("finished", 0)
                bad = sum(n for st, n in per.items()
                          if st not in ("finished", "cancelled"))
                out.append(Verdict(
                    tenant=tenant, metric=obj.metric, target=obj.target,
                    threshold_ms=None, events=good + bad, good=good,
                    bad=bad, worst_burn=None,
                ))
                continue
            if tenant == "default" and len(statuses) > 1:
                # Untagged traffic has no per-tenant histogram twin, and
                # the global `serve.*` histogram also holds every TAGGED
                # tenant's observations — estimating "default" from it
                # in a mixed run would dilute the verdict with other
                # tenants' latencies. No estimate beats a wrong one;
                # availability above stays exact.
                continue
            name = (f"serve.tenant.{tenant}.{obj.metric}"
                    if tenant != "default" else f"serve.{obj.metric}")
            total = 0
            good_f = 0.0
            for snap in snaps.values():
                est = hist_good_fraction(
                    (snap.get("histograms") or {}).get(name, {}),
                    bounds, obj.threshold_ms)
                if est is not None:
                    total += est[0]
                    good_f += est[0] * est[1]
            if total == 0:
                continue
            good = int(round(good_f))
            out.append(Verdict(
                tenant=tenant, metric=obj.metric, target=obj.target,
                threshold_ms=obj.threshold_ms, events=total, good=good,
                bad=total - good, worst_burn=None, estimated=True,
            ))
    return out


def collect_terminals(records: list[dict]) -> list[tuple[float, str, dict]]:
    """(event_time, mode, terminal-fields) triples from one run's
    records.

    Prefers the per-tick `terminal` entries (streamed at the moment the
    request left the system — the same events the live alert engine
    folded); falls back to `request` records (their completion moment
    is arrival_s + latency_ms — the "t" stamp is when the producer
    LOGGED them, usually end of run). tpot for request records is
    derived with the one TPOT formula."""
    ticks = []
    for rec in records:
        if rec.get("event") != "tick":
            continue
        for term in rec.get("terminal") or ():
            ticks.append((rec.get("now", rec.get("t", 0.0)),
                          run_mode(rec), term))
    if ticks:
        return ticks
    out = []
    for rec in records:
        if rec.get("event") != "request":
            continue
        lat, ttft = rec.get("latency_ms"), rec.get("ttft_ms")
        tpot = None
        if (rec.get("status", "finished") == "finished" and lat is not None
                and ttft is not None):
            tpot = (lat - ttft) / max(rec.get("output_tokens", 1) - 1, 1)
        t = (rec.get("arrival_s", 0.0) or 0.0) + (lat or 0.0) / 1e3
        out.append((t, run_mode(rec), {
            "id": rec.get("id"),
            "tenant": rec.get("tenant") or "default",
            "status": rec.get("status", "finished"),
            "ttft_ms": ttft,
            "tpot_ms": tpot,
            "queue_wait_ms": rec.get("queue_wait_ms"),
        }))
    # Events must fold in time order WITHIN each mode: request records
    # are logged in rid order, not completion order, and windowed burn
    # math assumes a non-decreasing timeline.
    out.sort(key=lambda p: (p[1], p[0], p[2].get("id") or 0))
    return out


# -- training health ---------------------------------------------------

# Bounds `train` health rules apply when the spec does not override
# them: any loss doubling step-over-step is a spike, and a healthy CI
# run restarts zero times with zero non-finite steps.
TRAIN_DEFAULTS = {
    "loss_spike_pct": 100.0,
    "max_loss_spikes": 0,
    "max_restarts": 0,
    "max_nonfinite": 0,
    "step_ms_p99_ms": None,
}


@dataclasses.dataclass
class TrainVerdict:
    rule: str
    value: float | None
    bound: float | None
    violated: bool
    detail: str | None = None


def train_health(records: list[dict], spec: SLOSpec) -> list[TrainVerdict]:
    """Health rules over the training event stream: loss-spike count,
    step_ms p99 against a declared ceiling, restart and non-finite-step
    rates from the fault trail. Returns [] for runs with no train
    records (a serving file is not judged as a training run)."""
    from .metrics import Histogram

    trains = [r for r in records if r.get("event") == "train"]
    if not trains:
        return []
    cfg = {**TRAIN_DEFAULTS, **spec.train}
    out = []

    losses = [(r.get("step"), r["loss"]) for r in trains
              if isinstance(r.get("loss"), (int, float))]
    spikes = []
    for (_, prev), (step, cur) in zip(losses, losses[1:]):
        if prev > 0 and (cur - prev) / prev * 100.0 > cfg["loss_spike_pct"]:
            spikes.append(step)
    out.append(TrainVerdict(
        rule=f"loss_spike (> +{cfg['loss_spike_pct']:g}% per interval)",
        value=len(spikes), bound=cfg["max_loss_spikes"],
        violated=len(spikes) > cfg["max_loss_spikes"],
        detail=f"at steps {spikes}" if spikes else None,
    ))

    faults = [r for r in records if r.get("event") == "fault"]
    restarts = sum(1 for r in faults if r.get("kind") == "restart")
    nonfinite = sum(1 for r in faults if r.get("kind") == "nonfinite_step")
    out.append(TrainVerdict(
        rule="restarts", value=restarts, bound=cfg["max_restarts"],
        violated=restarts > cfg["max_restarts"],
    ))
    out.append(TrainVerdict(
        rule="nonfinite_steps", value=nonfinite, bound=cfg["max_nonfinite"],
        violated=nonfinite > cfg["max_nonfinite"],
    ))

    if cfg["step_ms_p99_ms"] is not None:
        snap = next((r for r in reversed(records)
                     if r.get("event") == "metrics"
                     and "train.step_ms" in (r.get("histograms") or {})),
                    None)
        p99 = None
        if snap is not None:
            h = Histogram.from_fields(snap["histograms"]["train.step_ms"])
            p99 = h.percentile(99)
        out.append(TrainVerdict(
            rule="step_ms_p99", value=None if p99 is None else round(p99, 3),
            bound=cfg["step_ms_p99_ms"],
            violated=p99 is not None and p99 > cfg["step_ms_p99_ms"],
        ))
    return out
