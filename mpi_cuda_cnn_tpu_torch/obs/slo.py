"""Declarative SLOs: per-tenant objectives, error budgets, burn rates
(the accounting half of the JAX package's `obs/slo.py`, stdlib only).

Every number is a pure fold over terminal-request events on the run's
own timeline (the engine's clock, a FakeClock in deterministic runs), so
two identical-seed runs give identical burn rates, and the SLO scheduler
that reads them makes identical decisions.

The spec is a JSON file::

    {"tenants": {"*": {"availability": 0.999,
                       "ttft_ms":  {"target": 0.95, "threshold_ms": 500},
                       "tpot_ms":  {"target": 0.95, "threshold_ms": 100},
                       "queue_wait_ms": {"target": 0.9,
                                         "threshold_ms": 1000}},
                 "t0": {"availability": 0.9999}},
     "burn": {"windows_s": [[60, 5], [300, 30]], "max_rate": 10.0},
     "rules": [ ...extra obs.alerts rules... ],
     "max_alerts": 0}

- `tenants` maps a tenant name (or the "*" wildcard) to its objectives:
  `availability` is a bare target fraction; the latency objectives pair
  a target with the threshold that separates good from bad.
- `burn` configures multi-window multi-burn-rate alerting: each
  [long_s, short_s] pair fires only when BOTH windows burn faster than
  `max_rate` (burn rate 1.0 = spending exactly the error budget over
  the window).
- `train`, `rules` and `max_alerts` are carried for the alert engine.

Good/bad: availability counts finished as good and expired/failed/
rejected as bad (cancelled is no event); latency objectives count
finished requests only, good iff the value is at or under the threshold.
Left out here: the end-of-run verdicts and training health of the JAX
package's module.
"""

from __future__ import annotations

import dataclasses
import json
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

