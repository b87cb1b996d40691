"""SLO-attained goodput: requests/s per chip that meet every objective
(counterpart of the reference's `obs/goodput.py`, the same code).

A request is good iff it finished and every latency objective its
tenant's SLO declares (ttft_ms, tpot_ms, queue_wait_ms: the joint, not
any single axis) holds at the objective's threshold. Goodput is good
requests over the run's duration; per chip divides by the serving chip
count (fleet replicas; 1 for a single engine). A pure fold over a
run's terminal events, like obs/slo.py, so two identical-seed runs
give identical goodput.

Two paths, in `health`'s order of fidelity:

1. exact: per-tick `terminal` entries or `request` records through the
   obs.slo accountant's own classify;
2. estimate: summary-only runs (`--log summary`): finished counts from
   statuses, per-axis good fractions from the registry's log-bucket
   histograms, the joint taken as their product (flagged `estimated`).

Results are `goodput` records (obs/schema.EVENT_KEYS): kind="run" for
one measured run, kind="candidate"/"frontier" for a capacity sweep.
"""

from __future__ import annotations

import dataclasses

from .schema import make_record
from .slo import (
    LATENCY_METRICS,
    SLOSpec,
    collect_terminals,
    hist_good_fraction,
    run_mode,
)


@dataclasses.dataclass
class Goodput:
    """One goodput measurement. `requests` is every terminal seen,
    `good` the joint-SLO-attained finished count. `thresholds` records
    the per-metric thresholds applied (wildcard-tenant view) so a
    stamped record is self-describing."""

    requests: int
    good: int
    duration_s: float
    chips: int
    estimated: bool
    thresholds: dict

    @property
    def goodput_rps(self) -> float | None:
        if self.duration_s <= 0:
            return None
        return self.good / self.duration_s

    @property
    def per_chip_rps(self) -> float | None:
        rps = self.goodput_rps
        return None if rps is None else rps / max(self.chips, 1)

    @property
    def good_fraction(self) -> float | None:
        return self.good / self.requests if self.requests else None

    def fields(self) -> dict:
        """Flat field dict (what `goodput` records and frontier rows
        carry; rounding pins the bitwise determinism contract)."""
        rps = self.goodput_rps
        per = self.per_chip_rps
        frac = self.good_fraction
        return {
            "requests": self.requests,
            "good": self.good,
            "duration_s": round(self.duration_s, 4),
            "chips": self.chips,
            "goodput_rps": None if rps is None else round(rps, 3),
            "per_chip_rps": None if per is None else round(per, 3),
            "good_fraction": None if frac is None else round(frac, 6),
            "estimated": self.estimated,
            "thresholds": self.thresholds,
        }


def latency_objectives(spec: SLOSpec, tenant: str) -> list:
    """The tenant's latency objectives (ttft/tpot/queue-wait — the
    joint goodput judges). Availability is implied by the finished
    requirement; a spec with NO latency objectives yields [] and the
    request is judged on finishing alone (degenerate but honest)."""
    return [o for o in spec.objectives(tenant)
            if o.metric in LATENCY_METRICS]


def spec_thresholds(spec: SLOSpec) -> dict:
    """{metric: threshold_ms} for the wildcard tenant — the stamp a
    goodput record carries so readers know what was judged."""
    return {o.metric: o.threshold_ms
            for o in latency_objectives(spec, "*")}


def is_good(term: dict, spec: SLOSpec) -> bool:
    """True iff one terminal-field dict finished and holds EVERY
    latency objective its tenant declares (obs.slo.Objective.classify
    — the one good/bad definition health verdicts use; a latency
    moment that was never measured counts as not-good here: goodput is
    a guarantee, and an unmeasured TTFT guarantees nothing)."""
    if term.get("status", "finished") != "finished":
        return False
    tenant = term.get("tenant") or "default"
    for obj in latency_objectives(spec, tenant):
        v = term.get(obj.metric)
        if v is None or v > obj.threshold_ms:
            return False
    return True


def goodput_from_terminals(terminals: list[tuple[float, str, dict]],
                           spec: SLOSpec, *, duration_s: float,
                           chips: int = 1) -> Goodput:
    """Exact goodput from (event_time, mode, terminal-field) triples
    (obs.slo.collect_terminals shape) over a known run duration."""
    good = sum(1 for _, _, term in terminals if is_good(term, spec))
    return Goodput(requests=len(terminals), good=good,
                   duration_s=duration_s, chips=chips, estimated=False,
                   thresholds=spec_thresholds(spec))


def _mode_durations(records: list[dict]) -> dict[str, float]:
    """Per-mode run duration: the serve summary's duration_s when
    stamped, else the newest timeline stamp seen for the mode."""
    out: dict[str, float] = {}
    for rec in records:
        mode = run_mode(rec)
        if rec.get("event") == "serve" and rec.get("duration_s"):
            out[mode] = max(out.get(mode, 0.0), float(rec["duration_s"]))
        elif rec.get("event") == "tick":
            now = rec.get("now", rec.get("t", 0.0)) or 0.0
            out.setdefault(mode, 0.0)
            out[mode] = max(out[mode], float(now))
    return out


def _chips_from_records(records: list[dict]) -> int:
    """Serving chip count: the fleet summary's replica count (initial
    — what the budget paid for, not what survived crashes), else 1."""
    for rec in reversed(records):
        if rec.get("event") == "serve":
            n = rec.get("replicas_initial") or rec.get("replicas")
            if n:
                return int(n)
    return 1


def goodput_from_summary(records: list[dict],
                         spec: SLOSpec, *, chips: int | None = None
                         ) -> Goodput | None:
    """Histogram-estimated goodput for a summary-only run: finished
    counts from the serve statuses, each latency axis' good fraction
    from the registry's log-bucket histograms, joint as their product
    (flagged estimated). None with nothing to judge."""
    from .metrics import log_bucket_bounds

    serves = [r for r in records if r.get("event") == "serve"]
    if not serves:
        return None
    requests = sum(r.get("requests") or 0 for r in serves)
    finished = sum((r.get("statuses") or {}).get("finished", 0)
                   for r in serves)
    duration = sum(r.get("duration_s") or 0.0 for r in serves)
    snaps: dict[str, dict] = {}
    for rec in records:
        if rec.get("event") == "metrics":
            snaps[run_mode(rec)] = rec  # newest per mode wins
    bounds = log_bucket_bounds()
    good_f = float(finished)
    for obj in latency_objectives(spec, "*"):
        total = 0
        frac = 0.0
        for snap in snaps.values():
            est = hist_good_fraction(
                (snap.get("histograms") or {}).get(f"serve.{obj.metric}",
                                                   {}),
                bounds, obj.threshold_ms)
            if est is not None:
                total += est[0]
                frac += est[0] * est[1]
        if total:
            good_f *= frac / total
    return Goodput(requests=requests, good=int(round(good_f)),
                   duration_s=duration,
                   chips=chips if chips else _chips_from_records(records),
                   estimated=True, thresholds=spec_thresholds(spec))


def goodput_from_records(records: list[dict], spec: SLOSpec,
                         *, chips: int | None = None) -> Goodput | None:
    """Goodput for one run's records: exact from the terminal trail
    when present, histogram estimate otherwise (the health fidelity
    order). None when the file holds nothing judgeable."""
    terminals = collect_terminals(records)
    if terminals:
        durs = _mode_durations(records)
        duration = sum(durs.values()) if durs else max(
            (t for t, _, _ in terminals), default=0.0)
        return goodput_from_terminals(
            terminals, spec, duration_s=duration,
            chips=chips if chips else _chips_from_records(records))
    return goodput_from_summary(records, spec, chips=chips)


def tenant_goodput_rps(records: list[dict], spec: SLOSpec
                       ) -> dict[str, float | None]:
    """Per-tenant attained goodput (requests/s per chip) for
    `health`'s verdict column — the SAME is_good fold, bucketed by
    tenant. None (em-dash) when the tenant declares no latency
    objectives or the file has no exact terminal trail (the estimate
    path has no per-tenant joint histograms — no estimate beats a
    wrong one, the health convention)."""
    terminals = collect_terminals(records)
    if not terminals:
        return {}
    durs = _mode_durations(records)
    duration = sum(durs.values()) if durs else max(
        (t for t, _, _ in terminals), default=0.0)
    chips = _chips_from_records(records)
    good: dict[str, int] = {}
    for _, _, term in terminals:
        tenant = term.get("tenant") or "default"
        good.setdefault(tenant, 0)
        if is_good(term, spec):
            good[tenant] += 1
    out: dict[str, float | None] = {}
    for tenant, n in sorted(good.items()):
        if not latency_objectives(spec, tenant) or duration <= 0:
            out[tenant] = None
        else:
            out[tenant] = round(n / duration / max(chips, 1), 3)
    return out


def goodput_record(g: Goodput, t: float, *, kind: str,
                   **extra) -> dict:
    """One `goodput` schema-family record (versioned via obs.schema)."""
    return make_record("goodput", t, kind=kind, **g.fields(), **extra)


def default_goodput_spec(ttft_ms: float = 500.0,
                         tpot_ms: float = 50.0) -> SLOSpec:
    """The spec goodput tools apply when no --slo names one: TTFT and
    TPOT thresholds for every tenant (targets are irrelevant to the
    per-request joint — 0.99 is a placeholder the dataclass demands)."""
    from .slo import Objective

    return SLOSpec(tenants={"*": [
        Objective("ttft_ms", 0.99, threshold_ms=float(ttft_ms)),
        Objective("tpot_ms", 0.99, threshold_ms=float(tpot_ms)),
    ]})
