"""Automatic plan minimization: ddmin over entries, then coordinates.

A sampled violation usually arrives wrapped in noise — four faults in
the plan, three irrelevant. Classic delta debugging (ddmin) strips the
plan to a locally-minimal entry set: every remaining fault is
necessary (removing any one makes the episode pass). A second pass
then minimizes INSIDE each surviving entry — trigger ticks walk down
toward the site's floor, optional params drop, numeric params shrink —
so the emitted repro is not just few faults but the *earliest,
plainest* spelling of each. Both passes re-run the fully deterministic
episode at every probe (the bitwise re-run guarantee is what makes a
probe's verdict trustworthy), and verdicts are cached by plan
spelling so the search never pays for the same probe twice.

The minimization target is "still fails the oracle", not "fails the
same way" — with one caveat: probes are only accepted while the
violation CLASS set stays within the original's (a probe that trades a
replay drift for a config-error exception would minimize into a
different bug)."""

from __future__ import annotations

import dataclasses

from ..faults import Fault, format_plan, parse_plan
from .episode import EpisodeConfig, run_episode

# Optional per-kind args the coordinate pass may DROP outright.
# Required ones (replica targets, pool names) stay: dropping them
# re-targets the fault (replica defaults to r0, pool_crash without a
# pool is a config error) — a different schedule, not a smaller one.
# "kind" is the transport message-kind filter: dropping it
# widens the fault to ANY message, a strictly plainer spelling.
_DROPPABLE = ("zombie_ticks", "kind")
# Numeric args the coordinate pass walks toward their floor. count=1
# is one faulted message; ticks=1 is the shortest delay / partition
# window the transport grammar accepts.
_SHRINK_FLOORS = {"replicas": 1, "page": 0, "count": 1, "ticks": 1}


class _Prober:
    """Run-and-cache: one oracle verdict per distinct plan spelling."""

    def __init__(self, cfg: EpisodeConfig, allowed_checks: set[str]):
        self.cfg = cfg
        self.allowed = allowed_checks
        self.cache: dict[str, bool] = {}
        self.episodes = 0

    def fails(self, plan: list[Fault]) -> bool:
        spec = format_plan(plan)
        hit = self.cache.get(spec)
        if hit is not None:
            return hit
        self.episodes += 1
        res = run_episode(dataclasses.replace(self.cfg, plan=spec))
        checks = {v["check"] for v in res.violations}
        verdict = bool(checks) and checks <= self.allowed
        self.cache[spec] = verdict
        return verdict


def _ddmin(plan: list[Fault], fails) -> list[Fault]:
    """Zeller's ddmin over plan entries: probe complements of an
    n-granular partition, refining granularity until single-entry
    removals all pass — the standard locally-minimal guarantee."""
    n = 2
    while len(plan) >= 2:
        chunk = max(1, len(plan) // n)
        reduced = False
        for start in range(0, len(plan), chunk):
            candidate = plan[:start] + plan[start + chunk:]
            if candidate and fails(candidate):
                plan = candidate
                n = max(n - 1, 2)
                reduced = True
                break
        if reduced:
            continue
        if chunk == 1:
            break
        n = min(n * 2, len(plan))
    return plan


def _floor_at(site: str) -> int:
    """The smallest meaningful trigger per site class: fleet ticks
    start at 1 (a tick-0 fault fires before any dispatch exists);
    fleet.transport arms on the same tick counter; sequence-numbered
    sites start at 0 (the first handoff/spill)."""
    return 1 if site in ("fleet.tick", "fleet.transport") else 0


def _shrink_entry(plan: list[Fault], i: int, fails) -> list[Fault]:
    """Coordinate minimization for entry i: trigger tick first (floor,
    then repeated halving toward it), then droppable args, then numeric
    args toward their floors. Greedy, re-probing each move."""
    def attempt(f: Fault) -> bool:
        candidate = plan[:i] + [f] + plan[i + 1:]
        if fails(candidate):
            plan[i] = f
            return True
        return False

    f = plan[i]
    floor = _floor_at(f.site)
    # Trigger tick: try the floor outright, else binary-walk down.
    if f.at > floor and not attempt(dataclasses.replace(f, at=floor)):
        lo, hi = floor, plan[i].at
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if attempt(dataclasses.replace(plan[i], at=mid)):
                hi = mid
            else:
                lo = mid
    for key in _DROPPABLE:
        if key in plan[i].args:
            args = {k: v for k, v in plan[i].args.items() if k != key}
            attempt(dataclasses.replace(plan[i], args=args))
    for key, kfloor in _SHRINK_FLOORS.items():
        val = plan[i].args.get(key)
        if isinstance(val, int) and val > kfloor:
            args = dict(plan[i].args)
            args[key] = kfloor
            attempt(dataclasses.replace(plan[i], args=args))
    return plan


def shrink(cfg: EpisodeConfig) -> tuple[str, int]:
    """Minimize cfg.plan while the episode keeps failing the oracle
    with the same violation classes. Returns (minimal plan string,
    episodes probed). Raises ValueError if the starting episode does
    not fail — shrinking a passing plan is a caller bug."""
    first = run_episode(cfg)
    if first.ok:
        raise ValueError("shrink() on a passing episode: nothing to "
                         "minimize")
    allowed = {v["check"] for v in first.violations}
    prober = _Prober(cfg, allowed)
    prober.cache[cfg.plan] = True
    plan = parse_plan(cfg.plan)
    plan = _ddmin(plan, prober.fails)
    for i in range(len(plan)):
        plan = _shrink_entry(plan, i, prober.fails)
    return format_plan(plan), prober.episodes
