"""Online goodput autoscaler for the serving fleet (a copy of the JAX
package's `serve/autoscale.py`).

The running fleet folds its own live signals into replica join/leave
decisions every tick, so a diurnal workload is served by the capacity
it needs rather than the capacity its peak needed. Three signals:

- **Queue pressure**: mean per-replica load (queue depth + running
  slots + same-tick dispatches, the router's gauge) plus the
  re-dispatch backlog. Above `high` long enough: scale out; below `low`
  long enough: scale in. Between the two the fleet is left alone.
- **Burn rate** (`obs/slo.py`): the same windowed Accountant fold the
  alert rules use. A stream burning error budget faster than `burn` in
  every configured window forces up-pressure even while queues are
  shallow.
- **Goodput frontier** (optional): the frontier record of a capacity
  plan (`load_frontier`) gives a per-chip good-request rate, which
  turns the observed dispatch rate into a target replica count
  (ceil(rate / per_chip_rps), clamped to [min, max]).

A decision must hold for `up`/`down` consecutive ticks, and every
applied decision opens a cooldown paced by utils/retry.backoff_delay
with direction reversals as the attempt count, so an oscillating policy
backs off. Every input is host-side fleet state under the FakeClock and
the jitter defaults to 0.5, so identical-seed storms give the same
scale-event log bit for bit (scale_crc).
"""

from __future__ import annotations

import dataclasses
import json
import math
from collections import deque
from pathlib import Path

from ..obs.slo import Accountant, SLOSpec
from ..utils.retry import backoff_delay

__all__ = ["AutoscalePolicy", "Autoscaler", "load_frontier",
           "parse_autoscale"]


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The policy knobs (grammar: `parse_autoscale`). Defaults are the
    diurnal storm's shape: scale out fast (3 consecutive hot ticks),
    scale in slow (200 calm ticks — capacity is cheap to hold for a
    moment and expensive to re-warm), cooldown ~50 fleet ticks at the
    default 1 ms tick."""

    min_replicas: int = 1
    max_replicas: int = 8
    high: float = 4.0          # mean load per replica that means "hot"
    low: float = 1.0           # mean load per replica that means "calm"
    up_ticks: int = 3          # consecutive hot ticks before scale-out
    down_ticks: int = 200      # consecutive calm ticks before scale-in
    cooldown_s: float = 0.05   # backoff_delay base between decisions
    max_burn: float = 0.0      # burn-rate trip point; 0 = burn feed off

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"autoscale bounds: want 1 <= min <= max, got "
                f"min={self.min_replicas} max={self.max_replicas}")
        if not (0.0 <= self.low < self.high):
            raise ValueError(
                f"autoscale thresholds: want 0 <= low < high, got "
                f"low={self.low} high={self.high}")
        if self.up_ticks < 1 or self.down_ticks < 1:
            raise ValueError(
                f"autoscale streaks: want up/down >= 1, got "
                f"up={self.up_ticks} down={self.down_ticks}")
        if self.cooldown_s < 0.0:
            raise ValueError(
                f"autoscale cooldown must be >= 0, got {self.cooldown_s}")


_FIELDS = {
    "min": ("min_replicas", int), "max": ("max_replicas", int),
    "high": ("high", float), "low": ("low", float),
    "up": ("up_ticks", int), "down": ("down_ticks", int),
    "cooldown": ("cooldown_s", float), "burn": ("max_burn", float),
}


def parse_autoscale(spec: str) -> AutoscalePolicy:
    """`--autoscale` grammar: comma-separated `key=value` pairs over
    min/max/high/low/up/down/cooldown/burn (any subset; the rest keep
    their defaults), e.g. `min=1,max=6,high=6,low=0.5,burn=10`. The
    bare string 'on' takes every default."""
    kw = {}
    body = spec.strip()
    if body and body != "on":
        for part in body.split(","):
            key, sep, val = part.partition("=")
            key = key.strip()
            if not sep or key not in _FIELDS:
                raise ValueError(
                    f"autoscale spec {spec!r}: bad term {part!r} — want "
                    f"key=value with key one of {sorted(_FIELDS)}")
            name, cast = _FIELDS[key]
            try:
                kw[name] = cast(val)
            except ValueError:
                raise ValueError(
                    f"autoscale spec {spec!r}: {key}={val!r} is not "
                    f"a valid {cast.__name__}") from None
    return AutoscalePolicy(**kw)


def load_frontier(path: str | Path) -> float:
    """The committed autosize frontier's per-chip good-request rate:
    the `kind="frontier"` goodput record's `best_per_chip_rps` (the
    last one wins if the JSONL holds several sweeps) — the one number
    that converts an observed request rate into a replica count."""
    per_chip = None
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if rec.get("event") == "goodput" and rec.get("kind") == "frontier":
            v = rec.get("best_per_chip_rps")
            if v is not None:
                per_chip = float(v)
    if per_chip is None or per_chip <= 0:
        raise ValueError(
            f"{path}: no goodput frontier record with best_per_chip_rps "
            "> 0 — run `python -m mpi_cuda_cnn_tpu_torch autosize "
            "--metrics-jsonl` to produce one")
    return per_chip


class Autoscaler:
    """The runtime policy engine the fleet consults once per tick
    (Fleet._autoscale_step). Stateful but never digested: its decisions
    act only through mirrored join/leave events, so the replay
    reconstruction needs none of this state.

    `slo_spec` (an obs.slo.SLOSpec) switches the burn-rate feed on —
    the fleet passes every fence-accepted terminal through
    observe_terminal. `per_chip_rps` (load_frontier's number) switches
    the frontier target on. `jitter` has the random.random call shape
    and feeds the cooldown's backoff_delay; the default 0.5 keeps
    pacing deterministic (the FakeClock contract)."""

    def __init__(self, policy: AutoscalePolicy | None = None, *,
                 slo_spec: SLOSpec | None = None,
                 per_chip_rps: float = 0.0,
                 rate_window_s: float = 2.0, jitter=None):
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.acct = Accountant(slo_spec) if slo_spec is not None else None
        self.per_chip_rps = per_chip_rps
        self.rate_window_s = rate_window_s
        self.jitter = jitter if jitter is not None else (lambda: 0.5)
        self._burn_hot = False     # latched by observe, drained by step
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = -1.0
        self._last_dir: str | None = None
        self._flips = 0            # consecutive direction reversals
        self._hist: deque[tuple[float, int]] = deque()  # (now, dispatched)

    # -- signal feeds ---------------------------------------------------

    def observe_terminal(self, term: dict, now: float) -> None:
        """Fold one fence-accepted terminal's SLO classification. Trips
        the burn latch when ANY (tenant, objective) stream burns past
        `max_burn` across every window — the multiwindow AND, so one
        transient bad event can't trip it alone."""
        if self.acct is None:
            return
        for _tenant, obj, we, _good in self.acct.observe(term, now):
            if self.policy.max_burn > 0 and all(
                    we.burn_rate(w, obj.target) > self.policy.max_burn
                    for w in we.windows_s):
                self._burn_hot = True

    # -- the decision ---------------------------------------------------

    def _rate(self, now: float, dispatched: int) -> float:
        """Observed dispatch rate (req/s) over the trailing window —
        the demand estimate the frontier target divides."""
        self._hist.append((now, dispatched))
        while (len(self._hist) > 1
               and self._hist[0][0] <= now - self.rate_window_s):
            self._hist.popleft()
        t0, d0 = self._hist[0]
        if now <= t0:
            return 0.0
        return (dispatched - d0) / (now - t0)

    def step(self, *, now: float, live: int, load: float,
             dispatched: int) -> str | None:
        """One consult: "up", "down", or None. `live` is the count of
        dispatch-taking members in the governed pool, `load` their
        summed load plus the re-dispatch backlog, `dispatched` the
        fleet's cumulative dispatch count (the rate source)."""
        pol = self.policy
        rate = self._rate(now, dispatched)
        pressure = load / max(live, 1)
        burn_hot, self._burn_hot = self._burn_hot, False
        want_up = pressure > pol.high or burn_hot
        want_down = pressure < pol.low and not burn_hot
        if self.per_chip_rps > 0:
            target = max(pol.min_replicas,
                         min(pol.max_replicas,
                             math.ceil(rate / self.per_chip_rps)))
            # The frontier target adds up-pressure below it and GATES
            # scale-in above it; the queue/burn signals keep their say,
            # so a mis-calibrated frontier can't pin a drowning fleet.
            want_up = want_up or live < target
            want_down = want_down and live > target
        self._up_streak = self._up_streak + 1 if want_up else 0
        self._down_streak = self._down_streak + 1 if want_down else 0
        if now < self._cooldown_until:
            return None
        direction = None
        if (want_up and self._up_streak >= pol.up_ticks
                and live < pol.max_replicas):
            direction = "up"
        elif (want_down and self._down_streak >= pol.down_ticks
                and live > pol.min_replicas):
            direction = "down"
        if direction is None:
            return None
        self._flips = (self._flips + 1
                       if (self._last_dir is not None
                           and direction != self._last_dir) else 0)
        self._last_dir = direction
        self._up_streak = self._down_streak = 0
        self._cooldown_until = now + backoff_delay(
            self._flips, pol.cooldown_s, self.jitter)
        return direction
