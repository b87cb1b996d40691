"""Runtime metrics (counterpart of the reference's `obs/metrics.py`):
the serving percentile convention (`pct_nearest`, which
`ServeResult.summary` and `tenant_block` use) and the trainers' registry
of counters, gauges and log-bucket histograms, whose snapshots are
`metrics` records (`obs/schema.py`). The registry's arithmetic reads no
clock, so equal observations give equal snapshots.
"""

from __future__ import annotations

import math
import time

from .schema import make_record, validate_record


def pct_nearest(vals: list[float], q: float) -> float | None:
    """Nearest-rank percentile (no interpolation): conservative at the
    tail on small request counts. None for an empty list."""
    s = sorted(vals)
    if not s:
        return None
    i = min(len(s) - 1, max(0, -(-int(q) * len(s) // 100) - 1))
    return round(s[i], 3)


# Histogram edges: 1e-2 .. 1e5 (milliseconds) at 10 buckets a decade.
DEFAULT_LO = 1e-2
DEFAULT_HI = 1e5
BUCKETS_PER_DECADE = 10


def log_bucket_bounds(lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                      per_decade: int = BUCKETS_PER_DECADE) -> list[float]:
    """Upper bounds of log-spaced buckets over [lo, hi], a function of
    its arguments alone (the reference's edges, so each package's
    readers rebuild the other's histograms)."""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    n = int(round(math.log10(hi / lo) * per_decade))
    return [lo * 10 ** (i / per_decade) for i in range(1, n + 1)]


class Counter:
    """A monotonically increasing total."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        self.value += amount


class Gauge:
    """The last value set, with its running min and max."""

    __slots__ = ("value", "lo", "hi")

    def __init__(self):
        self.value = self.lo = self.hi = None

    def set(self, value: float) -> None:
        value = float(value)
        self.value = value
        self.lo = value if self.lo is None else min(self.lo, value)
        self.hi = value if self.hi is None else max(self.hi, value)


class Histogram:
    """Counts in fixed log-spaced buckets (`bounds` are upper bounds; a
    last bucket takes what lies above them) with the exact count, sum,
    min and max. Observing the same values gives the same state."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds: list[float] | None = None):
        self.bounds = (list(bounds) if bounds is not None
                       else log_bucket_bounds())
        if any(b <= a for a, b in zip(self.bounds, self.bounds[1:])):
            raise ValueError("histogram bounds must be ascending")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = self.max = None

    def observe(self, value: float) -> None:
        value = float(value)
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    def percentile(self, q: float) -> float | None:
        """The q-th percentile (0..100) estimated from the bucket counts
        by linear interpolation inside the winning bucket, clamped to the
        exact observed min and max (so p0 and p100 are exact)."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else (
                    self.min if self.min is not None else 0.0)
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (rank - seen) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def to_fields(self) -> dict:
        """The record form: the nonzero buckets as [index, count] pairs."""
        return {
            "count": self.count,
            "sum": round(self.sum, 4),
            "min": self.min if self.min is None else round(self.min, 4),
            "max": self.max if self.max is None else round(self.max, 4),
            "buckets": [[i, c] for i, c in enumerate(self.counts) if c],
        }

    @classmethod
    def from_fields(cls, fields: dict,
                    bounds: list[float] | None = None) -> Histogram:
        """Rebuild from to_fields() output (the reader's half: `top` and
        `report` take percentiles of a record's histogram)."""
        h = cls(bounds)
        for i, c in fields.get("buckets", []):
            h.counts[i] = int(c)
        h.count = int(fields.get("count", sum(h.counts)))
        h.sum = float(fields.get("sum", 0.0))
        h.min = fields.get("min")
        h.max = fields.get("max")
        return h


class MetricsRegistry:
    """One run's named counters, gauges and histograms, and their
    snapshots as `metrics` records (the reference's registry). `clock`
    (time.perf_counter's shape) stamps a snapshot and is read nowhere
    else."""

    def __init__(self, *, clock=None):
        self._clock = clock if clock is not None else time.perf_counter
        self._t0 = self._clock()
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def inc(self, name: str, amount: float = 1.0) -> None:
        self.counters.setdefault(name, Counter()).inc(amount)

    def set(self, name: str, value: float) -> None:
        self.gauges.setdefault(name, Gauge()).set(value)

    def observe(self, name: str, value: float | None) -> None:
        """None is skipped (a moment that never happened)."""
        if value is not None:
            self.histograms.setdefault(name, Histogram()).observe(value)

    def snapshot_fields(self, **extra) -> dict:
        """The `metrics` record's fields."""
        return {
            "counters": {k: round(c.value, 6)
                         for k, c in sorted(self.counters.items())},
            "gauges": {k: {"value": g.value, "lo": g.lo, "hi": g.hi}
                       for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.to_fields()
                           for k, h in sorted(self.histograms.items())},
            **extra,
        }

    def snapshot(self, **extra) -> dict:
        """A validated `metrics` record stamped with the clock."""
        return validate_record(make_record(
            "metrics", self._clock() - self._t0,
            **self.snapshot_fields(**extra)))

    def emit(self, metrics, **extra) -> None:
        """Log one snapshot through a MetricsLogger whose JSONL sink is
        open (nothing otherwise)."""
        if metrics is not None and metrics.jsonl_enabled:
            metrics.log("metrics", **self.snapshot_fields(**extra))


def percentiles_from_record(rec: dict, name: str,
                            qs=(50, 95, 99)) -> dict[str, float | None]:
    """p50/p95/p99 (by default) of one named histogram inside a
    `metrics` record, the reader's helper `top` and `report` share."""
    fields = rec.get("histograms", {}).get(name)
    if not fields:
        return {f"p{q}": None for q in qs}
    h = Histogram.from_fields(fields)
    return {f"p{q}": h.percentile(q) for q in qs}
