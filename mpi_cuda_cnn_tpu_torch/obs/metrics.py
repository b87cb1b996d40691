"""Serving percentiles: a copy of the reference's `obs.metrics.pct_nearest`,
the one convention `ServeResult.summary` and `tenant_block` use."""

from __future__ import annotations


def pct_nearest(vals: list[float], q: float) -> float | None:
    """Nearest-rank percentile (no interpolation): conservative at the
    tail on small request counts. None for an empty list."""
    s = sorted(vals)
    if not s:
        return None
    i = min(len(s) - 1, max(0, -(-int(q) * len(s) // 100) - 1))
    return round(s[i], 3)
