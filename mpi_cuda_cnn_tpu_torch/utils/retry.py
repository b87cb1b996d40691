"""Exponential backoff with jitter: the one delay formula of every retry
loop (a copy of the reference's `utils/retry.py`).

`faults.supervise` paces crash-restart attempts with it: an immediate
restart against a sick filesystem or coordinator only reproduces the
crash faster. delay = base * 2^attempt * (1 + U[0,1)), where the jitter
de-synchronizes retriers hammering one recovering dependency.
"""

from __future__ import annotations

import random


def backoff_delay(attempt: int, base: float, jitter=random.random) -> float:
    """Delay in seconds before retry number `attempt` (0-based: the delay
    after the first failure is attempt 0). `jitter` returns U[0,1); tests
    pass a constant."""
    if base <= 0:
        return 0.0
    return base * (2 ** attempt) * (1.0 + jitter())
