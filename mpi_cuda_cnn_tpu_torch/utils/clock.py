"""The one reading of the absolute wall clock (counterpart of the
reference's `utils/clock.py`): durations are measured with an injectable
`clock` of time.perf_counter's shape, and record "t" fields are relative;
only a run marker names the moment a run began."""

from __future__ import annotations

import time


def utc_stamp(fmt: str = "%Y-%m-%dT%H:%M:%SZ") -> str:
    """The current UTC moment, formatted: for run markers only."""
    return time.strftime(fmt, time.gmtime())
