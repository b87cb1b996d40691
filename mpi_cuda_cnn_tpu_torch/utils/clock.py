"""The one module that reads the host's real clocks (counterpart of the
reference's `utils/clock.py`; `lint` rule MCT002 allows these reads here
only): durations are measured with an injectable `clock` of
time.perf_counter's shape, and record "t" fields are relative; only a
run marker names the moment a run began, and only a wait on other
processes keeps a real deadline."""

from __future__ import annotations

import time


def utc_stamp(fmt: str = "%Y-%m-%dT%H:%M:%SZ") -> str:
    """The current UTC moment, formatted: for run markers only."""
    return time.strftime(fmt, time.gmtime())


def monotonic() -> float:
    """Seconds on the host's monotonic clock: for deadlines on other
    processes (waiting for spawned ranks to exit), never for a measured
    duration or a record field."""
    return time.monotonic()
