"""Tracing spans: one name in the profiler trace and in the JSONL stream
(counterpart of the reference's `obs/trace.py`).

- `annotate(name)`: `torch.profiler.record_function`, so the region's
  host ops and launches carry the name in a `--profile-dir` trace (the
  reference's `jax.named_scope`).
- `span(name, metrics=...)`: a host region. Spans nest through a
  per-thread stack and their names join with '/' ("epoch/eval"); each
  is also a `record_function` range; on exit, with a metrics logger,
  one {"event": "span", "name", "ms"} record. A span measures host wall
  time: it waits for no device work.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_state = threading.local()


def _stack() -> list[str]:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def current_path() -> str:
    """The '/'-joined path of this thread's open spans ('' at the top)."""
    return "/".join(_stack())


def annotate(name: str):
    """A named range of the profiler's trace."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def span(name: str, metrics=None, **fields):
    """A named host span; logs a "span" record through `metrics` (a
    `utils.logging.MetricsLogger`, or None for none) on exit."""
    stack = _stack()
    stack.append(name)
    path = "/".join(stack)
    t0 = time.perf_counter()
    try:
        with annotate(path):
            yield path
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        stack.pop()
        if metrics is not None:
            metrics.log("span", name=path, ms=round(ms, 3), **fields)
