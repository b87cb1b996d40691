"""Two-point timing of one call (counterpart of the reference's
`utils/sync.py` `scan_two_point`).

A window of m calls costs m * t plus a fixed cost (the first launch, the
closing sync); timing a window of n calls and one of 2n calls and taking
(T(2n) - T(n)) / n cancels the fixed cost, as the reference's recipe does
for its jitted scan windows. Eager PyTorch needs no scan: there is no
common-subexpression or dead-code elimination to defeat, so a window is
n plain calls.
"""

from __future__ import annotations

import statistics
import time

import torch


def two_point_ms(fn, n: int, *args, reps: int = 3) -> float:
    """Per-call milliseconds of `fn(*args)`: the median over `reps` of
    (T(2n) - T(n)) / n, after one warm-up window of n calls. On the card a
    window is timed between two CUDA events with one synchronize at its
    end (never one per call); with no CUDA tensor among `args`, by
    `time.perf_counter`."""
    if n < 1 or reps < 1:
        raise ValueError(f"two_point_ms: n {n} and reps {reps} must be >= 1")
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)

    def window(m: int) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(m):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        for _ in range(m):
            fn(*args)
        return 1e3 * (time.perf_counter() - t0)

    window(n)
    samples = []
    for _ in range(reps):
        t1 = window(n)
        t2 = window(2 * n)
        samples.append((t2 - t1) / n)
    return statistics.median(samples)
