"""Profiling hooks (counterpart of the reference's `utils/profiling.py`):
a step timer that splits wall time into phases, and a profiler trace of a
region (`torch.profiler` in the place of `jax.profiler`).

The phases (the "step_phases" record's `phases_ms` keys):
  data        host batch assembly: indexing, normalizing, the copy over
  dispatch    the step call; on a card it returns once the launches are
              queued, so this is host time
  device      waiting for the card at a sync point
  checkpoint  checkpoint snapshots and their hand-off to the writer
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

STEP_PHASES = ("data", "dispatch", "device", "checkpoint")


class StepTimer:
    """Per-step wall time, split into phases. `clock` has
    time.perf_counter's shape (a fake clock makes it deterministic).

        timer.start()
        with timer.phase("data"): ...
        with timer.phase("dispatch"): ...
        timer.stop(n_steps)
    """

    def __init__(self, *, clock=None):
        self._clock = clock if clock is not None else time.perf_counter
        self.reset()

    def reset(self) -> None:
        self.steps = 0
        self.total_s = 0.0
        self.excluded_s = 0.0
        self.phase_s: dict[str, float] = {}
        self._t0 = None
        self._excluded_steps = 0

    def start(self) -> None:
        self._t0 = self._clock()

    def stop(self, n_steps: int = 1) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        dt = self._clock() - self._t0
        self._t0 = None
        self.steps += n_steps - self._excluded_steps
        self._excluded_steps = 0
        self.total_s += dt
        return dt

    @contextlib.contextmanager
    def phase(self, name: str):
        """Add the block's wall time to phase `name`."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.phase_s[name] = (self.phase_s.get(name, 0.0)
                                  + self._clock() - t0)

    @contextlib.contextmanager
    def exclude(self, steps: int = 0):
        """Take the block's wall time out of the running interval (kept
        in `excluded_s`), and the `steps` steps it runs out of the next
        `stop`'s count, so the mean is over the steps timed."""
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            self.excluded_s += dt
            self._excluded_steps += steps
            if self._t0 is not None:
                self._t0 += dt

    def add(self, seconds: float, n_steps: int = 1) -> None:
        """Fold in an interval measured elsewhere."""
        self.total_s += seconds
        self.steps += n_steps

    @property
    def mean_step_ms(self) -> float:
        return 1000.0 * self.total_s / max(self.steps, 1)

    def phases_ms(self) -> dict[str, float]:
        """Mean milliseconds a step by phase, and the unattributed rest of
        the interval as "other"."""
        n = max(self.steps, 1)
        out = {k: round(1000.0 * v / n, 4) for k, v in self.phase_s.items()}
        other = self.total_s - sum(self.phase_s.values())
        if self.phase_s and other > 0:
            out["other"] = round(1000.0 * other / n, 4)
        return out


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """With `logdir`, a `torch.profiler` trace of the block (the CPU, and
    CUDA when a card is there), written into `logdir` as a Chrome trace
    that TensorBoard and Perfetto open: `trace.json`, or
    `trace.rank<r>.json` for each rank of a world of several; also when
    the block raises. Without `logdir`, nothing."""
    if not logdir:
        yield
        return
    import torch
    import torch.distributed as dist

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    name = "trace.json"
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        name = f"trace.rank{dist.get_rank()}.json"
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / name))
