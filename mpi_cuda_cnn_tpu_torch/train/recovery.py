"""Crash safety of one trainer: its checkpoints, fault hooks, NaN guard
and preemption drain, shared by the CNN `Trainer` and the `LMTrainer`
(the reference's trainers each carry these hooks, `train/trainer.py`
:364-466 and `train/lm_trainer.py`:619-777).

A `Recovery` is built from the trainer's config (`checkpoint_dir`,
`async_checkpoint`, `nan_policy`, `nan_max_bad`, `elastic_width`), its
mesh and its optimizer. It saves and restores the trainer's state
{"params", "opt_state", "step"} as the reference's checkpoint arrays
(`convert.checkpoint_arrays`), only rank 0 writing and every rank
meeting it at a barrier (`parallel.distributed`); the resume and the
rollback read the newest file that verifies, after a barrier, on every
rank; a trainer whose ranks hold blocks of the state gives its own
`codec` (the arrays of the whole state made on every rank, and each
rank's share of restored arrays installed). In a world of several ranks
the ranks agree on a preemption at every step boundary (one all-reduce
of the flags over the world), whatever the mesh: a signal that reaches
one rank drains them all at the same step, so that no rank meets the
snapshot's barrier (or, on a sharded mesh, the collective that makes its
arrays) while its peers enter the next step's collectives. A world of
one rank makes no collective. The NaN guard checks a step
on the device and undoes a bad update from a device copy of the state
taken before it (the update runs in place), leaving the step counter
advanced: it counts batches consumed, so a later resume lands on the
data position.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..convert import checkpoint_arrays, load_checkpoint_arrays
from ..faults import (
    MAX_NAN_ROLLBACKS,
    NanGuard,
    NonFiniteLossError,
    PreemptionGuard,
    drain_preemption,
    step_is_finite,
)
from ..models.layers import tree_leaves
from ..parallel.distributed import barrier, process_info
from ..parallel.dp import all_reduce_sum
from ..parallel.mesh import describe_mesh
from .checkpoint import AsyncCheckpointer, restore_latest, validate_resume_meta


def _state_tensors(state: dict) -> list[torch.Tensor]:
    """Every tensor of a train state: the params' leaves, then the
    optimizer's per-leaf lists (SGD's trace, AdamW's mu and nu)."""
    opt = state["opt_state"]
    return tree_leaves(state["params"]) + [
        t for k in sorted(opt) if isinstance(opt[k], list) for t in opt[k]]


class Recovery:
    """The crash-safety hooks of one trainer (see the module docstring).
    `faults` is a `faults.FaultInjector` shared across a supervised run's
    attempts, `preempt` the caller's `faults.PreemptionGuard` (by default
    one that answers planned preempt faults only)."""

    def __init__(self, cfg, mesh, optimizer, *, metrics, logger,
                 faults=None, preempt: PreemptionGuard | None = None,
                 codec=None):
        self.cfg = cfg
        self.codec = codec
        self.mesh = mesh
        self.optimizer = optimizer
        self.metrics = metrics
        self.log = logger
        self.faults = faults
        self.preempt = preempt if preempt is not None else PreemptionGuard()
        self.nan = NanGuard(cfg.nan_policy, cfg.nan_max_bad)
        self.rollbacks = 0
        self._snap: list[torch.Tensor] | None = None
        proc = process_info()
        self.ckpt = (AsyncCheckpointer(
            cfg.checkpoint_dir, async_=cfg.async_checkpoint, faults=faults,
            process=proc, barrier=barrier,
            meta={"mesh": describe_mesh(mesh),
                  "elastic_width": cfg.elastic_width,
                  "process_count": proc.process_count})
            if cfg.checkpoint_dir else None)

    def arrays(self, state: dict) -> dict:
        """The live state as the reference's checkpoint arrays."""
        if self.codec is not None:
            return self.codec[0](state)
        return checkpoint_arrays(state, self.optimizer)

    def save_every(self, state: dict, every: int, count: int) -> None:
        """Save the state when checkpoints are on and `every` (0: never)
        divides `count` (the steps taken, or the CNN trainer's epochs)."""
        if self.ckpt is not None and every and count % every == 0:
            self.ckpt.save(self.arrays(state), state["step"])

    def restore(self, state: dict) -> Path | None:
        """Install the newest checkpoint of checkpoint_dir that verifies
        into `state` (every rank reads it after a barrier); its path, or
        None when none restores."""
        barrier("ckpt_restore")
        restored, path = restore_latest(
            self.cfg.checkpoint_dir, self.arrays(state), logger=self.log,
            metrics=self.metrics)
        if restored is None:
            return None
        validate_resume_meta(path, mesh=self.mesh,
                             elastic_width=self.cfg.elastic_width,
                             metrics=self.metrics, logger=self.log)
        self.install(state, restored)
        return path

    def install(self, state: dict, arrays: dict) -> None:
        """Copy checkpoint arrays (the reference's, `arrays`' inverse)
        into the live state in place: each tensor keeps its device and,
        on a sharded path, each rank takes its blocks."""
        if self.codec is not None:
            self.codec[1](state, arrays)
        else:
            load_checkpoint_arrays(state, arrays, self.optimizer)

    def resume(self, state: dict) -> bool:
        """With cfg.resume, restore the latest checkpoint (protected from
        every later prune: the run stands on it) and log it. Returns
        whether one was restored."""
        if not (self.cfg.resume and self.cfg.checkpoint_dir):
            return False
        path = self.restore(state)
        if path is None:
            return False
        if self.ckpt is not None:
            self.ckpt.protect = path.name
        self.metrics.log("ckpt", step=state["step"], reason="resume",
                         path=path.name)
        self.log.info("resumed from %s at step %d", path, state["step"])
        return True

    def drain_events(self) -> None:
        """The injector's fired faults, as ``fault`` records."""
        if self.faults is not None:
            for ev in self.faults.drain_events():
                self.metrics.log("fault", **ev)

    def step_boundary(self, state: dict, step: int) -> None:
        """After a step (or a device-resident chunk) ending at global step
        `step`: fire the planned train.step faults (a ``preempt`` flags
        the guard as a SIGTERM would), then drain a pending preemption."""
        if self.faults is not None:
            for f in self.faults.fire("train.step", step):
                if f.kind == "preempt":
                    self.preempt.request()
            self.drain_events()
        if self.mesh.group is not None and self.mesh.world > 1:
            self._agree_preemption()
        if self.preempt.requested:
            drain_preemption(
                self.preempt, global_step=step, ckpt=self.ckpt,
                state=self.arrays(state) if self.ckpt is not None else None,
                metrics=self.metrics, logger=self.log)

    def _agree_preemption(self) -> None:
        """Flag this rank's guard when any rank's is (one all-reduce of
        the flags over the world), so that every rank drains at this
        boundary or none does."""
        flag = torch.tensor([float(self.preempt.requested)],
                            device=self.mesh.device)
        if all_reduce_sum(flag, self.mesh).item() and \
                not self.preempt.requested:
            self.preempt.request()

    @torch.no_grad()
    def snapshot(self, state: dict):
        """A device copy of the state's tensors (into buffers kept across
        steps, one multi-tensor copy) and its update count, when the guard
        may have to undo the next step; else None."""
        if not self.nan.snapshots:
            return None
        tensors = _state_tensors(state)
        if self._snap is None:
            self._snap = [torch.empty_like(t) for t in tensors]
        torch._foreach_copy_(self._snap, tensors)
        return self._snap, state["opt_state"]["count"]

    @torch.no_grad()
    def check_step(self, state: dict, metrics: torch.Tensor, step: int,
                   snap) -> bool:
        """The NaN guard after step `step` (0-based): whether its update
        is kept. A non-finite step is undone from `snap` (abort, and a
        rollback after max_bad bad steps, raise)."""
        if not self.nan.active:
            return True
        if step_is_finite(metrics, _state_tensors(state)):
            self.nan.step_ok()
            return True
        self.nan.bad_step(step, logger=self.log, metrics=self.metrics)
        tensors, count = snap
        torch._foreach_copy_(_state_tensors(state), tensors)
        state["opt_state"]["count"] = count
        return False

    def rollback(self, state: dict) -> None:
        """nan-policy=restore: reload the newest valid checkpoint into
        `state`. Raises NonFiniteLossError when there is none, or after
        MAX_NAN_ROLLBACKS rollbacks (a NaN that reproduces surfaces)."""
        self.rollbacks += 1
        if self.rollbacks > MAX_NAN_ROLLBACKS:
            raise NonFiniteLossError(
                f"nan-policy=restore: rolled back {MAX_NAN_ROLLBACKS} "
                "times and the run still goes non-finite")
        if self.ckpt is not None:
            self.ckpt.wait()  # the write in flight may be the newest
        path = self.restore(state) if self.cfg.checkpoint_dir else None
        if path is None:
            raise NonFiniteLossError(
                "nan-policy=restore: no valid checkpoint to roll back to "
                "(set --checkpoint-dir and a checkpoint interval)")
        self.nan.step_ok()
        self.metrics.log("fault", kind="nan_restore", step=state["step"],
                         path=path.name)
        self.log.warning("nan-policy=restore: rolled back to %s (step %d)",
                         path, state["step"])

    def finish(self, state: dict) -> None:
        """The final save, unless the last save was of this step."""
        if self.ckpt is not None and self.ckpt.last_step != state["step"]:
            self.ckpt.save(self.arrays(state), state["step"])

    def close(self) -> None:
        """Let the write in flight land (or re-raise), and log the faults
        fired since the last drain (one that ended the loop among
        them)."""
        if self.ckpt is not None:
            self.ckpt.close()
        self.drain_events()
