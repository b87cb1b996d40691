"""SGD for the CNN trainer (counterpart of the reference's
`train/optimizer.py`).

The reference's optimizer is hand-rolled SGD: `param -= (rate/32) *
u_param` after 32 accumulated samples (cnn.c:303-314, 467-469), which
with a mean loss over a batch of 32 is `sgd(lr=0.1)`. `make_optimizer`
builds the same update as the JAX package's `optax` chain, step for step:
`clip_by_global_norm` (when grad_clip > 0), then `optax.sgd`'s momentum
trace `t = g + momentum * t` (when momentum > 0), then the scale by
`-lr(count)` from a constant or `cosine_decay_schedule`, then
`params + updates`. The update runs in place on the parameter tensors,
with the multi-tensor `torch._foreach_*` ops (one launch each for all
parameters on the card); every product and sum rounds where optax's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def constant_schedule(lr: float):
    return lambda count: lr


def cosine_decay_schedule(lr: float, decay_steps: int):
    """optax.cosine_decay_schedule(lr, decay_steps) with alpha 0 and
    exponent 1, in float32 as optax computes it."""
    if not decay_steps > 0:
        raise ValueError(f"cosine schedule needs decay_steps > 0, got "
                         f"{decay_steps}")
    steps = np.float32(decay_steps)

    def schedule(count: int) -> float:
        c = np.minimum(np.float32(count), steps)
        decayed = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / steps, dtype=np.float32))
        return float(np.float32(lr) * decayed)

    return schedule


class SGD:
    """In-place SGD over a list of parameter tensors. `state` holds the
    update count (the schedule's step) and the momentum trace."""

    def __init__(self, schedule, *, momentum: float = 0.0,
                 grad_clip: float = 0.0):
        self.schedule = schedule
        self.momentum = momentum
        self.grad_clip = grad_clip

    def init(self, params: list[torch.Tensor]) -> dict:
        trace = ([torch.zeros_like(p) for p in params] if self.momentum
                 else None)
        return {"count": 0, "trace": trace}

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: dict) -> None:
        grads = list(grads)
        if self.grad_clip > 0:
            # optax.clip_by_global_norm: g * clip / norm unless norm < clip,
            # chosen on the device (no host sync).
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, (g / norm) * self.grad_clip)
                     for g in grads]
        if self.momentum:
            trace = state["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            grads = trace
        lr = self.schedule(state["count"])
        torch._foreach_add_(params, torch._foreach_mul(grads, -lr))
        state["count"] += 1


def make_optimizer(lr: float = 0.1, *, opt: str = "sgd",
                   momentum: float = 0.0, schedule: str = "constant",
                   total_steps: int | None = None,
                   grad_clip: float = 0.0) -> SGD:
    """The CNN trainer's optimizer: SGD with optional momentum, a constant
    or cosine schedule and a global-norm clip. AdamW (with its warm-up and
    weight decay) belongs to the LM trainer, which is not ported yet."""
    if opt != "sgd":
        raise NotImplementedError(
            f"optimizer {opt!r}: only 'sgd' is ported (adamw comes with the "
            "LM training slice)")
    if schedule == "constant":
        sched = constant_schedule(lr)
    elif schedule == "cosine":
        if total_steps is None:
            raise ValueError("cosine schedule needs total_steps")
        sched = cosine_decay_schedule(lr, total_steps)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return SGD(sched, momentum=momentum, grad_clip=grad_clip)
