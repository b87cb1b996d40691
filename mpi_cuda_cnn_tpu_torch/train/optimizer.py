"""SGD and AdamW (counterpart of the reference's `train/optimizer.py`).

The reference's optimizer is hand-rolled SGD: `param -= (rate/32) *
u_param` after 32 accumulated samples (cnn.c:303-314, 467-469), which
with a mean loss over a batch of 32 is `sgd(lr=0.1)`; the LM trains with
AdamW. `make_optimizer` builds the same update as the JAX package's
`optax` chain, step for step:
- `clip_by_global_norm` when grad_clip > 0 (a sharded step sums the
  squared norm over its ranks and clips with `clip_grads_by_global_sq`);
- SGD: `add_decayed_weights` (g + wd * p) when weight_decay > 0, then
  `optax.sgd`'s momentum trace `t = g + momentum * t` when momentum > 0;
- AdamW (`optax.adamw(lr, weight_decay=wd)`: b1 0.9, b2 0.999, eps 1e-8,
  eps_root 0, no mask): moments mu = (1 - b1) g + b1 mu and
  nu = (1 - b2) g^2 + b2 nu, bias-corrected on count + 1, the update
  mu_hat / (sqrt(nu_hat) + eps), then + wd * p;
- the scale by `-lr(count)` from a constant, `cosine_decay_schedule` or
  `warmup_cosine_decay_schedule`, then `params + updates`.
The update runs in place on the parameter tensors, with the multi-tensor
`torch._foreach_*` ops (one launch each for all parameters on the card);
every product and sum rounds where optax's do, and the schedules and
bias corrections are taken in float32 as optax takes them.
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


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int):
    """optax.warmup_cosine_decay_schedule(init, peak, warmup, decay_steps)
    with end value 0 and exponent 1: a linear ramp over `warmup_steps`,
    then `cosine_decay_schedule(peak, decay_steps - warmup_steps)`, in
    float32 as optax computes it."""
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps)
    span = np.float32(init_value - peak_value)

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return cosine(count - warmup_steps)
        if warmup_steps <= 0:
            return float(np.float32(init_value))
        c = np.float32(min(max(count, 0), warmup_steps))
        frac = np.float32(1) - c / np.float32(warmup_steps)
        return float(span * frac + np.float32(peak_value))

    return schedule


@torch.no_grad()
def _clip(grads: list[torch.Tensor], clip: float) -> list[torch.Tensor]:
    """optax.clip_by_global_norm: g * clip / norm unless norm < clip,
    chosen on the device (no host sync)."""
    if clip <= 0:
        return list(grads)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < clip
    return [torch.where(keep, g, (g / norm) * clip) for g in grads]


@torch.no_grad()
def grad_sq(grads: list[torch.Tensor]) -> torch.Tensor:
    """The sum of squared gradients, in float32."""
    return sum(torch.sum(torch.square(g.float())) for g in grads)


@torch.no_grad()
def clip_grads_by_global_sq(grads: list[torch.Tensor], sq_norm,
                            clip: float) -> list[torch.Tensor]:
    """optax.clip_by_global_norm from a squared norm the caller summed
    over the ranks: g * clip / max(norm, clip), on the device. The
    sharded steps (`parallel/tp.py`, `parallel/pp.py`) clip this way,
    since each rank holds only blocks of the gradients."""
    norm = torch.sqrt(torch.as_tensor(sq_norm, dtype=torch.float32))
    scale = clip / torch.clamp(norm, min=clip)
    return [(g * scale).to(g.dtype) for g in grads]


class SGD:
    """In-place SGD over a list of parameter tensors. `state` holds the
    update count (the schedule's step) and the momentum trace.
    `scheduled`: whether the reference's optax chain keeps a count for
    `schedule` (any but a constant one); it names the state's arrays in a
    checkpoint (`convert.checkpoint_arrays`)."""

    def __init__(self, schedule, *, momentum: float = 0.0,
                 weight_decay: float = 0.0, grad_clip: float = 0.0,
                 scheduled: bool = False):
        self.schedule = schedule
        self.scheduled = scheduled
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params: list[torch.Tensor]) -> dict:
        trace = ([torch.zeros_like(p) for p in params] if self.momentum
                 else None)
        return {"count": 0, "trace": trace}

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: dict, *, clip: bool = True) -> None:
        """The update, in place. `clip` False: the grads come clipped
        already (a sharded step's global norm)."""
        grads = _clip(grads, self.grad_clip if clip else 0.0)
        if self.weight_decay:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(params, self.weight_decay))
        if self.momentum:
            trace = state["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            grads = trace
        lr = self.schedule(state["count"])
        torch._foreach_add_(params, torch._foreach_mul(grads, -lr))
        state["count"] += 1


class AdamW:
    """In-place AdamW over a list of parameter tensors, update for update
    `optax.adamw(lr, weight_decay=wd)` (behind an optional global-norm
    clip). `state` holds the count and the two moments. `scheduled` as
    for SGD."""

    def __init__(self, schedule, *, weight_decay: float = 0.0,
                 grad_clip: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, scheduled: bool = False):
        self.schedule = schedule
        self.scheduled = scheduled
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: list[torch.Tensor]) -> dict:
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: dict, *, clip: bool = True) -> None:
        b1, b2 = self.b1, self.b2
        grads = _clip(grads, self.grad_clip if clip else 0.0)
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, sq)
        count = np.float32(state["count"] + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** count)
        bc2 = float(np.float32(1) - np.float32(b2) ** count)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, bc1)
        torch._foreach_div_(updates, denom)
        if self.weight_decay:
            torch._foreach_add_(updates,
                                torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(updates, -self.schedule(state["count"]))
        torch._foreach_add_(params, updates)
        state["count"] += 1


def make_optimizer(lr: float = 0.1, *, opt: str = "sgd",
                   momentum: float = 0.0, schedule: str = "constant",
                   total_steps: int | None = None, warmup_steps: int = 0,
                   weight_decay: float = 0.0, grad_clip: float = 0.0):
    """SGD (the CNN trainer's, with optional momentum and weight decay)
    or AdamW (the LM trainer's), a constant, cosine or warm-up + cosine
    schedule, and a global-norm clip: the reference's `make_optimizer`."""
    if schedule == "constant":
        sched = constant_schedule(lr)
    elif schedule == "cosine":
        if total_steps is None:
            raise ValueError("cosine schedule needs total_steps")
        sched = (warmup_cosine_decay_schedule(0.0, lr, warmup_steps,
                                              total_steps)
                 if warmup_steps else cosine_decay_schedule(lr, total_steps))
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    scheduled = schedule != "constant"
    if opt == "sgd":
        return SGD(sched, momentum=momentum, weight_decay=weight_decay,
                   grad_clip=grad_clip, scheduled=scheduled)
    if opt == "adamw":
        if momentum:
            raise ValueError(
                "momentum is an SGD knob; adamw's betas are not remapped "
                "from it: drop --momentum or use opt='sgd'")
        return AdamW(sched, weight_decay=weight_decay, grad_clip=grad_clip,
                     scheduled=scheduled)
    raise ValueError(f"unknown optimizer {opt!r}; 'sgd' or 'adamw'")
