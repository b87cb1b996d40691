"""Activations with the reference's semantics (counterpart of the
reference's `ops/activations.py`).

Reference definitions (cnn.c:46-57): relu(x)=max(x,0) with gradient
(y>0); tanh with gradient 1-y^2. Softmax is the max-subtracted stable
form (cnn.c:125-143). The JAX package's relu is `jnp.maximum(x, 0)`,
whose gradient at a tie (x exactly 0) is 1/2; so is this one's. A zero
pre-activation is rare on noisy inputs, and common where a zero-filled
region meets a zero bias (an augmented shift's border at init).
"""

from __future__ import annotations

import torch


# heaviside's value at 0, one 0-d tensor per (device, dtype): made once,
# so a backward copies nothing from the host.
_HALF: dict = {}


def _half(x: torch.Tensor) -> torch.Tensor:
    key = (x.device, x.dtype)
    if key not in _HALF:
        _HALF[key] = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    return _HALF[key]


class _Relu(torch.autograd.Function):
    """max(x, 0), its gradient 1 above 0, 1/2 at 0 and 0 below."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.heaviside(x, _half(x))


def relu(x: torch.Tensor) -> torch.Tensor:
    return _Relu.apply(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def stable_softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-subtracted softmax (find max, exp-shift, normalize)."""
    shifted = logits - logits.amax(dim=dim, keepdim=True)
    e = torch.exp(shifted)
    return e / e.sum(dim=dim, keepdim=True)


softmax = stable_softmax

ACTIVATIONS = {
    "relu": relu,
    "tanh": tanh,
    "linear": lambda x: x,
    None: lambda x: x,
}
