"""Activations with the reference's semantics (counterpart of the
reference's `ops/activations.py`).

Reference definitions (cnn.c:46-57): relu(x)=max(x,0) with gradient
(y>0); tanh with gradient 1-y^2. Softmax is the max-subtracted stable
form (cnn.c:125-143).
"""

from __future__ import annotations

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


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
