"""Weight initializers on a `torch.Generator` (counterpart of the
reference's `models/initializers.py`).

The reference initializes every weight as `nrnd() * 0.1`, nrnd an
Irwin-Hall(4) approximate normal `(rnd+rnd+rnd+rnd - 2.0) * 1.724`
(cnn.c:46-49); biases start at zero. The same distributions here; a
torch generator gives other numbers than `jax.random` from the same
seed, so parity with the JAX package goes through imported params
(`convert.params_from_jax`).

Values are drawn on the CPU generator and then moved, so a seed gives
the same weights on every device.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import torch

Initializer = Callable[[torch.Generator, tuple[int, ...]], torch.Tensor]


def normal(std: float = 0.1) -> Initializer:
    """Gaussian with fixed std — the reference's effective init."""

    def init(gen, shape):
        return std * torch.randn(shape, generator=gen, dtype=torch.float32)

    return init


def irwin_hall(std: float = 0.1) -> Initializer:
    """Sum of four uniforms, shifted and scaled by 1.724 (cnn.c:46-49)."""

    def init(gen, shape):
        u = torch.rand((4, *shape), generator=gen, dtype=torch.float32)
        return std * ((u.sum(dim=0) - 2.0) * 1.724)

    return init


def he_normal() -> Initializer:
    """Fan-in-scaled Gaussian."""

    def init(gen, shape):
        fan_in = shape[0] * shape[1] * shape[2] if len(shape) == 4 else shape[0]
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * math.sqrt(2.0 / fan_in))

    return init


_REGISTRY = {
    "normal": normal,
    "irwin_hall": irwin_hall,
    "he": lambda std=None: he_normal(),
}


def get_initializer(name: str, std: float = 0.1) -> Initializer:
    if name not in _REGISTRY:
        raise KeyError(f"unknown initializer {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](std)
