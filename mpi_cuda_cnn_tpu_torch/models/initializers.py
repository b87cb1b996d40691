"""Weight initializers on `jax.random`'s threefry draws (counterpart of
the reference's `models/initializers.py`).

The reference initializes every weight as `nrnd() * 0.1`, nrnd an
Irwin-Hall(4) approximate normal `(rnd+rnd+rnd+rnd - 2.0) * 1.724`
(cnn.c:46-49); biases start at zero. The same distributions here, drawn
from a key as the JAX package draws them (`data/prng.py`: `normal`, and
`uniform` for Irwin-Hall), so a seed gives the JAX package's weights
(within a few float32 ulp, from the order of a sum) on every device.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import numpy as np
import torch

from ..data import prng

Initializer = Callable[[np.ndarray, tuple[int, ...]], torch.Tensor]


def normal(std: float = 0.1) -> Initializer:
    """Gaussian with fixed std — the reference's effective init."""

    def init(key, shape):
        return std * prng.normal(key, shape)

    return init


def irwin_hall(std: float = 0.1) -> Initializer:
    """Sum of four uniforms, shifted and scaled by 1.724 (cnn.c:46-49)."""

    def init(key, shape):
        u = torch.from_numpy(prng.uniform(key, (4, *shape)))
        return std * ((u.sum(dim=0) - 2.0) * 1.724)

    return init


def he_normal() -> Initializer:
    """Fan-in-scaled Gaussian."""

    def init(key, shape):
        fan_in = shape[0] * shape[1] * shape[2] if len(shape) == 4 else shape[0]
        return prng.normal(key, shape) * math.sqrt(2.0 / fan_in)

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
