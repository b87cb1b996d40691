"""Weights shared between the two packages.

`params_from_jax(tree)` takes the reference's `TransformerLM.init`
parameter tree with numpy leaves (what `jax.tree.map(np.asarray,
params)` gives) and returns this package's params on `device`: the same
nested dicts and lists, each leaf a float32 tensor of the same shape. It
needs neither jax nor the reference package.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device: torch.device | str = "cpu"):
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype != np.float32:
        raise TypeError(f"params_from_jax: want float32 leaves, got {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)
