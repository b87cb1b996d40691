"""Weights and train state shared between the two packages.

`params_from_jax(tree)` takes the reference's `TransformerLM.init`
parameter tree with numpy leaves (what `jax.tree.map(np.asarray,
params)` gives) and returns this package's params on `device`: the same
nested dicts and lists, each leaf a float32 tensor of the same shape.
`checkpoint_arrays` / `load_checkpoint_arrays` map a trainer's state to
and from the arrays of the reference's checkpoints, named as its optax
state is named (`opt_state_names`), so that each package resumes from
the other's files. None of it needs jax or the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from .train.checkpoint import named_leaves, to_tensor
from .train.optimizer import AdamW


def params_from_jax(tree, device: torch.device | str = "cpu"):
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype != np.float32:
        raise TypeError(f"params_from_jax: want float32 leaves, got {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


# ---------------------------------------------------------------------------
# A train state as checkpoint arrays, named as the reference names them
# ---------------------------------------------------------------------------


def opt_state_names(optimizer) -> dict[str, str]:
    """Where the reference's optax chain keeps what the port's optimizer
    keeps (`train/optimizer.py` `make_optimizer` builds the same chain),
    as name prefixes under "opt_state": "trace" (SGD momentum), "mu" and
    "nu" (AdamW's moments, one array per param leaf below the prefix),
    "count" (AdamW's update count) and "schedule" (a schedule's count).
    A role the chain does not hold is absent. The chain, by position:
    `clip_by_global_norm` first when grad_clip > 0 (everything after it
    one level down, under "1/"); SGD: `add_decayed_weights` when
    weight_decay > 0 (the rest under "1/"), then `optax.sgd` = (trace if
    momentum, else identity; the schedule's scale); AdamW: (scale_by_adam;
    add_decayed_weights; the schedule's scale)."""
    pre = "opt_state/" + ("1/" if optimizer.grad_clip > 0 else "")
    if isinstance(optimizer, AdamW):
        names = {"count": pre + "0/.count", "mu": pre + "0/.mu",
                 "nu": pre + "0/.nu"}
        if optimizer.scheduled:
            names["schedule"] = pre + "2/.count"
        return names
    if optimizer.weight_decay:
        pre += "1/"
    names = {"trace": pre + "0/.trace"} if optimizer.momentum else {}
    if optimizer.scheduled:
        names["schedule"] = pre + "1/.count"
    return names


def checkpoint_arrays(state: dict, optimizer) -> dict:
    """The train state {"params", "opt_state", "step"} of a trainer using
    `optimizer` as the reference's checkpoint arrays: {name: tensor, or a
    numpy int32 scalar for the counts and the step}, named as
    `train/checkpoint._flatten` names the JAX trainer's state, in its
    order. The tensors are the live ones (a checkpoint write copies
    them)."""
    names = opt_state_names(optimizer)
    opt = state["opt_state"]
    arrays = {}
    count = np.asarray(opt["count"], np.int32)
    for role in ("count", "mu", "nu", "trace", "schedule"):
        if role not in names:
            continue
        if role in ("count", "schedule"):
            arrays[names[role]] = count
        else:
            flat = named_leaves(state["params"], names[role] + "/")
            arrays.update((n, t) for (n, _), t in zip(flat, opt[role],
                                                       strict=True))
    arrays.update(named_leaves(state["params"], "params/"))
    arrays["step"] = np.asarray(state["step"], np.int32)
    return arrays


@torch.no_grad()
def load_checkpoint_arrays(state: dict, arrays: dict, optimizer) -> None:
    """Install checkpoint arrays (`checkpoint_arrays`' names, numpy
    values, e.g. from `restore_checkpoint`) into the live state in
    place: each tensor copied into, the count and the step set. Where
    the reference's chain keeps no count (SGD at a constant rate), the
    count is the step."""
    names = opt_state_names(optimizer)
    live = checkpoint_arrays(state, optimizer)
    if set(arrays) != set(live):
        raise ValueError(f"checkpoint arrays mismatch: missing="
                         f"{set(live) - set(arrays)} extra="
                         f"{set(arrays) - set(live)}")
    for name, t in live.items():
        if isinstance(t, torch.Tensor):
            t.copy_(to_tensor(arrays[name]))
    state["step"] = int(arrays["step"])
    key = names.get("count", names.get("schedule"))
    state["opt_state"]["count"] = (state["step"] if key is None
                                   else int(arrays[key]))
