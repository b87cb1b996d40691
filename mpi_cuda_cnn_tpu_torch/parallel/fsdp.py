"""Fully-sharded data parallelism (ZeRO) over the 'data' mesh axis
(counterpart of the reference's `parallel/fsdp.py`).

Plain DP (`parallel/dp.py`) keeps every parameter on every rank. FSDP
keeps on each rank only its block of every parameter and of the
optimizer state built from it, split over the same axis as the batch.
The reference places the shards and lets GSPMD insert the all-gather
before each use and the reduce-scatter of each gradient; here the step
writes them out (`parallel/tp.py` `ShardedCNN`): one all-gather of every
shard over the data line before the forward, and one reduce-scatter of
the mean gradients (with the step's metrics) after the backward
(`parallel/collectives.py`).

The block follows the reference's rule (`fsdp_specs`): the largest dim
of the whole leaf that the axis size divides, ties to the earliest; a
leaf with none (a scalar, a small head) stays whole on every rank. Over
tensor parallelism's specs (`tp.tp_param_specs`) the dim that 'model'
already takes is passed over: ZeRO over Megatron.

A spec here is a dict {axis: dim} per leaf, in `tree_leaves` order.
"""

from __future__ import annotations

from ..models.layers import tree_leaves
from .mesh import DATA_AXIS

__all__ = ["fsdp_specs", "shard_params_fsdp", "make_fsdp_state"]


def fsdp_specs(params, n: int, axis: str = DATA_AXIS,
               base_specs: list[dict] | None = None) -> list[dict]:
    """Each leaf's spec with `axis` (of size n) on the largest dim the
    size divides and that the base spec leaves free (ties to the
    earliest dim); no dim for a scalar or when none divides."""
    leaves = tree_leaves(params)
    base_specs = base_specs or [{} for _ in leaves]
    out = []
    for leaf, base in zip(leaves, base_specs, strict=True):
        spec = dict(base)
        taken = set(base.values())
        best = None
        if n > 1:
            for d in range(leaf.dim()):
                if d in taken:
                    continue
                if leaf.shape[d] % n == 0 and leaf.shape[d] >= n and (
                        best is None or leaf.shape[d] > leaf.shape[best]):
                    best = d
        if best is not None:
            spec[axis] = best
        out.append(spec)
    return out


def shard_params_fsdp(params, mesh, axis: str = DATA_AXIS,
                      base_specs: list[dict] | None = None):
    """(this rank's blocks of the leaves of `params`, in a tree of its
    shape; the specs)."""
    from .tp import shard_tree

    specs = fsdp_specs(params, mesh.shape.get(axis, 1), axis, base_specs)
    return shard_tree(params, specs, mesh), specs


def make_fsdp_state(params, optimizer, mesh, axis: str = DATA_AXIS,
                    base_specs: list[dict] | None = None
                    ) -> tuple[dict, list[dict]]:
    """(the train state of this rank: its blocks of `params`, leaf
    tensors that require grad, and the optimizer state built from them,
    so that its buffers are blocks of the same shape; the specs)."""
    from .tp import make_state

    local, specs = shard_params_fsdp(params, mesh, axis, base_specs)
    return make_state(local, optimizer), specs
