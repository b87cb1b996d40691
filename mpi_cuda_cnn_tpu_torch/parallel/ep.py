"""Expert parallelism of the LM over an 'expert' mesh axis, beside
'data' (counterpart of the reference's `parallel/ep.py`, EP x DP).

The batch's rows are split over ('data', 'expert') jointly
(`ep_shard_batch`), so attention and every dense op run as plain data
parallelism over both axes, while each MoE block routes the rank's own
tokens and sends the slots to the experts' ranks over 'expert' by
all-to-all (`parallel/moe.py` `moe_mlp` with `axis`). The params are
replicated; the rank computes its E/P experts from the full stacks,
sliced at its coordinate, so the other experts' rows of its gradient
are zero and the mean over both axes is the reference's gradient. The
gradients and the loss are meaned over ('data', 'expert') in one
all-reduce (`parallel/dp.py`), --grad-accum through `dp.local_grads`
(the all-to-alls run once per micro-batch on every rank).
"""

from __future__ import annotations

import numpy as np

from . import dp
from .mesh import DATA_AXIS, EXPERT_AXIS, Mesh

__all__ = ["moe_param_specs", "make_moe_layer", "ep_shard_batch",
           "make_ep_lm_train_step"]


def moe_param_specs(axis: str = EXPERT_AXIS) -> dict:
    """Where the standalone EP layer splits an MoE block's leaves
    ({axis: dim} per leaf): the expert stacks on their leading dim, the
    gate whole."""
    return {"gate": {}, "w1": {axis: 0}, "w2": {axis: 0}}


def make_moe_layer(mesh: Mesh, *, n_experts: int,
                   capacity_factor: float = 1.25, axis: str = EXPERT_AXIS,
                   top_k: int = 1):
    """layer(params, x) -> (y, aux): the standalone EP layer of this
    rank, x (T, D) its tokens and `params` the whole gate and stacks, of
    which it keeps its E/P experts (`moe_param_specs`); aux meaned over
    the axis (one all-reduce), as the reference's replicated output."""
    from .moe import moe_mlp
    from .tp import local_block

    if n_experts % mesh.shape[axis]:
        raise ValueError(f"experts {n_experts} not divisible by {axis!r} "
                         f"size {mesh.shape[axis]}")
    specs = moe_param_specs(axis)

    def layer(params, x):
        local = {k: local_block(v, specs[k], mesh) for k, v in params.items()}
        y, aux = moe_mlp(x, local, n_experts=n_experts,
                         capacity_factor=capacity_factor, top_k=top_k,
                         group=mesh, axis=axis)
        total = aux.detach().reshape(1).clone()
        dp.all_reduce_sum(total, mesh, axis)
        return y, total[0] / mesh.shape[axis]

    return layer


def ep_shard_batch(batch: np.ndarray, mesh: Mesh) -> np.ndarray:
    """This rank's contiguous rows of a (B, S) batch split over
    ('data', 'expert') jointly, 'data' major (the reference's
    P(('data', 'expert')))."""
    n_e = mesh.shape.get(EXPERT_AXIS, 1)
    n = mesh.shape.get(DATA_AXIS, 1) * n_e
    if len(batch) % n:
        raise ValueError(f"batch of {len(batch)} not divisible by data x "
                         f"expert shards ({n})")
    i = mesh.index(DATA_AXIS) * n_e + mesh.index(EXPERT_AXIS)
    per = len(batch) // n
    return batch[i * per:(i + 1) * per]


def make_ep_lm_train_step(model, optimizer, mesh: Mesh, *,
                          attn_impl: str = "oracle", remat: bool = False,
                          moe_aux_weight: float = 0.01, compute_dtype=None,
                          ce_chunk: int = 0, grad_accum: int = 1):
    """The EP x DP train step: step(state, tokens, targets) -> (state,
    {"loss": loss}) on this rank's rows (`ep_shard_batch`), the params
    replicated; `step.loss_fn` and `step.grads` as
    `train.lm.make_lm_train_step`'s."""
    from ..train.lm import get_attn_fn, lm_loss

    if not model.moe_experts:
        raise ValueError(
            "an 'expert' mesh axis needs an MoE model (--moe-experts); for "
            "dense models the axis is just data parallelism — use a 'data' "
            "axis")
    n_exp = mesh.shape[EXPERT_AXIS]
    if model.moe_experts % n_exp:
        raise ValueError(f"experts {model.moe_experts} not divisible by "
                         f"expert-axis size {n_exp}")
    attn_fn = get_attn_fn(attn_impl)

    def loss_fn(params, tokens, targets):
        return lm_loss(model, params, tokens, targets, attn_fn=attn_fn,
                       compute_dtype=compute_dtype, remat=remat,
                       moe_aux_weight=moe_aux_weight, ce_chunk=ce_chunk,
                       moe_group=mesh, moe_axis=EXPERT_AXIS), {}

    dp_step = dp.make_dp_train_step(loss_fn, optimizer, mesh,
                                    axis=(DATA_AXIS, EXPERT_AXIS),
                                    grad_accum=grad_accum)

    def step(state, tokens, targets):
        state, metrics = dp_step(state, tokens, targets)
        return state, {"loss": metrics[0]}

    step.loss_fn = loss_fn
    step.grads = dp_step.grads
    return step
