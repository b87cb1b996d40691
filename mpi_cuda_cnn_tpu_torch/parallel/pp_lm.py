"""Pipeline parallelism of the transformer LM over a 'pipe' mesh axis
(counterpart of the reference's `parallel/pp_lm.py`).

The blocks are uniform, so the reference stacks them into leading-dim-L
arrays whose block dim shards over 'pipe' (`stack_blocks`), keeps the
embedding, the final layernorm and the head replicated ('rest'), and
runs GPipe in one shard_map (`make_gpipe_local_loss`): stage 0 embeds
each microbatch, every stage runs its L/P blocks, the last stage takes
each microbatch's loss, and the rest's gradients, which only the stages
that use them hold, are summed over 'pipe'. Here a rank at pipe
coordinate s holds blocks s*L/P .. (s+1)*L/P - 1 as tensors of their
own and the whole rest, and runs the CNN pipeline's schedule
(`parallel/pp.py` `gpipe_grads`: forward over the microbatches with
send/recv between neighbours, backward in reverse) on them
(`parallel/lm_shard.py` `ShardedLM`). The stacked form exists at the
checkpoint boundary only, so a file moves between the packages on the
same mesh.

The batch is cut as the reference's trainer cuts it: M = n_pipe
microbatches of B/M rows, each microbatch's rows over 'data' and, with
a 'seq' axis (SP x PP), its positions over 'seq' (`pp_lm_shard_batch`).
MoE blocks route each stage's tokens of a microbatch by themselves, or
under SP x PP expert-parallel over 'seq', their balance loss averaged
over the microbatches (the reference masks it on bubble ticks; the
schedule here runs none).
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import DATA_AXIS, SEQ_AXIS, Mesh
from .pp import microbatch_rows


def stack_blocks(params: dict) -> dict:
    """{'blocks': [L dicts], ...rest} -> {'blocks': stacked (L, ...),
    'rest': {...}}, the reference's packed tree."""
    blocks = params["blocks"]

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([b[k] for b in items]) for k in items[0]}
        return torch.stack(items)

    return {"blocks": stack(blocks),
            "rest": {k: v for k, v in params.items() if k != "blocks"}}


def unstack_blocks(packed: dict, depth: int) -> dict:
    """The inverse of `stack_blocks`: the standard tree (views of the
    stacked leaves)."""
    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    return {**packed["rest"],
            "blocks": [pick(packed["blocks"], i) for i in range(depth)]}


def _check_pp_lm(model, n_pipe: int) -> None:
    if model.depth % n_pipe:
        raise ValueError(f"depth {model.depth} not divisible by pipe-axis "
                         f"size {n_pipe}")


def pp_lm_shard_batch(batch: np.ndarray, mesh: Mesh, m: int) -> np.ndarray:
    """This rank's block of a (B, S) batch on a pipelined mesh, in
    microbatch order (M x mb rows): each of the m microbatches' rows over
    'data' (`pp.microbatch_rows`) and, with a 'seq' axis, this shard's
    positions (the reference's `pp_lm_shard_batch` and, under SP x PP,
    `sp_pp_shard_batch`)."""
    rows = batch[microbatch_rows(len(batch), m, mesh.shape.get(DATA_AXIS, 1),
                                 mesh.index(DATA_AXIS))]
    n, i = mesh.shape.get(SEQ_AXIS, 1), mesh.index(SEQ_AXIS)
    s_local = rows.shape[1] // n
    return rows[:, i * s_local:(i + 1) * s_local]
