"""Width-invariant data parallelism, the numerics behind an elastic resume
(counterpart of the reference's `parallel/elastic.py`).

A run preempted at one data-axis width may resume at another, and the
resumed trajectory must equal the uninterrupted one bit for bit. The
plain step (`dp.dp_mean_grads`) cannot give that: each rank means its own
shard and the ranks' means are summed, so another width regroups the
floating-point sums. Here a fixed elastic width W0 defines B/W0-sample
canonical micro-batches, and every step computes

    grad = (1/W0) * balanced-binary-tree sum of the micro-batch gradients

whatever the world size n. Each rank runs its W0/n contiguous canonical
micro-batches one at a time, each through its own `torch.autograd.grad`
(the same shapes, so the same kernel launches and plans, at every
width), sums them with the LOW levels of the global tree
(`local_tree_reduce`: adjacent pairs, then pairs of pairs), and the HIGH
levels come from a recursive-doubling exchange (`tree_allreduce`): in
round d each rank adds the partial of rank r ^ d. A rank's block of
micro-batches is an aligned power-of-two block, so its local tree is a
complete subtree of the global one, and the association is the same for
every power-of-two width.

The reference's round is `t + ppermute(t)`. `torch.distributed` has no
permute that gloo runs on CUDA tensors, so each round is an `all_reduce`
inside the two-rank group {r, r ^ d} (the groups are made once, every
rank calling `new_group` in the same order): a sum of two values is one
IEEE addition, which is commutative, so both ranks hold the same bits.
A world-wide `all_reduce` would not do: its order of summation belongs
to the library. The loss and the metrics ride in the same buffer, so
they too are width-invariant means over the canonical micro-batches.

The reference fences two XLA effects (a loop of one trip re-fused, and
the optimizer's fusion following its producer) with W0 >= 2n and
optimization barriers. Eager PyTorch has neither effect; the rule
W0 >= 2n stays so that both packages accept the same widths.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import dp
from .mesh import DATA_AXIS, Mesh

# (id of the data group, n) -> {round distance: this rank's pair group}
_PAIR_GROUPS: dict[tuple[int, int], dict[int, object]] = {}


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def check_elastic_width(elastic_width: int, batch_size: int,
                        n_data: int) -> None:
    """The reference's rules for (W0, batch, width), as ValueErrors: W0
    and the data-axis size powers of two, W0 dividing the batch, and
    W0 >= 2 n (two canonical micro-batches or more per rank)."""
    if not _is_pow2(elastic_width):
        raise ValueError(
            f"--elastic-width {elastic_width} must be a power of two "
            "(the width-invariant reduction is a balanced binary tree)")
    if batch_size % elastic_width:
        raise ValueError(
            f"--elastic-width {elastic_width} must divide batch_size "
            f"{batch_size} (it fixes the canonical microbatch size)")
    if not _is_pow2(n_data):
        raise ValueError(
            f"--elastic-width needs a power-of-two data-axis size (got "
            f"{n_data}): device blocks must be complete subtrees of the "
            "canonical reduction tree")
    if elastic_width < 2 * n_data:
        raise ValueError(
            f"--elastic-width {elastic_width} must be >= 2x the data-axis "
            f"size ({n_data}): each device needs >= 2 canonical "
            "microbatches")


def local_tree_reduce(stacked: list[list[torch.Tensor]]
                      ) -> list[torch.Tensor]:
    """Balanced binary-tree sum of a power-of-two list of equal tensor
    lists: adjacent pairs first, then pairs of pairs, each add explicit."""
    if not _is_pow2(len(stacked)):
        raise ValueError(f"{len(stacked)} items: want a power of two")
    while len(stacked) > 1:
        stacked = [torch._foreach_add(stacked[i], stacked[i + 1])
                   for i in range(0, len(stacked), 2)]
    return list(stacked[0])


def pair_groups(mesh: Mesh, axis: str = DATA_AXIS) -> dict[int, object]:
    """This rank's two-rank group {r, r ^ d} for each round distance d of
    the recursive doubling over the mesh's axis (none at world 1). Every
    rank makes every group, in the same order, on its first call."""
    n = mesh.shape.get(axis, 1)
    if mesh.group is None or n == 1:
        return {}
    cache_key = (id(mesh.group), n)
    if cache_key not in _PAIR_GROUPS:
        ranks = dist.get_process_group_ranks(mesh.group)
        mine = {}
        d = 1
        while d < n:
            for i in range(n):
                j = i ^ d
                if i < j:
                    g = dist.new_group([ranks[i], ranks[j]])
                    if mesh.rank in (i, j):
                        mine[d] = g
            d *= 2
        _PAIR_GROUPS[cache_key] = mine
    return _PAIR_GROUPS[cache_key]


def tree_allreduce(tensors: list[torch.Tensor], mesh: Mesh,
                   axis: str = DATA_AXIS) -> list[torch.Tensor]:
    """The HIGH levels of the canonical tree, in place: in round d = 1, 2,
    4, ... each rank's tensors become their sum with rank r ^ d's (one
    `all_reduce` per round and dtype, in the pair's group). The identity
    at world 1."""
    groups = pair_groups(mesh, axis)
    if not groups:
        return tensors
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for d in sorted(groups):
        for same in by_dtype.values():
            buf = torch.cat([t.reshape(-1) for t in same])
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=groups[d])
            dp.collectives["all_reduce"] += 1
            for t, v in zip(same, dp.views(buf, same)):
                t.copy_(v)
    return tensors


def elastic_grads(grad_fn, x: torch.Tensor, y: torch.Tensor, *,
                  elastic_width: int, mesh: Mesh, axis: str = DATA_AXIS,
                  prepare=None) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Width-invariant (gradients, metrics) of this rank's shard x, y.

    `grad_fn(px, py) -> (gradients, 1-d metrics tensor)` runs one
    canonical micro-batch (the rank's k = W0/n contiguous blocks of
    B/W0 rows, one at a time); `prepare(px, py, index)` may first
    transform it, given its GLOBAL canonical index (augmentation keys on
    it, so the pixels do not depend on the width). The micro-batches'
    results are summed by the canonical tree and divided by W0."""
    n = mesh.shape.get(axis, 1)
    k = elastic_width // n
    mb = len(x) // k
    outs = []
    for i in range(k):
        px, py = x[i * mb:(i + 1) * mb], y[i * mb:(i + 1) * mb]
        if prepare is not None:
            px, py = prepare(px, py, mesh.rank * k + i)
        grads, metrics = grad_fn(px, py)
        outs.append([*grads, metrics])
    with torch.no_grad():
        reduced = tree_allreduce(local_tree_reduce(outs), mesh, axis)
        torch._foreach_div_(reduced, float(elastic_width))
    return reduced[:-1], reduced[-1]


def host_shard_rows(batch_size: int, process_index: int,
                    process_count: int) -> tuple[int, int]:
    """[start, stop) rows of the global batch that process
    `process_index` of `process_count` owns: contiguous equal blocks, a
    function of the layout alone (no stored cursor), so a run resumed at
    another process count re-derives its share of the same batches."""
    if batch_size % process_count:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"process_count {process_count}")
    per = batch_size // process_count
    return process_index * per, (process_index + 1) * per
