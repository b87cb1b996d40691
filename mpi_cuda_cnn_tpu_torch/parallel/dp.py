"""Data parallelism over a data mesh (counterpart of the reference's
`parallel/dp.py`), the parallelism the C reference is named for
(SURVEY.md §2.6).

The C reference (cnnmpi.c:456-499) shards the samples contiguously per
rank, then per sample and per layer calls a blocking MPI_Allreduce whose
result it never reads (bug 2.6a), beside a spurious weight decay (2.6b)
and a per-rank init that is never synchronized (2.6c). The JAX package
implements the intent with `shard_map` and one `pmean` per step; so does
this module, one process per rank:

- `replicate`: one keyed init on every rank, then ONE broadcast from
  rank 0 of every parameter in one flat buffer (fixes 2.6c);
- `dp_shard_batch` / `dp_shard_perm`: each rank's contiguous share of a
  batch, rows r*b/w to (r+1)*b/w, exactly as `P(axis)` and
  `P(None, axis)` split them;
- `make_dp_train_step`: local gradients on the rank's shard
  (`local_grads`: with --grad-accum, interleaved micro-batches, one
  `autograd.grad` each, summed in order, in `accum_dtype` when one is
  given, and divided), then ONE
  all-reduce per step of one flat float32 buffer holding every gradient
  and the step's metrics, divided by the world size (the mean), then the
  same in-place optimizer update on every rank (fixes 2.6a/b). A
  global-norm clip sees the mean gradient, as optax's does after `pmean`.
  The step augments the rank's shard first (`data/augment.py`), and with
  an elastic width takes the width-invariant reduction instead
  (`parallel/elastic.py`);
- `make_dp_scan_epoch`: the device-resident epoch, every rank holding
  the whole uint8 set (JAX replicates it, `P()`) and gathering its own
  columns of the step's batch;
- the eval (`train/trainer.py`): each rank predicts its rows of an eval
  batch and the correct counts are summed over the data line
  (`all_reduce_sum`).

Only `all_reduce` and `broadcast` are used (the elastic step's rounds
are all-reduces in two-rank groups); gloo runs both on CUDA tensors.
`mean_over` is the mean of given gradients and metrics, which the
sharded meshes' data mean shares (`parallel/collectives.py`). On a mesh with another axis beside the
data axis (an axis of replicas, as the reference's trainer runs one),
the sums run over this rank's data line. `collectives` counts, per
process, the collectives this module and `parallel/collectives.py` made
(one per call, where they call `torch.distributed`, and nowhere else;
the sharded meshes' kinds appear once made); `reset_collectives()`
zeroes it. A mesh without a process group (world 1, no group) makes
none: every collective there is the identity.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..data.pipeline import PIXEL_SCALE
from ..models.layers import tree_leaves
from .mesh import DATA_AXIS, Mesh

collectives: dict[str, int] = {"all_reduce": 0, "broadcast": 0}


def reset_collectives() -> None:
    for name in collectives:
        collectives[name] = 0


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def views(buf: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    """Views of `buf`, one shaped like each tensor of `like`, in order."""
    out, at = [], 0
    for t in like:
        out.append(buf[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def all_reduce_sum(t: torch.Tensor, mesh: Mesh,
                   axis: str | tuple[str, ...] | None = None) -> torch.Tensor:
    """Sum `t` in place over the mesh's ranks, or over this rank's ranks
    along `axis` (a name or a tuple of them): one all-reduce, none when
    they are this rank alone."""
    group = mesh.group if axis is None else mesh.group_of(axis)
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        collectives["all_reduce"] += 1
    return t


@torch.no_grad()
def replicate(params, mesh: Mesh):
    """Make every rank's params rank 0's, in place: one broadcast of one
    flat buffer of every leaf (the synchronized init the C reference
    forgot, SURVEY.md 2.6c). Returns `params`."""
    leaves = tree_leaves(params)
    if mesh.group is not None:
        buf = _flat(leaves)
        dist.broadcast(buf, src=0, group=mesh.group)
        collectives["broadcast"] += 1
        for leaf, v in zip(leaves, views(buf, leaves)):
            leaf.copy_(v)
    return params


def _shard_bounds(n: int, mesh: Mesh, axis: str) -> tuple[int, int]:
    w = mesh.shape.get(axis, 1)
    if n % w:
        raise ValueError(f"batch of {n} not divisible by {axis}-axis size "
                         f"{w}")
    per = n // w
    i = mesh.index(axis)
    return i * per, (i + 1) * per


def dp_shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS):
    """This rank's contiguous rows of a batch (an array or tensor, or a
    tuple of them with one leading size): rows i*b/w to (i+1)*b/w for the
    rank's coordinate i along `axis`, the share `P(axis)` gives it."""
    if isinstance(batch, tuple):
        return tuple(dp_shard_batch(b, mesh, axis) for b in batch)
    lo, hi = _shard_bounds(len(batch), mesh, axis)
    return batch[lo:hi]


def dp_shard_perm(perm, mesh: Mesh, axis: str = DATA_AXIS):
    """This rank's columns of a (nsteps, batch) permutation, the share
    `P(None, axis)` gives device r: every step's batch split as
    `dp_shard_batch` splits one."""
    lo, hi = _shard_bounds(perm.shape[1], mesh, axis)
    return perm[:, lo:hi]


def _grads(loss_fn, params, x, y, view=None):
    """(gradients, 1-d float32 metrics: the loss then the aux values) of
    loss_fn(params, x, y) -> (scalar loss, aux dict of scalars), by one
    `torch.autograd.grad`. `view(params)` (None: the params themselves)
    gives the tree that the loss reads and is differentiated by."""
    if view is not None:
        params = view(params)
    loss, aux = loss_fn(params, x, y)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    metrics = torch.stack([loss.detach().float()] + [
        torch.as_tensor(v, device=loss.device).float() for v in aux.values()])
    return list(grads), metrics


def local_grads(loss_fn, params, x, y, grad_accum: int = 1, view=None,
                accum_dtype: torch.dtype | None = None):
    """(gradients, metrics) of this rank's shard (`_grads`), accumulated
    over `grad_accum` micro-batches when it is > 1, as the reference's
    `_local_grads` does: the interleaved split (micro-batch i takes rows
    i, a+i, 2a+i, ...), the micro-results summed in order, then loss,
    metrics and gradients divided by a. Each micro-batch has its own
    `autograd.grad`, so one micro-batch's activations are live at a
    time. `accum_dtype` (e.g. bf16) holds the gradient sum in that type:
    each micro-gradient is cast to it, the sum divided in it, and the
    mean cast back to each gradient's own type; loss and metrics stay
    float32. At a = 1 there is no sum and it does nothing."""
    a = grad_accum
    if a <= 1:
        return _grads(loss_fn, params, x, y, view)
    grads = metrics = None
    for i in range(a):
        g, m = _grads(loss_fn, params, x[i::a], y[i::a], view)
        if accum_dtype is not None:
            dtypes = [t.dtype for t in g]
            g = [t.to(accum_dtype) for t in g]
        if grads is None:
            grads, metrics = g, m
        else:
            torch._foreach_add_(grads, g)
            metrics += m
    torch._foreach_div_(grads, float(a))
    if accum_dtype is not None:
        grads = [t.to(dt) for t, dt in zip(grads, dtypes)]
    return grads, metrics / a


def axis_size(mesh: Mesh, axis: str | tuple[str, ...]) -> int:
    """The ranks along `axis`, or along every axis of a tuple of them."""
    axes = (axis,) if isinstance(axis, str) else axis
    return math.prod(mesh.shape.get(a, 1) for a in axes)


def dp_mean_grads(loss_fn, params, x, y, mesh: Mesh,
                  axis: str | tuple[str, ...] = DATA_AXIS, *,
                  grad_accum: int = 1, view=None,
                  accum_dtype: torch.dtype | None = None):
    """Gradients of loss_fn(params, x, y) -> (scalar loss, aux dict of
    scalars) on this rank's shard (`local_grads`: accumulated over
    `grad_accum` micro-batches in `accum_dtype`, differentiated through
    `view`), averaged over the axis (or a tuple of axes: data and seq
    under sequence parallelism; the axes the mesh's group spans) together
    with the loss and the aux values in ONE all-reduce of one flat float32
    buffer. Returns (mean gradients, one per leaf, each in its leaf's
    gradient dtype; a 1-d tensor of the mean loss then the aux values in
    their order), float32 ones views of that buffer. On a mesh without a
    group (`device_mesh`) the mean is the value itself: no buffer and no
    collective."""
    return mean_over(*local_grads(loss_fn, params, x, y, grad_accum, view,
                                  accum_dtype), mesh, axis)


def mean_over(grads: list[torch.Tensor], metrics: torch.Tensor, mesh: Mesh,
              axis: str | tuple[str, ...] = DATA_AXIS):
    """`grads` and the 1-d `metrics` averaged over the axis (or a tuple of
    axes) in ONE all-reduce of one flat float32 buffer: (each gradient in
    its own dtype, the metrics), float32 ones views of that buffer. On a
    mesh without a group for the axis, the values themselves."""
    if mesh.group_of(axis) is None:
        return grads, metrics
    buf = torch.cat([g.reshape(-1).float() for g in grads] + [metrics])
    all_reduce_sum(buf, mesh, axis)
    buf /= axis_size(mesh, axis)
    n = buf.numel() - len(metrics)
    return ([v.to(g.dtype) for v, g in zip(views(buf[:n], grads), grads)],
            buf[n:])


def make_dp_train_step(loss_fn, optimizer, mesh: Mesh, *,
                       axis: str | tuple[str, ...] = DATA_AXIS, view=None,
                       augment=None, aug_seed: int = 0, grad_accum: int = 1,
                       elastic_width: int = 0,
                       accum_dtype: torch.dtype | None = None):
    """The DP train step: step(state, x, y, aug=None) -> (state, metrics)
    on this rank's shard x, y (`dp_shard_batch`), with state =
    {"params", "opt_state", "step"} the same on every rank. The gradients
    and metrics are averaged in one all-reduce over `axis` (`dp_mean_grads`,
    with `grad_accum`, `accum_dtype` and `view`), then `optimizer.update`
    runs in place on
    the params. `metrics` is the 1-d tensor (loss, *aux values), averaged
    over the axis.

    `augment` (`data/augment.Augment`) transforms the rank's shard before
    any accumulation split, keyed as the reference keys it:
    fold_in(fold_in(key(aug_seed), step), the rank's coordinate on the
    data axis). `aug` is the step's
    draws on the device (`step.draws`, which a device-resident chunk
    makes for all its steps at once); None draws them here.

    elastic_width > 0 takes the width-invariant reduction instead
    (`parallel/elastic.py`): W0/n canonical micro-batches per rank, each
    augmented under its global canonical index. `step.grads(state, x, y,
    aug=None)` is the step's (gradients, metrics) without the update."""
    n = axis_size(mesh, axis)
    if elastic_width:
        from .elastic import elastic_grads, pair_groups

        pair_groups(mesh, axis)      # every rank, now, in one order
        k = elastic_width // n

    def draws(steps, rows: int):
        """The augmentation draws of `steps` for `rows` shard rows, on the
        device: offsets (S, rows, 2) and flips (S, rows); elastic,
        (S, k, rows / k, 2) and (S, k, rows / k)."""
        from ..data.augment import step_keys

        steps = np.asarray(steps)
        if elastic_width:
            keys = step_keys(aug_seed, steps, range(mesh.rank * k,
                                                    (mesh.rank + 1) * k))
            d = augment.draw(keys, rows // k)
        else:
            shard = mesh.index(axis) if isinstance(axis, str) else mesh.rank
            keys = step_keys(aug_seed, steps, [shard])[:, 0]
            d = augment.draw(keys, rows)
        return augment.to_device(d, mesh.device)

    def grads(state, x, y, aug=None):
        params = state["params"]
        if augment is not None and aug is None:
            aug = tuple(t[0] for t in draws([state["step"]], len(x)))
        if not elastic_width:
            if augment is not None:
                x = augment.apply(x, *aug)
            return dp_mean_grads(loss_fn, params, x, y, mesh, axis,
                                 grad_accum=grad_accum, view=view,
                                 accum_dtype=accum_dtype)

        def prepare(px, py, index):
            i = index - mesh.rank * k
            return augment.apply(px, aug[0][i], aug[1][i]), py

        return elastic_grads(
            lambda px, py: _grads(loss_fn, params, px, py, view), x, y,
            elastic_width=elastic_width, mesh=mesh, axis=axis,
            prepare=None if augment is None else prepare)

    def step(state, x, y, aug=None):
        g, metrics = grads(state, x, y, aug)
        optimizer.update(tree_leaves(state["params"]), g,
                         state["opt_state"])
        state["step"] += 1
        return state, metrics

    step.grads = grads
    step.draws = draws if augment is not None else None
    return step


def make_dp_scan_epoch(step, num_classes: int):
    """The device-resident epoch (or a chunk of one) of the DP step `step`
    (`make_dp_train_step`): epoch(state, images, labels, perm, sums) ->
    state, where images (N, H, W, C) uint8 and labels (N,) int32 are the
    whole set on this rank's device, and perm is this rank's (nsteps,
    batch / w) columns of the epoch's permutation (`dp_shard_perm`). Each
    step gathers its rows, divides by PIXEL_SCALE and one-hots on the
    device, then runs `step` and adds its metrics to `sums` in place, on
    the device. With augmentation the chunk's draws are made on the host
    once, for all its steps, and sent in one copy."""

    def epoch(state, images, labels, perm, sums):
        classes = torch.arange(num_classes, device=images.device)
        aug = None
        if step.draws is not None:
            aug = step.draws(state["step"] + np.arange(len(perm)),
                             perm.shape[1])
        for i, idx in enumerate(perm):
            x = images.index_select(0, idx).float() / PIXEL_SCALE
            y = (labels.index_select(0, idx)[:, None] == classes).float()
            state, m = step(state, x, y,
                            None if aug is None else (aug[0][i], aug[1][i]))
            sums += m
        return state

    return epoch
