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
- `make_dp_train_step`: local gradients on the rank's shard, then ONE
  all-reduce per step of one flat float32 buffer holding every gradient
  and the step's metrics, divided by the world size (the mean), then the
  same in-place optimizer update on every rank (fixes 2.6a/b). A
  global-norm clip sees the mean gradient, as optax's does after `pmean`;
- `make_dp_scan_epoch`: the device-resident epoch, every rank holding
  the whole uint8 set (JAX replicates it, `P()`) and gathering its own
  columns of the step's batch;
- `make_dp_eval_step`: each rank predicts its rows of an eval batch; the
  caller sums the correct counts across ranks (`all_reduce_sum`).

Only `all_reduce` and `broadcast` are used: gloo supports both on CUDA
tensors and has no `all_gather` for them. `collectives` counts, per
process, the collectives this module made (one per call, where it calls
`torch.distributed`, and nowhere else); `reset_collectives()` zeroes it.
A mesh without a process group (world 1, no group) makes none: every
collective there is the identity.
"""

from __future__ import annotations

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


def _views(buf: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    """Views of `buf`, one shaped like each tensor of `like`, in order."""
    out, at = [], 0
    for t in like:
        out.append(buf[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum `t` in place over the mesh's ranks (one all-reduce)."""
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
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
        for leaf, v in zip(leaves, _views(buf, leaves)):
            leaf.copy_(v)
    return params


def _shard_bounds(n: int, mesh: Mesh, axis: str) -> tuple[int, int]:
    w = mesh.shape.get(axis, 1)
    if n % w:
        raise ValueError(f"batch of {n} not divisible by {axis}-axis size "
                         f"{w}")
    per = n // w
    return mesh.rank * per, (mesh.rank + 1) * per


def dp_shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS):
    """This rank's contiguous rows of a batch (an array or tensor, or a
    tuple of them with one leading size): rows r*b/w to (r+1)*b/w, the
    share `P(axis)` gives device r."""
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


def dp_mean_grads(loss_fn, params, x, y, mesh: Mesh,
                  axis: str = DATA_AXIS):
    """Gradients of loss_fn(params, x, y) -> (scalar loss, aux dict of
    scalars) on this rank's shard, averaged over the axis together with
    the loss and the aux values in ONE all-reduce of one flat float32
    buffer. Returns (mean gradients, one per leaf of `params`; a 1-d
    tensor of the mean loss then the aux values in their order), both
    views of that buffer. On a mesh without a group (`device_mesh`) the
    mean is the value itself: no buffer and no collective."""
    leaves = tree_leaves(params)
    loss, aux = loss_fn(params, x, y)
    grads = torch.autograd.grad(loss, leaves)
    metrics = torch.stack([loss.detach().float()] + [
        torch.as_tensor(v, device=loss.device).float() for v in aux.values()])
    if mesh.group is None:
        return list(grads), metrics
    buf = torch.cat([g.reshape(-1) for g in grads] + [metrics])
    all_reduce_sum(buf, mesh)
    buf /= mesh.shape.get(axis, 1)
    n = buf.numel() - len(metrics)
    return _views(buf[:n], leaves), buf[n:]


def make_dp_train_step(loss_fn, optimizer, mesh: Mesh, *,
                       axis: str = DATA_AXIS):
    """The DP train step: step(state, x, y) -> (state, metrics) on this
    rank's shard x, y (`dp_shard_batch`), with state = {"params",
    "opt_state", "step"} the same on every rank. The gradients and
    metrics are averaged in one all-reduce (`dp_mean_grads`), then
    `optimizer.update` runs in place on the params. `metrics` is the 1-d
    tensor (loss, *aux values), averaged over the axis."""

    def step(state, x, y):
        grads, metrics = dp_mean_grads(loss_fn, state["params"], x, y, mesh,
                                       axis)
        optimizer.update(tree_leaves(state["params"]), grads,
                         state["opt_state"])
        state["step"] += 1
        return state, metrics

    return step


def make_dp_scan_epoch(step, num_classes: int):
    """The device-resident epoch (or a chunk of one) of the DP step `step`
    (`make_dp_train_step`): epoch(state, images, labels, perm, sums) ->
    state, where images (N, H, W, C) uint8 and labels (N,) int32 are the
    whole set on this rank's device, and perm is this rank's (nsteps,
    batch / w) columns of the epoch's permutation (`dp_shard_perm`). Each
    step gathers its rows, divides by PIXEL_SCALE and one-hots on the
    device, then runs `step` and adds its metrics to `sums` in place, on
    the device."""

    def epoch(state, images, labels, perm, sums):
        classes = torch.arange(num_classes, device=images.device)
        for idx in perm:
            x = images.index_select(0, idx).float() / PIXEL_SCALE
            y = (labels.index_select(0, idx)[:, None] == classes).float()
            state, m = step(state, x, y)
            sums += m
        return state

    return epoch


def make_dp_eval_step(predict_fn, mesh: Mesh, *, axis: str = DATA_AXIS):
    """eval_step(params, x) -> predict_fn(params, this rank's rows of the
    eval batch x); the batch must divide by the axis size. The C
    reference evaluates on rank 0 only (cnnmpi.c:521); here every rank
    works on its share."""

    def step(params, x):
        return predict_fn(params, dp_shard_batch(x, mesh, axis))

    return step
