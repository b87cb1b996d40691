"""The collectives of the sharded CNN meshes: tensor parallelism over
'model', FSDP over 'data' and the pipeline over 'pipe' (`parallel/tp.py`,
`parallel/fsdp.py`, `parallel/pp.py`).

The reference leaves these to GSPMD (`parallel/tp.py`, `parallel/fsdp.py`)
and to `lax.ppermute` (`parallel/pp.py`); here they are written out on a
`Mesh` with `torch.distributed`, one process per rank:

- `gather_leaves`: whole leaves along one axis from this rank's blocks,
  in one all-gather (`all_gather_into_tensor`) over the axis' line of
  one flat buffer of the blocks, in their own dtype; a leaf that the
  axis does not split passes as it is;
- `mean_over_data`: the gradients and the step's metrics meaned over the
  data line. Under FSDP it is one reduce-scatter (`reduce_scatter_tensor`)
  of a buffer of n_data chunks: chunk j holds block j of every leaf that
  'data' splits, then the whole of every other leaf and the metrics, so
  rank j receives the sums of its own blocks and of the whole leaves.
  Otherwise it is the data-parallel mean, one all-reduce (`dp.mean_over`);
- `send` / `recv`: one tensor to or from another rank of the world;
- `CopyToModel` / `GatherFromModel`: the autograd pair of a layer whose
  output features are sliced over 'model' (Megatron's f and g): the
  input passes as it is and its gradient, a partial sum over the
  rank's features, is summed over the model line; the output block is
  gathered to the full features (or a leaf to its whole, along any dim)
  and its gradient sliced back to the rank's block;
- `ReduceFromModel`: the end of a row-parallel region (the reference's
  `tp_reduce`): the ranks' partial sums summed over the model line, the
  gradient passed to every rank as it is.

Gloo runs the all-gather, the reduce-scatter and the all-reduce on CUDA
tensors itself (through the host); a send or a receive of one goes
through the host here, as `parallel/sp.py` stages its shifts. Every
call that reaches `torch.distributed` adds one to its kind in
`parallel.dp.collectives` ("all_gather", "reduce_scatter", "send",
"recv"; an all-reduce counts as "all_reduce"), and a call whose line is
this rank alone makes none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import dp
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh


def count(kind: str) -> None:
    dp.collectives[kind] = dp.collectives.get(kind, 0) + 1


def block(t: torch.Tensor, n: int, i: int, dim: int) -> torch.Tensor:
    """Block i of n equal blocks of `t` along `dim`, as a tensor of its
    own (contiguous, 16-byte aligned where the allocator aligns)."""
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).contiguous()


def _via_host(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


@torch.no_grad()
def gather_leaves(blocks: list[torch.Tensor], specs: list[dict], mesh: Mesh,
                  axis: str) -> list[torch.Tensor]:
    """The leaves whole along `axis`, on every rank of this rank's line
    along it, from this rank's `blocks` (spec i names the dim along which
    'axis' splits leaf i, if it does): one all-gather of the split
    blocks, each leaf concatenated from the ranks' blocks in the axis'
    order as a tensor of its own; the other leaves are `blocks`' own."""
    group = mesh.group_of(axis)
    split = [i for i, s in enumerate(specs) if axis in s]
    if group is None or not split:
        return list(blocks)
    n = mesh.shape[axis]
    dtypes = {blocks[i].dtype for i in split}
    dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
    flat = torch.cat([blocks[i].reshape(-1).to(dtype) for i in split])
    rows = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(rows, flat, group=group)
    count("all_gather")
    rows = rows.view(n, -1)
    out, at = list(blocks), 0
    for i in split:
        b, size = blocks[i], blocks[i].numel()
        out[i] = torch.cat([rows[j, at:at + size].view(b.shape)
                            for j in range(n)],
                           dim=specs[i][axis]).to(b.dtype)
        at += size
    return out


def mean_over_data(grads: list[torch.Tensor], metrics: torch.Tensor,
                   specs: list[dict], mesh: Mesh, fsdp: bool):
    """(the gradients meaned over the data line, each in its own dtype;
    the metrics meaned there). Under FSDP the gradients are those of the
    gathered leaves and each rank gets its blocks of those that 'data'
    splits (spec i), in one reduce-scatter; otherwise one all-reduce."""
    group = mesh.group_of(DATA_AXIS)
    split = [i for i, s in enumerate(specs) if DATA_AXIS in s]
    if not fsdp or group is None or not split:
        return dp.mean_over(grads, metrics, mesh, DATA_AXIS)
    n = mesh.shape[DATA_AXIS]
    rest = [i for i in range(len(grads)) if i not in set(split)]
    whole = [grads[i].reshape(-1).float() for i in rest] + [metrics.float()]
    inp = torch.cat([t for j in range(n) for t in [
        block(grads[i], n, j, specs[i][DATA_AXIS]).reshape(-1).float()
        for i in split] + whole])
    buf = inp.new_empty(inp.numel() // n)
    dist.reduce_scatter_tensor(buf, inp, op=dist.ReduceOp.SUM, group=group)
    count("reduce_scatter")
    buf /= n
    out, at = [None] * len(grads), 0
    for i in split + rest:
        shape = list(grads[i].shape)
        if i in split:
            shape[specs[i][DATA_AXIS]] //= n
        size = torch.Size(shape).numel()
        out[i] = buf[at:at + size].view(shape).to(grads[i].dtype)
        at += size
    return out, buf[at:]


def send(t: torch.Tensor, dst: int) -> None:
    """Send `t` to global rank `dst` (blocking)."""
    t = t.detach().contiguous()
    dist.send(t.cpu() if _via_host(t) else t, dst)
    count("send")


def recv(shape, dtype: torch.dtype, device: torch.device,
         src: int) -> torch.Tensor:
    """A tensor of `shape` and `dtype` from global rank `src` (blocking),
    on `device`."""
    host = device.type == "cuda" and dist.get_backend() == "gloo"
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if host else device)
    dist.recv(buf, src)
    count("recv")
    return buf.to(device) if host else buf


class CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the input gradient summed over the
    model line in float32 (each rank's is a partial sum over its
    features)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.float().contiguous().clone()
        dp.all_reduce_sum(total, ctx.mesh, MODEL_AXIS)
        return total.to(g.dtype), None


class GatherFromModel(torch.autograd.Function):
    """The rank's block of dim `dim` (default the last) gathered over the
    model line; backward, the rank's block of the gradient (every rank
    of the line holds the same full gradient: what follows is
    replicated)."""

    @staticmethod
    def forward(ctx, x, mesh, dim=-1):
        ctx.mesh, ctx.dim = mesh, dim % x.dim()
        return gather_leaves([x.contiguous()], [{MODEL_AXIS: ctx.dim}],
                             mesh, MODEL_AXIS)[0]

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return block(g, mesh.shape[MODEL_AXIS], mesh.index(MODEL_AXIS),
                     ctx.dim), None, None


class ReduceFromModel(torch.autograd.Function):
    """The ranks' partial sums summed over the model line in float32 (one
    all-reduce), in x's dtype; backward, the gradient as it is (what
    follows is replicated over the line)."""

    @staticmethod
    def forward(ctx, x, mesh):
        total = x.detach().float().contiguous().clone()
        dp.all_reduce_sum(total, mesh, MODEL_AXIS)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None
