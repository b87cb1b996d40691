"""Tensor parallelism over the 'model' mesh axis, and the sharded CNN step
it shares with FSDP (counterpart of the CNN half of the reference's
`parallel/tp.py`).

The reference has the seam and leaves the work to GSPMD: it places each
Conv/Dense layer's output features over 'model' (`tp_param_specs`: the
last dim of the kernel and the bias; a layer whose features the axis
size does not divide, such as the 10-class head over 4 ranks, stays
whole) and jits the plain step. Its docstring names what a GPU port
writes instead, the Megatron pattern, and this module writes it, one
process per rank:

- each rank holds its own contiguous block of every sliced leaf, as a
  tensor of its own (so the kernels see aligned, dense operands) and
  the whole of every other leaf (`shard_tree`);
- a sliced layer computes its block of the output features with the
  backend's op (with `use_kernels`, K3/K4/K4'/K5 at the sliced N or
  cout), then one all-gather over the model line rebuilds the full
  activation, whose backward takes the rank's block of the gradient;
  the layer's input gradient is a partial sum over the rank's features,
  which one all-reduce over the line completes (`CopyToModel` /
  `GatherFromModel`, `parallel/collectives.py`). Elementwise
  activations act per feature, so gathering after them is exact;
- every rank of a model line computes the replicated layers and the loss
  identically, so their gradients are whole on every rank;
- the gradients and the step's metrics are meaned over the data line in
  one all-reduce, and with `fsdp` the leaves are also blocked over 'data'
  (`parallel/fsdp.py`): gathered over the data line before the forward
  in one all-gather, their gradients reduce-scattered after the backward
  (`collectives.gather_leaves`, `collectives.mean_over_data`).

The global-norm clip sums the squared gradients over the world, each
leaf's counted once (`global_sq`), and scales by the reference's
`clip_grads_by_global_sq`. Augmentation is keyed as the reference's
GSPMD step keys it: fold_in(key(seed), step) over the whole batch, of
which each rank takes its rows.

A spec is a dict {axis: dim} per leaf of a params tree, in
`tree_leaves` order; a checkpoint holds whole leaves, put together from
the blocks over the world (`assemble`, `ShardedCNN.full_state`), and a
restore re-slices them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data import prng
from ..models.layers import tree_leaves
from ..ops.gemv import tree_map
from . import dp
from .collectives import (
    CopyToModel,
    GatherFromModel,
    block,
    gather_leaves,
    mean_over_data,
)
from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh

# Leaves of a gathered buffer start at multiples of this many elements,
# so that a view of one is 16-byte aligned as the kernels want it.
_ALIGN = 4


def tp_sliced(model, n_model: int) -> list[bool]:
    """Per layer: whether its output features are sliced over 'model'
    (a Conv or Dense whose features n_model > 1 divides)."""
    out = []
    for layer in model.layers:
        f = getattr(layer, "features", None)
        out.append(bool(n_model > 1 and f is not None and f % n_model == 0))
    return out


def tp_param_specs(model, params, n_model: int) -> list[dict]:
    """Each leaf's spec: {'model': its last dim} for a leaf of a sliced
    layer whose last dim is the layer's features (the kernel and the
    bias), else {} (whole on every rank)."""
    specs = []
    for layer, p, sliced in zip(model.layers, params,
                                tp_sliced(model, n_model)):
        f = getattr(layer, "features", None)
        for leaf in tree_leaves(p):
            specs.append({MODEL_AXIS: leaf.dim() - 1}
                         if sliced and leaf.shape[-1] == f else {})
    return specs


def unflatten(tree, leaves):
    """`tree` with its leaves replaced by `leaves`, in `tree_leaves`
    order."""
    it = iter(leaves)
    if isinstance(tree, dict):
        return {k: unflatten(tree[k], [next(it) for _ in
                                       tree_leaves(tree[k])])
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [unflatten(v, [next(it) for _ in tree_leaves(v)])
                for v in tree]
    return next(it)


def local_block(full: torch.Tensor, spec: dict, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole leaf under `spec`, a tensor of its
    own."""
    out = full
    for axis, dim in spec.items():
        out = block(out, mesh.shape[axis], mesh.index(axis), dim)
    return out.contiguous()


def shard_tree(params, specs: list[dict], mesh: Mesh):
    """This rank's blocks of every leaf of `params` under `specs`."""
    return unflatten(params, [local_block(t.detach(), s, mesh).clone()
                              for t, s in zip(tree_leaves(params), specs,
                                              strict=True)])


def make_state(local, optimizer) -> dict:
    """A train state of the blocks `local` (made to require grad) and the
    optimizer's state built from them."""
    for t in tree_leaves(local):
        t.requires_grad_(True)
    return {"params": local, "opt_state": optimizer.init(tree_leaves(local)),
            "step": 0}


def make_tp_state(model, params, optimizer, mesh: Mesh
                  ) -> tuple[dict, list[dict]]:
    """(this rank's train state with its blocks of the model-sliced
    leaves, `make_state`; the specs)."""
    specs = tp_param_specs(model, params, mesh.shape.get(MODEL_AXIS, 1))
    return make_state(shard_tree(params, specs, mesh), optimizer), specs


def assemble(blocks: list, shapes: list, specs: list[dict],
             mesh: Mesh, on_every_stage: list[bool] | None = None
             ) -> list[torch.Tensor]:
    """Whole leaves from this rank's blocks, on every rank, for a
    checkpoint or a whole-params read (the step gathers with
    `gather_leaves`): a flat float32 zero buffer into which each rank
    writes its blocks, summed over the world in one all-reduce.
    `blocks[i]` is None where this rank holds nothing of leaf i (another
    pipeline stage's); `shapes[i]` is leaf i's whole shape. A leaf whole
    along an axis but 'pipe' is written by the rank at coordinate 0 there
    alone; so is a leaf that every stage holds (`on_every_stage[i]`, the
    LM pipeline's embedding and head), along 'pipe' too. The leaves come
    back as 16-byte-aligned views of the buffer, in their blocks' dtype
    (float32 where this rank held none)."""
    if mesh.group is None:
        return list(blocks)
    sizes = [math.prod(s) for s in shapes]
    offs = np.concatenate([[0], np.cumsum([-(-n // _ALIGN) * _ALIGN
                                           for n in sizes])])
    buf = torch.zeros(int(offs[-1]), dtype=torch.float32, device=mesh.device)
    views = [buf[int(o):int(o) + n].view(s)
             for o, n, s in zip(offs, sizes, shapes)]
    every = on_every_stage or [False] * len(blocks)
    for b, view, spec, all_stages in zip(blocks, views, specs, every,
                                         strict=True):
        if b is None or any(mesh.index(a) for a in mesh.shape
                            if a not in spec
                            and (a != PIPE_AXIS or all_stages)):
            continue
        region = view
        for axis, dim in spec.items():
            n = b.shape[dim]
            region = region.narrow(dim, mesh.index(axis) * n, n)
        region.copy_(b.detach())
    dp.all_reduce_sum(buf, mesh)
    return [v if b is None or b.dtype == torch.float32 else v.to(b.dtype)
            for v, b in zip(views, blocks)]


def global_sq(grads: list[torch.Tensor], specs: list[dict],
              mesh: Mesh, on_every_stage: list[bool] | None = None
              ) -> torch.Tensor:
    """The squared global norm of gradients held as blocks, on every
    rank: each rank's float32 sum of squares, each leaf's divided by the
    ranks that hold the same block of it (every axis but 'pipe' that its
    spec does not name, and 'pipe' too for a leaf every stage holds,
    `on_every_stage`), summed over the world in one all-reduce. The
    mesh sizes are powers of two in practice, so the division is
    exact."""
    from ..train.optimizer import grad_sq

    by_rep: dict[int, list[torch.Tensor]] = {}
    every = on_every_stage or [False] * len(grads)
    for g, spec, all_stages in zip(grads, specs, every, strict=True):
        rep = math.prod(n for a, n in mesh.shape.items()
                        if a not in spec and (a != PIPE_AXIS or all_stages))
        by_rep.setdefault(rep, []).append(g)
    total = torch.zeros(1, dtype=torch.float32, device=mesh.device)
    for rep, gs in by_rep.items():
        total += grad_sq(gs) / rep
    return dp.all_reduce_sum(total, mesh)[0]


def apply_layers(layers, params, x: torch.Tensor, mesh: Mesh,
                 sliced: list[bool], *, backend: str,
                 remat: bool = False) -> torch.Tensor:
    """x through `layers` with their (possibly sliced) params: a sliced
    layer computes its block of the features and gathers them over the
    model line (`CopyToModel` before it, `GatherFromModel` after it);
    with remat each layer's forward is recomputed in the backward."""
    for layer, p, s in zip(layers, params, sliced, strict=True):
        if s:
            x = CopyToModel.apply(x, mesh)
        if remat:
            x = checkpoint(functools.partial(layer.apply, backend=backend),
                           p, x, use_reentrant=False)
        else:
            x = layer.apply(p, x, backend=backend)
        if s:
            x = GatherFromModel.apply(x, mesh)
    return x


class ShardedCNN:
    """One rank's tensor-parallel and/or fully-sharded CNN: its specs,
    its state, its forward and its train step (see the module
    docstring). `fsdp` blocks the leaves over 'data' too."""

    def __init__(self, model, mesh: Mesh, *, fsdp: bool, backend: str,
                 compute_dtype: torch.dtype | None = None,
                 remat: bool = False):
        self.model = model
        self.mesh = mesh
        self.fsdp = fsdp and mesh.shape.get(DATA_AXIS, 1) > 1
        self.backend = backend
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.n_model = mesh.shape.get(MODEL_AXIS, 1)
        self.sliced = tp_sliced(model, self.n_model)
        self.specs: list[dict] = []
        self.shapes: list[tuple[int, ...]] = []

    # -- state ----------------------------------------------------------

    def place(self, params, optimizer) -> dict:
        """The train state of this rank from the whole params (on its
        device): its blocks, requiring grad, and the optimizer's state
        built from them."""
        from .fsdp import make_fsdp_state

        self.shapes = [tuple(t.shape) for t in tree_leaves(params)]
        if not self.fsdp:
            state, self.specs = make_tp_state(self.model, params, optimizer,
                                              self.mesh)
            return state
        state, self.specs = make_fsdp_state(
            params, optimizer, self.mesh,
            base_specs=tp_param_specs(self.model, params, self.n_model))
        return state

    def working(self, params):
        """The params the forward reads: this rank's blocks, gathered
        over the data line under FSDP (fresh leaves that require grad)."""
        if not self.fsdp:
            return params
        full = gather_leaves(tree_leaves(params), self.specs, self.mesh,
                             DATA_AXIS)
        return unflatten(params, [t.detach().requires_grad_(True)
                                  for t in full])

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """Float32 logits of x, whole on every rank of the model line,
        from the working params."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
            params = tree_map(lambda t: t.to(self.compute_dtype), params)
        return apply_layers(self.model.layers, params, x, self.mesh,
                            self.sliced, backend=self.backend,
                            remat=self.remat).float()

    @torch.no_grad()
    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.working(params), x)

    # -- whole leaves ---------------------------------------------------

    def full_leaves(self, leaves: list[torch.Tensor]) -> list[torch.Tensor]:
        """Whole leaves (the params, then any state buffers built from
        them, each a list in the params' order) from this rank's blocks,
        on every rank."""
        k = len(leaves) // len(self.shapes)
        return assemble(leaves, self.shapes * k, self.specs * k, self.mesh)

    def full_state(self, state: dict) -> dict:
        """The state with whole leaves (params and optimizer buffers), as
        the reference's checkpoints hold it; one all-gather."""
        params = tree_leaves(state["params"])
        opt = state["opt_state"]
        roles = [r for r in ("trace", "mu", "nu") if opt.get(r)]
        n = len(params)
        full = self.full_leaves(params + [t for r in roles for t in opt[r]])
        out_opt = dict(opt)
        for i, r in enumerate(roles):
            out_opt[r] = full[n * (i + 1):n * (i + 2)]
        return {"params": unflatten(state["params"], full[:n]),
                "opt_state": out_opt, "step": state["step"]}

    @torch.no_grad()
    def load_full(self, state: dict, full: dict) -> None:
        """Install a whole-leaf state (`full_state`'s form) into this
        rank's blocks, in place."""
        def copy(dst, src):
            for d, s, spec in zip(dst, src, self.specs, strict=True):
                d.copy_(local_block(s.to(d.device, d.dtype), spec,
                                    self.mesh))

        copy(tree_leaves(state["params"]), tree_leaves(full["params"]))
        opt = state["opt_state"]
        for r in ("trace", "mu", "nu"):
            if opt.get(r):
                copy(opt[r], full["opt_state"][r])
        opt["count"] = full["opt_state"]["count"]
        state["step"] = full["step"]

    # -- the step -------------------------------------------------------

    def make_train_step(self, loss_fn, optimizer, *, view=None,
                        augment=None, aug_seed: int = 0,
                        grad_accum: int = 1, grad_clip: float = 0.0):
        """step(state, x, y, aug=None) -> (state, metrics) on this rank's
        rows x, y of the batch (its data block), with `.grads` (the local
        gradients and metrics, before the update) and `.draws` (None
        without augmentation), as `dp.make_dp_train_step` builds them."""
        from ..train.optimizer import clip_grads_by_global_sq

        mesh = self.mesh
        n_data = mesh.shape.get(DATA_AXIS, 1)

        def draws(steps, rows: int):
            """The whole batch's draws under fold_in(key(seed), step),
            this rank's rows of them, on the device."""
            keys = prng.fold_in(prng.key(aug_seed), np.asarray(steps))
            off, flip = augment.draw(keys, rows * n_data)
            lo = mesh.index(DATA_AXIS) * rows
            return augment.to_device((off[:, lo:lo + rows],
                                      flip[:, lo:lo + rows]), mesh.device)

        def grads(state, x, y, aug=None):
            if augment is not None:
                if aug is None:
                    aug = tuple(t[0] for t in draws([state["step"]], len(x)))
                x = augment.apply(x, *aug)
            g, metrics = dp.local_grads(loss_fn,
                                        self.working(state["params"]), x, y,
                                        grad_accum, view)
            return mean_over_data(g, metrics, self.specs, mesh, self.fsdp)

        def step(state, x, y, aug=None):
            g, metrics = grads(state, x, y, aug)
            if grad_clip > 0:
                g = clip_grads_by_global_sq(
                    g, global_sq(g, self.specs, mesh), grad_clip)
            optimizer.update(tree_leaves(state["params"]), g,
                             state["opt_state"], clip=False)
            state["step"] += 1
            return state, metrics

        step.grads = grads
        step.draws = draws if augment is not None else None
        return step
