"""Pipeline parallelism over a 'pipe' mesh axis (counterpart of the
reference's `parallel/pp.py`).

The C reference runs its layers one after another in one process
(cnn.c:255-267); the JAX package splits them into S contiguous stages
balanced by a forward-MAC estimate (`make_pipeline_plan`, the same
split here to the layer), packs each stage's params into one row of an
(S, P_max) array ((S, M, Pm_max) under TP x PP, one row per model
shard), and runs the GPipe schedule of M + S - 1 ticks in one
`shard_map`, the loss taken on the last stage and `jax.grad`'s transpose
of the forward shifts carrying the backward. Here one process is one
rank, at pipe coordinate s, and it holds its stage's leaves as tensors
of its own (the kernels want aligned, dense operands; a leaf at an
arbitrary offset of a packed row is neither). The rows are packed only
at the checkpoint boundary (`pack_params` / `unpack_params`), so a file
moves between the packages on the same mesh. The step
(`Pipeline.make_train_step`), for this rank's rows of the batch split
into M microbatches:

- forward, microbatch 0 to M - 1: stage 0 reads its microbatch, a later
  stage receives the previous stage's activations (`collectives.recv`),
  applies its layers (TP-sliced under 'model', `tp.apply_layers`) and
  sends its float32 output on; the last stage takes each microbatch's
  softmax-CE over M, the reference's mean of the microbatch means;
- backward, microbatch M - 1 down to 0: the last stage differentiates
  its loss, a stage before it receives its output's gradient; each
  stage sums its params' gradients over the microbatches and sends its
  input's gradient back;
- the gradients and metrics are meaned over the data line (one
  all-reduce, or under FSDP x PP one reduce-scatter of the gathered
  stage leaves, `collectives.mean_over_data`), and the metrics, which
  only the last stage holds, are summed over the world in one all-reduce
  so that every rank reports them, as the reference's psum over 'pipe'
  does.

Under TP x PP a sliced layer's input gradient is completed over 'model'
(`collectives.CopyToModel`), so every rank's replicated leaves have
their whole gradient and no repair mask is needed (the reference's
`_tp_replicated_mask` repairs the partial gradients its psum-scatter
leaves). FSDP x PP blocks each stage leaf over 'data' by the FSDP rule
(`parallel/fsdp.py`) where the reference blocks the packed row: the
same gradient and update, each rank holding a 1/n_data share. With
`grad_clip` the squared norm is summed over the world, each leaf's once
(`tp.global_sq`), and applied by `clip_grads_by_global_sq`, as the
reference clips in its step. Augmentation is keyed as the reference
keys it: fold_in(key(seed), step), then the data coordinate when the
mesh has a data axis, over this rank's M x mb rows.

The eval runs the same forward with no gradient and sums the last
stage's logits over the pipe line (`Pipeline.forward`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data import prng
from ..models.layers import tree_leaves
from ..ops.activations import stable_softmax
from ..ops.gemv import tree_map
from ..ops.losses import softmax_cross_entropy, squared_error_total
from . import dp
from .collectives import gather_leaves, mean_over_data, recv, send
from .fsdp import fsdp_specs
from .mesh import DATA_AXIS, PIPE_AXIS, Mesh
from .tp import (
    apply_layers,
    assemble,
    global_sq,
    local_block,
    tp_param_specs,
    unflatten,
)


def _zeros_init(key, shape):
    return torch.zeros(shape, dtype=torch.float32)


def _layer_cost(layer, in_shape, out_shape, params) -> int:
    """The reference's forward-MAC estimate that balances the stages:
    a layer with weights costs their count times its output positions,
    one without costs its input's element count."""
    wsize = sum(t.numel() for t in tree_leaves(params))
    if not wsize:
        return int(np.prod(in_shape))
    positions = int(np.prod(out_shape[:-1])) if len(out_shape) > 1 else 1
    return wsize * positions


def _partition_balanced(costs: list[int], n_stages: int
                        ) -> list[tuple[int, ...]]:
    """The contiguous split of the layers into n_stages groups with the
    least largest group cost (the reference's linear-partition DP, tie
    for tie)."""
    n = len(costs)
    if n_stages > n:
        raise ValueError(f"{n_stages} stages > {n} layers")
    prefix = np.concatenate([[0], np.cumsum(costs)])
    best = np.full((n_stages + 1, n + 1), np.inf)
    cut = np.zeros((n_stages + 1, n + 1), np.int64)
    best[0][0] = 0
    for k in range(1, n_stages + 1):
        for j in range(k, n + 1):
            for i in range(k - 1, j):
                c = max(best[k - 1][i], prefix[j] - prefix[i])
                if c < best[k][j]:
                    best[k][j] = c
                    cut[k][j] = i
    bounds = [n]
    for k in range(n_stages, 0, -1):
        bounds.append(int(cut[k][bounds[-1]]))
    bounds.reverse()
    return [tuple(range(bounds[k], bounds[k + 1])) for k in range(n_stages)]


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """Which layers run on which stage, the per-sample shapes at the
    stage and layer inputs, each stage's local leaf shapes (per model
    shard under TP x PP), and the reference's padded widths: a_max, the
    widest per-sample activation crossing a stage boundary, and p_max,
    the longest stage row (a multiple of the data-axis size under FSDP x
    PP)."""

    model: object
    n_stages: int
    stage_layers: tuple[tuple[int, ...], ...]
    stage_in_shapes: tuple[tuple[int, ...], ...]
    layer_in_shapes: tuple[tuple[int, ...], ...]
    param_shapes: tuple[tuple[tuple[int, ...], ...], ...]
    num_classes: int
    a_max: int
    p_max: int
    backend: str = "torch"
    compute_dtype: torch.dtype | None = None
    n_model: int = 1
    layer_sliced: tuple[bool, ...] = ()
    remat: bool = False
    fsdp: bool = False


def _local_leaf_shape(shape, features, sliced: bool, n_model: int):
    if sliced and shape and shape[-1] == features:
        return tuple(shape[:-1]) + (shape[-1] // n_model,)
    return tuple(shape)


def make_pipeline_plan(model, n_stages: int, *, backend: str = "torch",
                       compute_dtype=None, n_model: int = 1,
                       remat: bool = False,
                       fsdp_degree: int = 1) -> PipelinePlan:
    """The reference's plan of `model` (a Sequential) over n_stages
    stages, its Conv/Dense features sliced over n_model model shards."""
    key = prng.key(0)
    shape = tuple(model.input_shape)
    layer_in_shapes, costs, zero_params, sliced = [], [], [], []
    for layer in model.layers:
        p, out = layer.init(key, shape, _zeros_init)
        layer_in_shapes.append(tuple(shape))
        costs.append(_layer_cost(layer, shape, out, p))
        zero_params.append(p)
        f = getattr(layer, "features", None)
        sliced.append(bool(n_model > 1 and f is not None
                           and f % n_model == 0))
        shape = tuple(out)
    num_classes = int(shape[-1])
    stage_layers = _partition_balanced(costs, n_stages)
    stage_in, param_shapes, p_sizes = [], [], []
    widths = [int(np.prod(model.input_shape))]
    for idxs in stage_layers:
        stage_in.append(layer_in_shapes[idxs[0]])
        local = [_local_leaf_shape(tuple(t.shape),
                                   getattr(model.layers[i], "features", None),
                                   sliced[i], n_model)
                 for i in idxs for t in tree_leaves(zero_params[i])]
        param_shapes.append(tuple(local))
        p_sizes.append(sum(int(np.prod(s)) for s in local))
        end = idxs[-1] + 1
        out_shape = layer_in_shapes[end] if end < len(model.layers) else shape
        widths.append(int(np.prod(out_shape)))
    p_max = max(p_sizes) if p_sizes else 1
    if fsdp_degree > 1:
        p_max += -p_max % fsdp_degree
    return PipelinePlan(
        model=model, n_stages=n_stages, stage_layers=tuple(stage_layers),
        stage_in_shapes=tuple(stage_in),
        layer_in_shapes=tuple(layer_in_shapes),
        param_shapes=tuple(param_shapes), num_classes=num_classes,
        a_max=max(widths), p_max=p_max, backend=backend,
        compute_dtype=compute_dtype, n_model=n_model,
        layer_sliced=tuple(sliced), remat=remat, fsdp=fsdp_degree > 1)


def _stage_local_leaves(plan: PipelinePlan, params, idxs, m: int) -> list:
    """Stage leaves of model shard m, in tree order, features sliced."""
    out = []
    for i in idxs:
        f = getattr(plan.model.layers[i], "features", None)
        for leaf in tree_leaves(params[i]):
            leaf = np.asarray(leaf.detach().cpu() if isinstance(
                leaf, torch.Tensor) else leaf, np.float32)
            if plan.layer_sliced[i] and leaf.shape and leaf.shape[-1] == f:
                w = leaf.shape[-1] // plan.n_model
                leaf = leaf[..., m * w:(m + 1) * w]
            out.append(leaf)
    return out


def pack_params(plan: PipelinePlan, params) -> np.ndarray:
    """A whole params tree (the Sequential's per-layer list; tensors or
    arrays) -> the reference's packed float32 rows: (S, P_max), or (S,
    M, P_max) under TP x PP, each row a stage's (model shard's) leaves
    raveled in tree order and zero-padded."""
    def row(leaves):
        out = np.zeros(plan.p_max, np.float32)
        flat = (np.concatenate([np.ravel(x) for x in leaves]) if leaves
                else np.zeros(0, np.float32))
        out[:flat.size] = flat
        return out

    if plan.n_model == 1:
        return np.stack([row(_stage_local_leaves(plan, params, idxs, 0))
                         for idxs in plan.stage_layers])
    return np.stack([np.stack([row(_stage_local_leaves(plan, params, idxs,
                                                       m))
                               for m in range(plan.n_model)])
                     for idxs in plan.stage_layers])


def unpack_params(plan: PipelinePlan, packed, template) -> list:
    """Packed rows -> the whole params tree in the structure of
    `template` (a params tree of the model), float32 CPU tensors; under
    TP x PP the sliced leaves are concatenated from the model shards and
    the replicated ones read from shard 0."""
    packed = np.asarray(packed, np.float32)
    out = []
    for s, idxs in enumerate(plan.stage_layers):
        shards = [packed[s]] if plan.n_model == 1 else list(packed[s])
        leaves_m = []
        for flat in shards:
            leaves, off = [], 0
            for shp in plan.param_shapes[s]:
                n = int(np.prod(shp))
                leaves.append(flat[off:off + n].reshape(shp))
                off += n
            leaves_m.append(leaves)
        k = 0
        for i in idxs:
            f = getattr(plan.model.layers[i], "features", None)
            whole = []
            for leaf in tree_leaves(template[i]):
                parts = [lm[k] for lm in leaves_m]
                if (plan.layer_sliced[i] and parts[0].shape
                        and parts[0].shape[-1] * plan.n_model == f
                        and leaf.shape[-1] == f):
                    whole.append(np.concatenate(parts, axis=-1))
                else:
                    whole.append(parts[0])
                k += 1
            out.append((i, unflatten(template[i], [
                torch.from_numpy(np.array(w, copy=True)) for w in whole])))
    tree = [None] * len(plan.model.layers)
    for i, p in out:
        tree[i] = p
    return tree


def microbatch_rows(n: int, m: int, n_data: int, d: int) -> np.ndarray:
    """The rows of a batch of n that data rank d of n_data takes on the
    reference's per-batch route, in microbatch order: the batch split
    into m microbatches of n / m (`microbatch`), then each microbatch's
    rows split over the data axis (`pp_shard_batch`)."""
    mb = n // (m * n_data)
    return (np.arange(n).reshape(m, n // m)[:, d * mb:(d + 1) * mb]
            .reshape(-1))


def gpipe_grads(M: int, leaves: list[torch.Tensor], *, prev: int | None,
                next: int | None, device: torch.device, in_shape,
                in_dtype: torch.dtype, first_input, stage, drain
                ) -> list[torch.Tensor]:
    """The GPipe schedule of one stage of a pipeline, for M microbatches:
    the gradients of `leaves` summed over them. The one schedule of the
    CNN's and the LM's pipelines (`parallel/pp_lm.py`).

    Forward, microbatch 0 to M - 1: the first stage takes
    `first_input(m)`, a later one receives an `in_shape` tensor of
    `in_dtype` from global rank `prev`; `stage(inp, m)` -> (out, extra)
    runs the stage, `extra` a scalar of this stage's own to differentiate
    beside its output (None: none); the output goes on to rank `next`,
    or on the last stage `drain(out, m)` gives the microbatch's scalar
    loss. Backward, microbatch M - 1 down to 0: the last stage
    differentiates its loss (and extra), a stage before it receives its
    output's gradient; each stage sends its input's gradient back. A leaf
    that a stage does not use gets a zero gradient."""
    saved = []
    for m in range(M):
        inp = (first_input(m) if prev is None else
               recv(in_shape, in_dtype, device, prev).requires_grad_(True))
        out, extra = stage(inp, m)
        if next is not None:
            send(out, next)
            saved.append((inp, out, extra))
            continue
        loss = drain(out, m)
        saved.append((inp, loss if extra is None else loss + extra, None))
    total = None
    for m in reversed(range(M)):
        inp, out, extra = saved[m]
        if next is not None:
            # the vector-Jacobian product as the gradient of a scalar,
            # <out, g>: the same gradients bit for bit (ones times g),
            # and autograd's grad_outputs path, which imports sympy on
            # its first call (seconds in a fresh rank), is not taken
            g_out = recv(out.shape, out.dtype, device, next)
            out = (out * g_out).sum()
            if extra is not None:
                out = out + extra
        wrt = leaves + ([inp] if prev is not None else [])
        gs = [torch.zeros_like(t) if g is None else g for g, t in zip(
            torch.autograd.grad(out, wrt, allow_unused=True), wrt)] \
            if wrt else []
        if prev is not None:
            send(gs.pop(), prev)
        if total is None:
            total = gs
        else:
            torch._foreach_add_(total, gs)
    return total or []


class Pipeline:
    """One rank's pipeline stage (TP-sliced over 'model' and blocked
    over 'data' under FSDP as the plan says): its state, its forward and
    its train step (see the module docstring)."""

    def __init__(self, plan: PipelinePlan, mesh: Mesh, num_microbatches: int,
                 *, has_data: bool):
        self.plan = plan
        self.mesh = mesh
        self.M = num_microbatches
        self.has_data = has_data
        self.stage = mesh.index(PIPE_AXIS)
        self.S = plan.n_stages
        line = mesh.line(PIPE_AXIS)
        self.prev = line[self.stage - 1] if self.stage > 0 else None
        self.next = line[self.stage + 1] if self.stage < self.S - 1 else None
        self.layers = plan.stage_layers[self.stage]
        self.specs: list[dict] = []       # every leaf of the model
        self.shapes: list[tuple[int, ...]] = []
        self.mine: list[bool] = []        # per leaf: on this stage

    # -- state ----------------------------------------------------------

    def place(self, params, optimizer) -> dict:
        """This rank's state from the whole params: its stage's leaves
        (blocks under TP / FSDP), {} for the other stages' layers, and the
        optimizer's state built from them."""
        mesh, plan = self.mesh, self.plan
        specs = tp_param_specs(plan.model, params, plan.n_model)
        if plan.fsdp:
            specs = fsdp_specs(params, mesh.shape[DATA_AXIS],
                               base_specs=specs)
        self.specs = specs
        self.shapes = [tuple(t.shape) for t in tree_leaves(params)]
        self.mine = [i in self.layers for i, p in enumerate(params)
                     for _ in tree_leaves(p)]
        local, k = [], 0
        for i, p in enumerate(params):
            n = len(tree_leaves(p))
            if i in self.layers:
                blocks = [local_block(t.detach(), s, mesh).clone()
                          .requires_grad_(True)
                          for t, s in zip(tree_leaves(p), specs[k:k + n])]
                local.append(unflatten(p, blocks))
            else:
                local.append({})
            k += n
        return {"params": local,
                "opt_state": optimizer.init(tree_leaves(local)), "step": 0}

    def _my_specs(self) -> list[dict]:
        return [s for s, m in zip(self.specs, self.mine) if m]

    def working(self, params):
        """This stage's params as the forward reads them: gathered over
        the data line under FSDP x PP (fresh leaves that require grad)."""
        if not self.plan.fsdp:
            return params
        full = gather_leaves(tree_leaves(params), self._my_specs(),
                             self.mesh, DATA_AXIS)
        return unflatten(params, [t.detach().requires_grad_(True)
                                  for t in full])

    def stage_apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """This stage's layers on x (mb, *stage input shape): float32
        output, its features whole."""
        plan = self.plan
        stage = [params[i] for i in self.layers]
        if plan.compute_dtype is not None:
            x = x.to(plan.compute_dtype)
            stage = tree_map(lambda t: t.to(plan.compute_dtype), stage)
        y = apply_layers([plan.model.layers[i] for i in self.layers], stage,
                         x, self.mesh,
                         [plan.layer_sliced[i] for i in self.layers],
                         backend=plan.backend, remat=plan.remat)
        return y.float()

    def _in_shape(self, mb: int) -> tuple[int, ...]:
        return (mb, *self.plan.stage_in_shapes[self.stage])

    @torch.no_grad()
    def forward(self, params, x: torch.Tensor,
                m: int | None = None) -> torch.Tensor:
        """Float32 logits of this rank's rows x (m microbatches, default
        the step's), on every rank of the pipe line: the forward schedule,
        then the last stage's logits summed over the line (one
        all-reduce; the others add zeros)."""
        m = m or self.M
        params = self.working(params)
        mb = len(x) // m
        outs = []
        for i in range(m):
            inp = (x[i * mb:(i + 1) * mb] if self.prev is None
                   else recv(self._in_shape(mb), torch.float32,
                             self.mesh.device, self.prev))
            y = self.stage_apply(params, inp)
            if self.next is not None:
                send(y, self.next)
            else:
                outs.append(y)
        logits = (torch.cat(outs) if outs else
                  torch.zeros((len(x), self.plan.num_classes),
                              device=self.mesh.device))
        return dp.all_reduce_sum(logits, self.mesh, PIPE_AXIS)

    # -- whole leaves and the reference's packed rows ---------------------

    def full_leaves(self, leaves: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every whole leaf of the model from this stage's blocks, on
        every rank (one all-gather over the world)."""
        it = iter(leaves)
        blocks = [next(it) if m else None for m in self.mine]
        return assemble(blocks, self.shapes, self.specs, self.mesh)

    def checkpoint_arrays(self, state: dict, optimizer, template) -> dict:
        """The reference's PP checkpoint arrays of the state: the packed
        rows as "flat_params", the momentum trace packed as its rows, the
        counts and the step (`convert.opt_state_names`)."""
        from ..convert import opt_state_names

        names = opt_state_names(optimizer)
        opt = state["opt_state"]
        n = len(self.shapes)
        trace = opt["trace"] if "trace" in names else []
        it = iter(tree_leaves(state["params"]) + trace)
        blocks = [next(it) if m else None for m in self.mine]
        if "trace" in names:
            blocks += [next(it) if m else None for m in self.mine]
        full = assemble(blocks, self.shapes * (len(blocks) // n),
                        self.specs * (len(blocks) // n), self.mesh)
        arrays = {"flat_params": pack_params(
            self.plan, unflatten(template, full[:n]))}
        count_ = np.asarray(opt["count"], np.int32)
        for role in ("count", "schedule"):
            if role in names:
                arrays[names[role]] = count_
        if "trace" in names:
            arrays[names["trace"]] = pack_params(
                self.plan, unflatten(template, full[n:]))
        arrays["step"] = np.asarray(state["step"], np.int32)
        return arrays

    @torch.no_grad()
    def load_arrays(self, state: dict, arrays: dict, optimizer,
                    template) -> None:
        """Install the reference's PP checkpoint arrays into this rank's
        stage blocks, in place."""
        from ..convert import opt_state_names

        names = opt_state_names(optimizer)

        def copy(dst, packed):
            whole = tree_leaves(unpack_params(self.plan, packed, template))
            mine = [(w, s) for w, s, m in zip(whole, self.specs, self.mine)
                    if m]
            for d, (w, spec) in zip(dst, mine, strict=True):
                d.copy_(local_block(w.to(d.device, d.dtype), spec,
                                    self.mesh))

        copy(tree_leaves(state["params"]), arrays["flat_params"])
        opt = state["opt_state"]
        if "trace" in names:
            copy(opt["trace"], arrays[names["trace"]])
        state["step"] = int(arrays["step"])
        key = names.get("count", names.get("schedule"))
        opt["count"] = state["step"] if key is None else int(arrays[key])

    # -- the step -------------------------------------------------------

    def make_train_step(self, optimizer, *, augment=None, aug_seed: int = 0,
                        grad_clip: float = 0.0):
        """step(state, x, y, aug=None) -> (state, metrics) on this rank's
        rows x, y of the batch in microbatch order (M x mb), with
        `.grads` and `.draws` as `dp.make_dp_train_step` builds them."""
        from ..train.optimizer import clip_grads_by_global_sq

        mesh = self.mesh

        def draws(steps, rows: int):
            keys = prng.fold_in(prng.key(aug_seed), np.asarray(steps))
            if self.has_data:
                keys = prng.fold_in(keys, np.full(len(keys),
                                                  mesh.index(DATA_AXIS)))
            return augment.to_device(augment.draw(keys, rows), mesh.device)

        def grads(state, x, y, aug=None):
            if augment is not None:
                if aug is None:
                    aug = tuple(t[0] for t in draws([state["step"]], len(x)))
                x = augment.apply(x, *aug)
            return self._grads(state["params"], x, y)

        def step(state, x, y, aug=None):
            g, metrics = grads(state, x, y, aug)
            if grad_clip > 0:
                g = clip_grads_by_global_sq(
                    g, global_sq(g, self._my_specs(), mesh), grad_clip)
            optimizer.update(tree_leaves(state["params"]), g,
                             state["opt_state"], clip=False)
            state["step"] += 1
            return state, metrics

        step.grads = grads
        step.draws = draws if augment is not None else None
        return step

    def _grads(self, params, x: torch.Tensor, y: torch.Tensor):
        """The GPipe schedule of one step on this rank's rows: (this
        stage's gradients, meaned over the data line, as blocks; the
        step's (loss, etotal, acc) on every rank)."""
        mesh, M = self.mesh, self.M
        work = self.working(params)
        leaves = tree_leaves([work[i] for i in self.layers])
        mb = len(x) // M
        metrics = torch.zeros(3, device=mesh.device)

        def drain(out, m):
            ym = y[m * mb:(m + 1) * mb]
            loss = softmax_cross_entropy(out, ym) / M
            with torch.no_grad():
                logits = out.detach()
                acc = (logits.argmax(-1) == ym.argmax(-1)).float().mean()
                metrics.add_(torch.stack([
                    loss.detach(),
                    squared_error_total(stable_softmax(logits), ym) / M,
                    acc / M]))
            return loss

        total = gpipe_grads(
            M, leaves, prev=self.prev, next=self.next, device=mesh.device,
            in_shape=self._in_shape(mb), in_dtype=torch.float32,
            first_input=lambda m: x[m * mb:(m + 1) * mb],
            stage=lambda inp, m: (self.stage_apply(work, inp), None),
            drain=drain)
        return self._reduce(total, metrics)

    def _reduce(self, grads: list[torch.Tensor], metrics: torch.Tensor):
        """The stage's gradients meaned over the data line (under FSDP x
        PP this rank's blocks of them), and the metrics on every rank:
        the last stage's data mean, summed over the world from the rank
        at coordinate 0 of every axis but 'pipe' (one all-reduce)."""
        mesh = self.mesh
        grads, metrics = mean_over_data(grads, metrics, self._my_specs(),
                                        mesh, self.plan.fsdp)
        mine = self.next is None and not any(
            mesh.index(a) for a in mesh.shape if a != PIPE_AXIS)
        metrics = metrics * float(mine)
        return grads, dp.all_reduce_sum(metrics, mesh)
