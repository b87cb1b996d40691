"""One rank of a sharded LM mesh: tensor parallelism over 'model',
FSDP over 'data' and the pipeline over 'pipe', composed with 'seq' and
'data' as the reference's LM trainer composes them (its GSPMD placements
of `parallel/tp.py` and `parallel/fsdp.py`, and its shard_map steps of
`parallel/tp_sp.py`, `parallel/pp_lm.py`, `parallel/tp_pp_lm.py` and the
FSDP branch of `parallel/sp.py`). The LM's twin of the CNN's
`tp.ShardedCNN` and `pp.Pipeline`.

The rank holds, as tensors of their own:

- the blocks of its pipeline stage (all of them without a pipe axis),
  in the head-structured layout when there is a model axis
  (`tp_sp.to_tp_layout`), each leaf sliced over 'model' where the
  Megatron block slices it (`tp_sp.tp_block_spec`); on the plain
  `data:N,model:M` mesh the token embedding and the head are split on
  the vocab too (the reference's `lm_tp_specs`), and gathered whole
  before use (`collectives.GatherFromModel`);
- the embedding, positional table, final layernorm and head ('rest'),
  on every stage;
- under --fsdp each leaf's block over 'data' on the largest dim that
  'model' leaves free (`fsdp.fsdp_specs`), gathered over the data line
  before the forward (one all-gather) and its gradient reduce-scattered
  after the backward (`collectives.mean_over_data`).

The forward is the reference's on the rank's tokens: its rows, and
under 'seq' its positions (offset by its coordinate), with the
attention of the mesh (full-sequence flash or oracle, or ring,
ring-flash or Ulysses over 'seq'), the Megatron block on a model axis
(`tp_sp.tp_block_apply`) and the model's own block otherwise. MoE
blocks route as the reference's step of the mesh routes them: the data
line's tokens as one batch on the plain TP and FSDP meshes (its GSPMD
step routes the global batch), expert-parallel over 'seq' under FSDP x
SP and SP x PP, and the rank's own tokens on the TP x SP and pipelined
meshes. On a pipe axis the step is the GPipe schedule of
`pp.gpipe_grads` over M = n_pipe microbatches.

The gradients are meaned over the axes whose ranks hold other tokens
('data' and 'seq'; on a pipe axis the rest's gradients and the loss are
first summed over 'pipe'), and the global-norm clip runs in the step
with the norm over the world, each leaf counted once (`tp.global_sq`).
A checkpoint holds the reference's tree of the mesh: the standard tree
on the plain TP and FSDP meshes, the head-structured blocks under TP x
SP, the stacked blocks and 'rest' on a pipe axis (head-structured under
TP x PP), made on every rank from the blocks (`tp.assemble`, one
all-reduce); a restore installs each rank's blocks of it.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..models.layers import tree_leaves
from ..ops.gemv import tree_map
from . import dp
from .collectives import GatherFromModel, gather_leaves, mean_over_data
from .fsdp import fsdp_specs
from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh
from .pp import gpipe_grads
from .pp_lm import _check_pp_lm, stack_blocks, unstack_blocks
from .tp import assemble, global_sq, local_block, make_state, unflatten
from .tp_pp_lm import _check_tp_pp
from .tp_sp import (
    _check_tp_sp,
    from_tp_layout,
    to_tp_layout,
    tp_block_apply,
    tp_block_spec,
)


def _paths(tree, prefix: tuple = ()):
    """(key path, leaf) of a params tree, in `tree_leaves` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


class ShardedLM:
    """One rank's sharded LM (see the module docstring): its specs, its
    state, its step, and its whole leaves for checkpoints, eval and
    decode. `attn_impl` is resolved: "flash" or "oracle", or under a seq
    axis "ring", "ring_flash" or "ulysses"."""

    def __init__(self, model, mesh: Mesh, *, attn_impl: str,
                 fsdp: bool = False, compute_dtype=None, remat: bool = False,
                 ce_chunk: int = 0, grad_accum: int = 1,
                 moe_aux_weight: float = 0.01, moe_dispatch_dtype=None):
        from .sp import _BODIES
        from ..train.lm import get_attn_fn

        self.model, self.mesh = model, mesh
        self.n_data, self.n_model, self.n_pipe, self.n_seq = (
            mesh.shape.get(a, 1)
            for a in (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS))
        self.fsdp = fsdp and self.n_data > 1
        self.cd = compute_dtype
        self.remat, self.ce_chunk, self.grad_accum = remat, ce_chunk, \
            grad_accum
        self.tp = self.n_model > 1
        strict = self.tp and (self.n_seq > 1 or self.n_pipe > 1)
        if self.tp and self.n_pipe > 1:
            _check_tp_pp(model, self.n_pipe, self.n_model)
        elif strict:
            _check_tp_sp(model, self.n_model)
        elif self.n_pipe > 1:
            _check_pp_lm(model, self.n_pipe)
        n = self.n_model
        # the plain model mesh leaves a region whole where the axis does
        # not divide it, as GSPMD does; the strict meshes refuse that
        self.attn_sliced = self.tp and not (model.heads % n
                                            or model.n_kv % n)
        self.mlp_sliced = self.tp and not (4 * model.dim) % n
        self.vocab_sliced = self.tp and not strict
        self.ckpt_form = ("tp_pp" if self.tp and self.n_pipe > 1 else
                          "pp" if self.n_pipe > 1 else
                          "tp" if strict else "standard")
        per = model.depth // self.n_pipe
        stage = mesh.index(PIPE_AXIS)
        self.my_blocks = range(stage * per, (stage + 1) * per)
        line = mesh.line(PIPE_AXIS)
        self.prev = line[stage - 1] if stage > 0 else None
        self.next = line[stage + 1] if stage < self.n_pipe - 1 else None
        self.token_axes = tuple(a for a in (DATA_AXIS, SEQ_AXIS)
                                if mesh.shape.get(a, 1) > 1)
        self.attn_impl = attn_impl
        if self.n_seq > 1:
            if attn_impl not in _BODIES:
                raise ValueError(f"unknown SP impl {attn_impl!r}; 'ring', "
                                 "'ring_flash' or 'ulysses'")
            body = _BODIES[attn_impl]
            self.attn = lambda q, k, v: body(q, k, v, mesh, causal=True)
        else:
            self.attn = get_attn_fn(attn_impl)
        self.moe_aux_weight = moe_aux_weight
        self.aux_w = moe_aux_weight
        self.moe_kw: dict = {}
        if model.moe_experts:
            # the reference's routing of each mesh: EP over 'seq' (FSDP x
            # SP, SP x PP), the data line's tokens as one batch (its GSPMD
            # meshes), else the rank's own tokens (TP x SP, the pipelines)
            if self.n_seq > 1 and not self.tp:
                self.moe_kw = dict(moe_group=mesh, moe_axis=SEQ_AXIS)
            elif self.n_seq == 1 and self.n_pipe == 1:
                self.moe_kw = dict(
                    moe_group=mesh.sub(DATA_AXIS) if self.n_data > 1
                    else None, moe_dispatch_dtype=moe_dispatch_dtype)
            if self.mlp_sliced:
                self.aux_w = moe_aux_weight / self.n_model
        self.specs: list[dict] = []

    # -- layouts --------------------------------------------------------

    def layout(self, params: dict) -> dict:
        """The standard tree -> the rank's layout (head-structured blocks
        on a model axis)."""
        return to_tp_layout(params, self.model) if self.tp else dict(params)

    def standard(self, tree: dict) -> dict:
        return from_tp_layout(tree, self.model) if self.tp else tree

    def to_ckpt(self, tree: dict) -> dict:
        """A whole layout tree -> the reference's checkpoint tree of the
        mesh."""
        if self.ckpt_form in ("standard", "pp"):
            tree = self.standard(tree)
        return stack_blocks(tree) if self.n_pipe > 1 else tree

    def from_ckpt(self, tree: dict) -> dict:
        if self.n_pipe > 1:
            tree = unstack_blocks(tree, self.model.depth)
        return self.layout(tree) if self.ckpt_form in ("standard", "pp") \
            else tree

    def _model_spec(self, path: tuple, leaf: torch.Tensor) -> dict:
        if not self.tp:
            return {}
        if path[0] == "blocks":
            return tp_block_spec(path[2:], self.attn_sliced, self.mlp_sliced)
        dim = {"tok_emb": 0, "head": 1}.get(path[0])
        if dim is None or not self.vocab_sliced or \
                leaf.shape[dim] % self.n_model:
            return {}
        return {MODEL_AXIS: dim}

    # -- state ----------------------------------------------------------

    def place(self, params: dict, optimizer) -> dict:
        """This rank's train state from the whole standard params: its
        blocks of its stage's leaves and of the rest, requiring grad, and
        the optimizer's state built from them (the reference's
        make_lm_tp_state / make_fsdp_state / make_tp_sp_state /
        make_pp_lm_state / make_tp_pp_lm_state)."""
        full = self.layout(params)
        paths = list(_paths(full))
        self.template = tree_map(lambda t: None, full)
        self.shapes = [tuple(t.shape) for _, t in paths]
        specs = [self._model_spec(p, t) for p, t in paths]
        if self.fsdp:
            specs = fsdp_specs(full, self.n_data, DATA_AXIS, specs)
        self.specs = specs
        # the rest leaves split on the vocab over 'model': name -> dim
        self.vocab_split = {p[0]: s[MODEL_AXIS] for (p, _), s in
                            zip(paths, specs) if p[0] in ("tok_emb", "head")
                            and MODEL_AXIS in s}
        stages = [p[1] if p[0] == "blocks" else None for p, _ in paths]
        self.mine = [s is None or s in self.my_blocks for s in stages]
        self.every = [s is None for s in stages]
        self.local_specs = [s for s, m in zip(specs, self.mine) if m]
        self.local_every = [e for e, m in zip(self.every, self.mine) if m]
        local = {k: v for k, v in full.items() if k != "blocks"}
        local["blocks"] = [full["blocks"][i] for i in self.my_blocks]
        return make_state(unflatten(local, [
            local_block(t.detach(), s, self.mesh).clone()
            for t, s in zip(tree_leaves(local), self.local_specs,
                            strict=True)]), optimizer)

    def working(self, params: dict) -> dict:
        """The params the forward reads: this rank's blocks, gathered
        over the data line under FSDP (fresh leaves that require grad)."""
        if not self.fsdp:
            return params
        full = gather_leaves(tree_leaves(params), self.local_specs,
                             self.mesh, DATA_AXIS)
        return unflatten(params, [t.detach().requires_grad_(True)
                                  for t in full])

    def full_leaves(self, leaves: list[torch.Tensor]) -> list[torch.Tensor]:
        """Whole layout leaves of the model (of the params, then of each
        state buffer built from them, in that order) from this rank's,
        on every rank: one all-reduce."""
        k = len(leaves) // len(self.local_specs)
        it = iter(leaves)
        blocks = [next(it) if m else None for _ in range(k) for m in self.mine]
        return assemble(blocks, self.shapes * k, self.specs * k, self.mesh,
                        self.every * k)

    def standard_leaves(self, leaves: list[torch.Tensor]
                        ) -> list[torch.Tensor]:
        """`full_leaves` of one list (params or gradients), in the
        standard tree's order and shapes."""
        return tree_leaves(self.standard(unflatten(
            self.template, self.full_leaves(leaves))))

    def standard_params(self, state: dict) -> dict:
        """The whole standard params tree, on every rank (eval, decode)."""
        return self.standard(unflatten(
            self.template, self.full_leaves(tree_leaves(state["params"]))))

    def checkpoint_arrays(self, state: dict, optimizer) -> dict:
        """The reference's checkpoint arrays of the mesh (its tree of the
        params and of AdamW's moments), made on every rank."""
        from ..convert import checkpoint_arrays

        opt = state["opt_state"]
        roles = [r for r in ("mu", "nu", "trace") if opt.get(r)]
        whole = self.full_leaves(tree_leaves(state["params"])
                                 + [t for r in roles for t in opt[r]])
        n = len(self.shapes)
        trees = [self.to_ckpt(unflatten(self.template, whole[i * n:
                                                             (i + 1) * n]))
                 for i in range(len(roles) + 1)]
        return checkpoint_arrays(
            {"params": trees[0], "step": state["step"],
             "opt_state": {**opt, **{r: tree_leaves(t)
                                     for r, t in zip(roles, trees[1:])}}},
            optimizer)

    @torch.no_grad()
    def load_arrays(self, state: dict, arrays: dict, optimizer) -> None:
        """Install the reference's checkpoint arrays of the mesh into this
        rank's blocks, in place."""
        from ..convert import load_checkpoint_arrays

        opt = state["opt_state"]
        roles = [r for r in ("mu", "nu", "trace") if opt.get(r)]

        def fresh():
            return self.to_ckpt(unflatten(self.template, [
                torch.zeros(s) for s in self.shapes]))

        trees = [fresh() for _ in range(len(roles) + 1)]
        whole = {"params": trees[0], "step": 0,
                 "opt_state": {**opt, **{r: tree_leaves(t)
                                         for r, t in zip(roles, trees[1:])}}}
        load_checkpoint_arrays(whole, arrays, optimizer)

        def install(dst: list[torch.Tensor], tree: dict) -> None:
            src = [t for t, m in zip(tree_leaves(self.from_ckpt(tree)),
                                     self.mine) if m]
            for d, s, spec in zip(dst, src, self.local_specs, strict=True):
                d.copy_(local_block(s.to(d.device, d.dtype), spec, self.mesh))

        install(tree_leaves(state["params"]), trees[0])
        for r, t in zip(roles, trees[1:]):
            install(opt[r], t)
        opt["count"] = whole["opt_state"]["count"]
        state["step"] = whole["step"]

    # -- the forward ----------------------------------------------------

    def _positions(self, s_local: int, device) -> torch.Tensor:
        return (self.mesh.index(SEQ_AXIS) * s_local
                + torch.arange(s_local, device=device))

    def _whole(self, p: dict, name: str) -> torch.Tensor:
        """A rest leaf, gathered whole over the model line when it is
        split on the vocab there."""
        if name in self.vocab_split:
            return GatherFromModel.apply(p[name], self.mesh,
                                         self.vocab_split[name])
        return p[name]

    def embed(self, p: dict, tokens: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
        x = self._whole(p, "tok_emb")[tokens.long()]
        if self.model.pos == "learned":
            x = x + p["pos_emb"][pos][None, :, :]
        return x if self.cd is None else x.to(self.cd)

    def block(self, blk: dict, x: torch.Tensor, pos: torch.Tensor):
        if self.tp:
            return tp_block_apply(
                self.model, blk, x, attn=self.attn, pos=pos, mesh=self.mesh,
                compute_dtype=self.cd, attn_sliced=self.attn_sliced,
                mlp_sliced=self.mlp_sliced,
                moe_group=self.moe_kw.get("moe_group"),
                moe_dispatch_dtype=self.moe_kw.get("moe_dispatch_dtype"))
        return self.model.apply_block(blk, x, pos=pos, attn=self.attn,
                                      compute_dtype=self.cd, **self.moe_kw)

    def run_blocks(self, blocks: list, x: torch.Tensor, pos: torch.Tensor):
        """x through `blocks`: (x, their summed balance loss)."""
        aux = torch.zeros((), device=x.device)
        for blk in blocks:
            if self.remat:
                x, a = checkpoint(self.block, blk, x, pos,
                                  use_reentrant=False)
            else:
                x, a = self.block(blk, x, pos)
            aux = aux + a
        return x, aux

    def drain(self, p: dict, x: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
        """The mean next-token NLL of the final features x."""
        from ..train.lm import head_nll

        return head_nll(x, p["ln_f"], self._whole(p, "head"), targets,
                        compute_dtype=self.cd, ce_chunk=self.ce_chunk)

    def loss_fn(self, p: dict, tokens: torch.Tensor, targets: torch.Tensor):
        """(the loss the rank differentiates, {"aux": the share of the
        balance loss that the metric adds back}) of its tokens."""
        pos = self._positions(tokens.shape[1], tokens.device)
        x, aux = self.run_blocks(p["blocks"], self.embed(p, tokens, pos), pos)
        return (self.drain(p, x, targets) + self.aux_w * aux,
                {"aux": (self.moe_aux_weight - self.aux_w) * aux.detach()})

    # -- the step -------------------------------------------------------

    def _check(self, tokens: torch.Tensor) -> None:
        s, n = tokens.shape[1], self.n_seq
        if s * n > self.model.max_seq:
            raise ValueError(
                f"global sequence {s * n} exceeds max_seq "
                f"{self.model.max_seq}" if n > 1 else
                f"sequence length {s} exceeds max_seq {self.model.max_seq}")
        if self.attn_impl == "ring_flash" and s % 128:
            raise ValueError(
                f"impl='ring_flash' needs the per-shard sequence to be a "
                f"multiple of 128 (flash block granularity): global "
                f"S={s * n} over {SEQ_AXIS}={n} devices gives s_local={s}")

    def grads(self, state: dict, tokens: torch.Tensor,
              targets: torch.Tensor):
        """(this rank's blocks of the step's gradients, meaned over the
        ranks that hold other tokens; the 1-d metrics (loss,)) of its
        tokens (`pp_lm.pp_lm_shard_batch` order on a pipe axis)."""
        self._check(tokens)
        if self.n_pipe > 1:
            g, metrics = self._pipe_grads(state["params"], tokens, targets)
        else:
            g, metrics = dp.local_grads(self.loss_fn,
                                        self.working(state["params"]),
                                        tokens, targets, self.grad_accum)
            metrics = metrics[:1] + metrics[1:]
        return self._reduce(g, metrics)

    def _pipe_grads(self, params: dict, tokens: torch.Tensor,
                    targets: torch.Tensor):
        """The GPipe schedule of the step (`pp.gpipe_grads`): this stage's
        gradients summed over the M microbatches, and its share of the
        loss (the NLL on the last stage, each stage's balance loss)."""
        M = self.n_pipe
        mb, s = len(tokens) // M, tokens.shape[1]
        pos = self._positions(s, tokens.device)
        metric = torch.zeros(1, device=self.mesh.device)

        def stage(inp, m):
            x, aux = self.run_blocks(params["blocks"], inp, pos)
            if not self.model.moe_experts:
                return x, None
            metric.add_(self.moe_aux_weight * aux.detach() / M)
            return x, self.aux_w * aux / M

        def drain(out, m):
            nll = self.drain(params, out, targets[m * mb:(m + 1) * mb]) / M
            metric.add_(nll.detach())
            return nll

        g = gpipe_grads(
            M, tree_leaves(params), prev=self.prev, next=self.next,
            device=self.mesh.device, in_shape=(mb, s, self.model.dim),
            in_dtype=self.cd or torch.float32,
            first_input=lambda m: self.embed(
                params, tokens[m * mb:(m + 1) * mb], pos),
            stage=stage, drain=drain)
        return g, metric

    def _reduce(self, g: list[torch.Tensor], metrics: torch.Tensor):
        mesh = self.mesh
        if self.n_pipe > 1:
            # the rest's gradients and the loss: each stage's share,
            # summed over the pipe line (one all-reduce)
            rest = [i for i, e in enumerate(self.local_every) if e]
            buf = torch.cat([g[i].reshape(-1).float() for i in rest]
                            + [metrics.float()])
            dp.all_reduce_sum(buf, mesh, PIPE_AXIS)
            views = dp.views(buf, [g[i] for i in rest] + [metrics])
            for i, v in zip(rest, views):
                g[i] = v.to(g[i].dtype)
            metrics = views[-1]
        axes = self.token_axes
        if self.fsdp:
            g, metrics = mean_over_data(g, metrics, self.local_specs, mesh,
                                        True)
            axes = tuple(a for a in axes if a != DATA_AXIS)
        if axes:
            g, metrics = dp.mean_over(g, metrics, mesh, axes)
        return g, metrics

    def make_train_step(self, optimizer, *, grad_clip: float = 0.0):
        """step(state, tokens, targets) -> (state, {"loss": loss}) on this
        rank's tokens, with the global-norm clip in the step; `.grads`
        and `.loss_fn` as `train.lm.make_lm_train_step`'s."""
        from ..train.optimizer import clip_grads_by_global_sq

        def step(state, tokens, targets):
            g, metrics = self.grads(state, tokens, targets)
            if grad_clip > 0:
                g = clip_grads_by_global_sq(
                    g, global_sq(g, self.local_specs, self.mesh,
                                 self.local_every), grad_clip)
            optimizer.update(tree_leaves(state["params"]), g,
                             state["opt_state"], clip=False)
            state["step"] += 1
            return state, {"loss": metrics[0]}

        step.grads = self.grads
        step.loss_fn = self.loss_fn
        return step
