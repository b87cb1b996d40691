"""Sequence parallelism over a 'seq' mesh axis (counterpart of the
reference's `parallel/sp.py`): long-context LM training with each rank
holding S/P tokens of every sequence of its rows.

Shard s of P owns positions [s * S/P, (s + 1) * S/P). Three attentions
see the whole sequence from the shards:

- `ring_attention`: every rank keeps its query shard; the key/value
  shards go round the ring of the axis (`_RingShift`: rank i hands its
  block to rank i + 1, so after h hops it holds the block of shard
  i - h), and each block is folded into the exact online softmax of
  `ops/attention.py`. P - 1 fold-and-rotate hops, then a fold of the last
  block with no return hop. Under GQA the ring carries the small Hkv
  blocks and repeats them over the query heads at the fold. Autograd
  differentiates the folds and the shifts (a shift's backward is the
  reverse shift).
- `ring_flash_attention`: the same ring with the flash kernels as the
  fold, a `torch.autograd.Function`. Forward: per hop a full block
  (non-causal K7), the diagonal block (causal K7) or, causal and after
  the rank's own rows, nothing; K7 returns float32 o and lse
  (`out_f32`), and the hops merge in float32 by the two-softmax
  logaddexp merge; o is cast once at the end and the global lse kept.
  Backward: a second ring pass, K8 and K9 in float32 (`grads_f32`)
  against the final o and the global lse, dq summed in place, each
  block's dk and dv accumulators rotating with it; the last hop rotates
  only the accumulators home. The reference's hop order and merge, so
  float32 results match the JAX package's.
- `ulysses_attention`: an all-to-all turns sequence shards into head
  shards (every rank holds the whole sequence of H/P heads), the plain
  attention (`ops.attention.attention`, as the reference's runs) runs
  there, and the inverse all-to-all turns head shards back into sequence
  shards (`_AllToAll`, whose backward is the inverse all-to-all).

`make_sp_lm_train_step` is the LM's step on a (data, seq) mesh: each
rank's (B/n_data, S/n_seq) tokens at position offset seq_index * S/n_seq,
gradients and loss meaned over data x seq in one flat all-reduce
(`parallel/dp.py`), with --grad-accum through `dp.local_grads`. MoE
blocks run expert-parallel over the same 'seq' axis (EP x SP: each rank
routes its own tokens and computes E/P experts, `parallel/moe.py`
`moe_mlp` with `axis`). Under --fsdp (FSDP x SP) the params are sharded
and the step is `parallel/lm_shard.py`'s with the same attention.

The shifts are `dist.batch_isend_irecv` within the seq line's group and
the all-to-alls `dist.all_to_all_single` of the P equal chunks stacked
(gloo has no list `all_to_all`). On the gloo backend with CUDA tensors
(ranks sharing one card) each collective stages its tensors through host
copies, since gloo moves host memory; NCCL sends device tensors as they
are. The folds run on the device either way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..obs.trace import annotate
from ..ops.attention import (
    NEG_INF,
    attention,
    finalize_online,
    init_online,
    online_softmax_block,
    repeat_kv,
)
from . import dp
from .mesh import DATA_AXIS, SEQ_AXIS, Mesh

# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def _via_host(t: torch.Tensor, group) -> bool:
    """Gloo moves host memory: CUDA tensors go through host copies."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def ring_shift(t: torch.Tensor, mesh: Mesh, step: int = 1) -> torch.Tensor:
    """Hand `t` to the rank `step` places on along this rank's seq ring
    and return what the rank `step` places back handed: one
    `batch_isend_irecv` in the seq group."""
    line = mesh.line(SEQ_AXIS)
    p, me = len(line), mesh.index(SEQ_AXIS)
    group = mesh.axis_group(SEQ_AXIS)
    send = t.detach().contiguous()
    host = _via_host(send, group)
    if host:
        send = send.cpu()
    recv = torch.empty_like(send, memory_format=torch.contiguous_format)
    ops = [dist.P2POp(dist.isend, send, line[(me + step) % p], group=group),
           dist.P2POp(dist.irecv, recv, line[(me - step) % p], group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device) if host else recv


class _RingShift(torch.autograd.Function):
    """`ring_shift` to the next rank; its backward is the shift back."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return ring_shift(t, mesh, 1)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.mesh, -1), None


def all_to_all(t: torch.Tensor, mesh: Mesh, split_dim: int,
               concat_dim: int, axis: str = SEQ_AXIS) -> torch.Tensor:
    """The tiled all-to-all of an axis (the seq axis, or the expert
    axis of `parallel/ep.py`): `t` split into P chunks along `split_dim`,
    chunk j sent to rank j of the axis' line, and the chunks received
    from ranks 0..P-1 concatenated along `concat_dim`."""
    group = mesh.axis_group(axis)
    p = mesh.shape[axis]
    # (P, chunk), dense whatever the strides of t's chunks
    send = torch.stack(t.detach().chunk(p, dim=split_dim)).contiguous()
    host = _via_host(send, group)
    if host:
        send = send.cpu()
    recv = torch.empty_like(send, memory_format=torch.contiguous_format)
    dist.all_to_all_single(recv, send, group=group)
    res = torch.cat(recv.unbind(0), dim=concat_dim)
    return res.to(t.device) if host else res


class _AllToAll(torch.autograd.Function):
    """`all_to_all`; its backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, t, mesh, split_dim, concat_dim, axis=SEQ_AXIS):
        ctx.args = (mesh, concat_dim, split_dim, axis)
        return all_to_all(t, mesh, split_dim, concat_dim, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, *ctx.args), None, None, None, None


# ---------------------------------------------------------------------------
# Ring attention on the online softmax
# ---------------------------------------------------------------------------


def _pair_mask(my_shard: int, src_shard: int, s_local: int, causal: bool,
               device) -> torch.Tensor:
    """(s_local, s_local) mask of my query rows against the block that
    started on `src_shard`. True = attend."""
    if not causal:
        return torch.ones((s_local, s_local), dtype=torch.bool,
                          device=device)
    qpos = my_shard * s_local + torch.arange(s_local, device=device)[:, None]
    kpos = src_shard * s_local + torch.arange(s_local, device=device)[None, :]
    return kpos <= qpos


def ring_attention(q, k, v, mesh: Mesh, *, causal: bool = False):
    """Exact ring attention of this rank's sequence shard: q (B, s_local,
    H, D), k/v (B, s_local, Hkv, D) -> (B, s_local, H, D) in q's type."""
    p, me = mesh.shape[SEQ_AXIS], mesh.index(SEQ_AXIS)
    s_local = q.shape[1]

    def fold(carry, kh, vh, hop):
        mask = _pair_mask(me, (me - hop) % p, s_local, causal, q.device)
        return online_softmax_block(carry, q, repeat_kv(kh, q.shape[2]),
                                    repeat_kv(vh, q.shape[2]), mask)

    carry, kh, vh = init_online(q), k, v
    for hop in range(p - 1):
        with annotate("sp.ring.fold"):
            carry = fold(carry, kh, vh, hop)
        with annotate("sp.ring.shift"):
            kh, vh = _RingShift.apply(kh, mesh), _RingShift.apply(vh, mesh)
    carry = fold(carry, kh, vh, p - 1)
    return finalize_online(carry, q.dtype)


# ---------------------------------------------------------------------------
# Ring-flash attention: the flash kernels as the fold
# ---------------------------------------------------------------------------


def _ring_case(me: int, src: int, causal: bool) -> str | None:
    """The kernel call of the block from shard `src` against my rows:
    "full" (attend all), "diag" (my own block, local causal) or None
    (after my rows: skipped)."""
    if not causal or src < me:
        return "full"
    return "diag" if src == me else None


def _merge_partials(o, lse, o_blk, lse_blk):
    """Fold a block's normalized partial (o_blk, lse_blk) into the running
    (o, lse): o (B, S, H, D) float32, lse (B * H, S), by the two-softmax
    merge with weights exp(lse_i - logaddexp(lse, lse_blk))."""
    b, s, h, _ = o.shape
    lse_new = torch.logaddexp(lse, lse_blk)

    def bsh1(x):                     # (B * H, S) -> (B, S, H, 1)
        return x.reshape(b, h, s).transpose(1, 2)[..., None]

    return (o * bsh1(torch.exp(lse - lse_new))
            + o_blk * bsh1(torch.exp(lse_blk - lse_new)), lse_new)


class _RingFlash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal):
        from ..ops.flash_attention import flash_forward

        p, me = mesh.shape[SEQ_AXIS], mesh.index(SEQ_AXIS)
        b, s, h, d = q.shape
        o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b * h, s), NEG_INF, dtype=torch.float32,
                         device=q.device)
        kh, vh = k, v
        for hop in range(p):
            case = _ring_case(me, (me - hop) % p, causal)
            if case is not None:
                with annotate("sp.ring_flash.fold"):
                    o_blk, lse_blk = flash_forward(q, kh, vh, case == "diag",
                                                   out_f32=True)
                    o, lse = _merge_partials(o, lse, o_blk, lse_blk)
            if hop < p - 1:
                with annotate("sp.ring_flash.shift"):
                    kh, vh = ring_shift(kh, mesh), ring_shift(vh, mesh)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mesh, ctx.causal = mesh, causal
        return o

    @staticmethod
    def backward(ctx, g):
        from ..ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, row_dvec

        q, k, v, o, lse = ctx.saved_tensors
        mesh, causal = ctx.mesh, ctx.causal
        p, me = mesh.shape[SEQ_AXIS], mesh.index(SEQ_AXIS)
        dvec = row_dvec(o, g)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kh, vh = k, v
        dkh = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvh = torch.zeros_like(dkh)
        for hop in range(p):
            case = _ring_case(me, (me - hop) % p, causal)
            if case is not None:
                diag = case == "diag"
                dq += flash_bwd_dq(q, kh, vh, g, lse, dvec, diag,
                                   grads_f32=True)
                dk_c, dv_c = flash_bwd_dkv(q, kh, vh, g, lse, dvec, diag,
                                           grads_f32=True)
                dkh += dk_c
                dvh += dv_c
            # The blocks rotate with their accumulators; after the last
            # hop only the accumulators go on, home.
            if hop < p - 1:
                kh, vh = ring_shift(kh, mesh), ring_shift(vh, mesh)
            dkh, dvh = ring_shift(dkh, mesh), ring_shift(dvh, mesh)
        return (dq.to(q.dtype), dkh.to(k.dtype), dvh.to(v.dtype), None,
                None)


def ring_flash_attention(q, k, v, mesh: Mesh, *, causal: bool = False):
    """Ring attention with the flash kernels as the fold (K7 forward, K8
    and K9 backward): q (B, s_local, H, D), k/v (B, s_local, Hkv, D),
    s_local a multiple of 128 -> (B, s_local, H, D) in q's type."""
    return _RingFlash.apply(q, k, v, mesh, causal)


# ---------------------------------------------------------------------------
# Ulysses: all-to-all to head shards
# ---------------------------------------------------------------------------


def ulysses_attention(q, k, v, mesh: Mesh, *, causal: bool = False):
    """All-to-all sequence parallelism: q (B, s_local, H, D), k/v
    (B, s_local, Hkv, D) with H divisible by the axis size; kv repeated to
    H first (Ulysses shards the heads)."""
    p = mesh.shape[SEQ_AXIS]
    h = q.shape[2]
    if h % p:
        raise ValueError(f"heads {h} not divisible by seq-axis size {p}")
    k, v = repeat_kv(k, h), repeat_kv(v, h)
    with annotate("sp.ulysses.all_to_all_heads"):
        qh, kh, vh = (_AllToAll.apply(t, mesh, 2, 1) for t in (q, k, v))
    with annotate("sp.ulysses.attention"):
        out = attention(qh, kh, vh, causal=causal)
    with annotate("sp.ulysses.all_to_all_seq"):
        return _AllToAll.apply(out, mesh, 1, 2)


_BODIES = {"ring": ring_attention, "ring_flash": ring_flash_attention,
           "ulysses": ulysses_attention}


# ---------------------------------------------------------------------------
# Sequence-parallel LM training
# ---------------------------------------------------------------------------


def sp_shard_batch(batch, mesh: Mesh):
    """This rank's block of a (B, S) batch (or a tuple of them): its
    data-axis rows (`dp.dp_shard_batch`) and its seq shard's columns, the
    share `P(data, seq)` gives it."""
    if isinstance(batch, tuple):
        return tuple(sp_shard_batch(t, mesh) for t in batch)
    rows = dp.dp_shard_batch(batch, mesh, DATA_AXIS)
    n, i = mesh.shape.get(SEQ_AXIS, 1), mesh.index(SEQ_AXIS)
    s_local = rows.shape[1] // n
    return rows[:, i * s_local:(i + 1) * s_local]


def make_sp_lm_train_step(model, optimizer, mesh: Mesh, *,
                          impl: str = "ring", data_axis: str | None = None,
                          remat: bool = False, compute_dtype=None,
                          ce_chunk: int = 0, grad_accum: int = 1,
                          moe_aux_weight: float = 0.01):
    """The causal-LM train step with the sequence sharded over the seq
    axis and, with `data_axis`, the batch over the data axis:
    step(state, tokens, targets) -> (state, {"loss": loss}) on this rank's
    block (`sp_shard_batch`), the params replicated. Attention is `impl`
    ("ring", "ring_flash" or "ulysses"); positions start at seq_index * s_local. Gradients and
    the loss are meaned over every populated axis in one all-reduce
    (`dp.make_dp_train_step`); `grad_accum` splits the rank's rows into
    micro-batches, the ring collectives running once per micro-batch on
    every rank. `step.loss_fn` and `step.grads` are as
    `train.lm.make_lm_train_step`'s."""
    from ..train.lm import lm_loss

    if impl not in _BODIES:
        raise ValueError(f"unknown SP impl {impl!r}; 'ring', 'ring_flash' "
                         "or 'ulysses'")
    body = _BODIES[impl]
    n_seq = mesh.shape[SEQ_AXIS]
    me = mesh.index(SEQ_AXIS)

    def attn(q, k, v):
        return body(q, k, v, mesh, causal=True)

    def check(tokens):
        s_local = tokens.shape[1]
        if s_local * n_seq > model.max_seq:
            raise ValueError(f"global sequence {s_local * n_seq} exceeds "
                             f"max_seq {model.max_seq}")
        if impl == "ring_flash" and s_local % 128:
            raise ValueError(
                f"impl='ring_flash' needs the per-shard sequence to be a "
                f"multiple of 128 (flash block granularity): global "
                f"S={s_local * n_seq} over {SEQ_AXIS}={n_seq} devices gives "
                f"s_local={s_local}")
        if ce_chunk and s_local % ce_chunk:
            raise ValueError(
                f"ce_chunk {ce_chunk} must divide the per-shard sequence "
                f"{s_local} (global S={s_local * n_seq} over {SEQ_AXIS}="
                f"{n_seq})")
        if grad_accum > 1 and tokens.shape[0] % grad_accum:
            raise ValueError(f"per-shard batch {tokens.shape[0]} not "
                             f"divisible by grad_accum {grad_accum}")

    def loss_fn(params, tokens, targets):
        return lm_loss(model, params, tokens, targets, attn_fn=attn,
                       compute_dtype=compute_dtype, remat=remat,
                       moe_aux_weight=moe_aux_weight, ce_chunk=ce_chunk,
                       moe_group=mesh, moe_axis=SEQ_AXIS,
                       pos_offset=me * tokens.shape[1]), {}

    axes = tuple(a for a in (data_axis, SEQ_AXIS) if a)
    dp_step = dp.make_dp_train_step(loss_fn, optimizer, mesh, axis=axes,
                                    grad_accum=grad_accum)

    def grads(state, tokens, targets):
        check(tokens)
        return dp_step.grads(state, tokens, targets)

    def step(state, tokens, targets):
        check(tokens)
        state, metrics = dp_step(state, tokens, targets)
        return state, {"loss": metrics[0]}

    step.loss_fn = loss_fn
    step.grads = grads
    return step
