"""Language-model training: the transformer's train step and loss
(counterpart of the reference's `train/lm.py`).

One step is the forward, the causal-LM cross-entropy, the backward
(`torch.autograd.grad`) and the AdamW update in place, as one rank of a
data mesh (on one device, the world-1 mesh of no collective): each rank
takes its B/w rows of the batch, and its gradients and loss are averaged
in one all-reduce before the update (`parallel/dp.make_dp_train_step`),
the port's twin of the reference's GSPMD step with the state replicated
and the batch sharded (`train/lm_trainer.py`). With equal shards the
mean of the ranks' token means is the global token mean. The levers are the reference's:

- `attn_impl`: "flash" (the fused attention on the hand-written CUDA
  kernels K7-K9, `ops/flash_attention.py`), "oracle" (the quadratic
  PyTorch attention, `ops/attention.attention`), or "auto";
- `compute_dtype`: bf16 weight products and residual stream, float32
  master params;
- `remat`: `torch.utils.checkpoint` per block;
- `ce_chunk`: the chunked cross-entropy fused with the head product;
- `grad_accum`: the rank's rows in interleaved micro-batches, one
  `autograd.grad` each, summed and divided before the one all-reduce;
- `elastic_width`: the width-invariant reduction of `parallel/elastic.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..data import prng
from ..models.layers import tree_leaves
from ..models.transformer import TransformerLM
from ..ops.flash_attention import MAX_HEAD_DIM
from ..ops.gemv import tree_map
from ..parallel.dp import make_dp_train_step
from ..parallel.mesh import device_mesh


def pick_attn_impl(impl: str, seq_len: int,
                   device: torch.device | str = "cuda",
                   head_dim: int | None = None) -> str:
    """Resolve "auto": the flash kernels on a CUDA device whenever their
    block constraint (S % 128 == 0) holds and the model's `head_dim` is
    one they take (up to `MAX_HEAD_DIM`, zero-padded to their next
    instance; None = not known here), the oracle on the CPU (where the
    kernels' plain versions are full-matrix math, no faster than the
    oracle), for an unaligned S or for a head dim beyond `MAX_HEAD_DIM`.
    An explicit "flash" is returned as asked: the kernels then refuse a
    head dim beyond `MAX_HEAD_DIM`.

    The reference routes float32 below S = 3072 to the oracle
    (`_F32_FLASH_MIN_SEQ`); that crossover was measured on a TPU v5e and
    is not carried over. `lm-bench`'s float32 oracle and flash rows on
    the card are the data for this card's own."""
    if impl != "auto":
        return impl
    if (torch.device(device).type != "cuda" or seq_len % 128
            or (head_dim is not None and head_dim > MAX_HEAD_DIM)):
        return "oracle"
    return "flash"


def get_attn_fn(impl: str):
    """Concrete causal attention callable (q, k, v) -> o for `impl`."""
    if impl == "flash":
        from ..ops.flash_attention import flash_attention

        return lambda q, k, v: flash_attention(q, k, v, True)
    if impl == "oracle":
        from ..ops.attention import attention

        return lambda q, k, v: attention(q, k, v, causal=True)
    raise ValueError(
        f"unknown attention impl {impl!r}; use 'flash' or 'oracle' "
        "(resolve 'auto' with pick_attn_impl first)")


def lm_loss(model: TransformerLM, params: dict, tokens: torch.Tensor,
            targets: torch.Tensor, *, attn_fn=None,
            compute_dtype: torch.dtype | None = None, remat: bool = False,
            moe_aux_weight: float = 0.01, ce_chunk: int = 0,
            moe_dispatch_chunk: int = 0,
            moe_dispatch_dtype: torch.dtype | None = None,
            moe_group=None, moe_axis: str | None = None,
            pos_offset: int = 0) -> torch.Tensor:
    """Mean next-token NLL plus moe_aux_weight x the MoE balance loss (0
    for a dense model); the softmax in float32. ce_chunk > 0 fuses the
    head product into the chunked cross-entropy
    (`ops.losses.chunked_ce_mean`), which never forms the (B, S, V)
    float32 logits; it must divide S. `moe_dispatch_chunk`,
    `moe_dispatch_dtype`, `moe_group`, `moe_axis` and `pos_offset` (the
    first position of a sequence shard) go to `model.apply`."""
    moe = dict(moe_dispatch_chunk=moe_dispatch_chunk,
               moe_dispatch_dtype=moe_dispatch_dtype, moe_group=moe_group,
               moe_axis=moe_axis, pos_offset=pos_offset)
    if ce_chunk:
        from ..ops.losses import chunked_ce_mean

        feats, aux = model.apply(params, tokens, attn_fn=attn_fn, remat=remat,
                                 compute_dtype=compute_dtype, return_aux=True,
                                 return_features=True, **moe)
        nll = chunked_ce_mean(feats, params["head"], targets, ce_chunk,
                              compute_dtype)
        return nll + moe_aux_weight * aux
    logits, aux = model.apply(params, tokens, attn_fn=attn_fn, remat=remat,
                              compute_dtype=compute_dtype, return_aux=True,
                              **moe)
    return _nll(logits, targets) + moe_aux_weight * aux


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return (-torch.gather(logp, -1, targets.long()[..., None])).mean()


def head_nll(x: torch.Tensor, ln_f: dict, head: torch.Tensor,
             targets: torch.Tensor, *,
             compute_dtype: torch.dtype | None = None,
             ce_chunk: int = 0) -> torch.Tensor:
    """The mean next-token NLL of the last block's output x (B, S, D):
    the final layernorm, the head product in the compute dtype and the
    float32 softmax, as `model.apply` and `lm_loss` take them (the
    sharded meshes' loss, `parallel/lm_shard.py`)."""
    from ..models.transformer import _layernorm

    feats = _layernorm(x, ln_f["g"], ln_f["b"])
    if ce_chunk:
        from ..ops.losses import chunked_ce_mean

        return chunked_ce_mean(feats, head, targets, ce_chunk, compute_dtype)
    w = head if compute_dtype is None else head.to(compute_dtype)
    return _nll((feats @ w).to(torch.float32), targets)


def make_lm_state(model: TransformerLM, optimizer, seed: int = 0, *,
                  params: dict | None = None,
                  device: torch.device | str = "cpu") -> dict:
    """Fresh {"params", "opt_state", "step"} for the LM train step: a
    seeded `model.init`, drawn on `device` as the reference draws it from
    `jax.random.key(seed)`, or `params` (e.g. `convert.params_from_jax`
    of the reference's), on `device`. Each leaf is a fresh float32 tensor
    that requires grad."""
    if params is None:
        params = model.init(prng.key(seed), device)
    params = tree_map(lambda t: t.detach().to(device, torch.float32).clone()
                      .requires_grad_(True), params)
    return {"params": params,
            "opt_state": optimizer.init(tree_leaves(params)), "step": 0}


def make_lm_train_step(model: TransformerLM, optimizer, *,
                       attn_impl: str = "auto", seq_len: int | None = None,
                       device: torch.device | str = "cuda",
                       compute_dtype: torch.dtype | None = None,
                       remat: bool = False, moe_aux_weight: float = 0.01,
                       ce_chunk: int = 0, mesh=None, grad_accum: int = 1,
                       elastic_width: int = 0, moe_dispatch_chunk: int = 0,
                       moe_dispatch_dtype: torch.dtype | None = None,
                       accum_dtype: torch.dtype | None = None):
    """step(state, tokens, targets) -> (state, {"loss": loss}): forward,
    loss, gradients, and the optimizer update in place on the state's
    params (the state dict itself is returned, updated), as one rank of
    `mesh` (None: the world-1 mesh of `device`, no collective): tokens
    and targets are this rank's rows (`dp_shard_batch`) and the loss is
    the mean over the ranks. The loss stays on the device: reading it is
    the caller's host sync. `step.loss_fn(params, tokens, targets) ->
    (loss, {})` is the step's loss and `step.grads(state, tokens,
    targets) -> (gradients, metrics)` its gradient half.

    grad_accum > 1 accumulates the rank's rows over that many interleaved
    micro-batches (`dp.local_grads`, the reference's one accumulation
    helper for both model families), the sum in `accum_dtype` when one is
    given (None: the params' float32); elastic_width > 0 takes the
    width-invariant reduction (`make_elastic_lm_train_step`).

    An MoE model routes each micro-batch of the mesh's ranks as one
    global batch (`parallel/moe.py`), as the reference's GSPMD step
    routes its global batch; under the elastic reduction each canonical
    micro-batch routes by itself, as the reference's elastic step does.
    `moe_dispatch_chunk` and `moe_dispatch_dtype` are `moe_mlp`'s."""
    impl = pick_attn_impl(attn_impl, seq_len or model.max_seq, device,
                          model.head_dim)
    attn_fn = get_attn_fn(impl)
    mesh = mesh or device_mesh(torch.device(device))
    group = None if elastic_width or mesh.group is None else mesh

    def loss_fn(params, tokens, targets):
        return lm_loss(model, params, tokens, targets, attn_fn=attn_fn,
                       compute_dtype=compute_dtype, remat=remat,
                       moe_aux_weight=moe_aux_weight, ce_chunk=ce_chunk,
                       moe_dispatch_chunk=moe_dispatch_chunk,
                       moe_dispatch_dtype=moe_dispatch_dtype,
                       moe_group=group), {}

    dp_step = make_dp_train_step(loss_fn, optimizer, mesh,
                                 grad_accum=grad_accum,
                                 elastic_width=elastic_width,
                                 accum_dtype=accum_dtype)

    def step(state, tokens, targets):
        state, metrics = dp_step(state, tokens, targets)
        return state, {"loss": metrics[0]}

    step.loss_fn = loss_fn
    step.grads = dp_step.grads
    return step


def make_elastic_lm_train_step(model: TransformerLM, optimizer, mesh, *,
                               elastic_width: int, attn_impl: str = "auto",
                               seq_len: int | None = None,
                               compute_dtype: torch.dtype | None = None,
                               remat: bool = False,
                               moe_aux_weight: float = 0.01,
                               ce_chunk: int = 0):
    """The LM step with the width-invariant gradient reduction
    (`parallel/elastic.py`): the gradient is the canonical tree sum over
    B/W0-row micro-batches, whatever the world, so a run saved at one
    width resumes bit for bit at another. Returns (step, the resolved
    attention impl), as the reference's does."""
    impl = pick_attn_impl(attn_impl, seq_len or model.max_seq, mesh.device,
                          model.head_dim)
    step = make_lm_train_step(
        model, optimizer, attn_impl=impl, seq_len=seq_len,
        device=mesh.device, compute_dtype=compute_dtype, remat=remat,
        moe_aux_weight=moe_aux_weight, ce_chunk=ce_chunk, mesh=mesh,
        elastic_width=elastic_width)
    return step, impl


def lm_flops_per_token(model: TransformerLM, seq_len: int) -> float:
    """Analytic forward + backward FLOPs per trained token (the MFU
    numerator; backward = 2x forward). Per layer, per token: q proj 2d²,
    kv proj 4·d·(Hkv·hd), attention out 2d², MLP 16d²·k (k = moe_top_k
    for MoE blocks) plus the router 2·d·E, attention scores and values
    2·s·d (causal: each query sees s/2 keys on average). Head: 2·d·V."""
    d, s, v = model.dim, seq_len, model.vocab
    kv_dim = model.n_kv * model.head_dim
    k = model.moe_top_k if model.moe_experts else 1
    mlp = 16 * d * d * k
    gate = 2 * d * model.moe_experts if model.moe_experts else 0
    per_layer = 2 * d * d + 4 * d * kv_dim + 2 * d * d + mlp + gate + 2 * s * d
    fwd = model.depth * per_layer + 2 * d * v
    return 3.0 * fwd


def count_params(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))
