"""Decoder-only transformer LM: config, parameters, the QKV projection
the decode forward shares, and the training forward `apply`
(counterpart of the reference's `models/transformer.py`).

Parameters are a plain dict with the reference's names and shapes, so
`convert.params_from_jax` maps one onto the other leaf for leaf. Weight
matrices stay (din, dout) so `x @ W` matches the reference.

Numerics as the reference's: master params are float32;
`compute_dtype=torch.bfloat16` runs every weight product and the
residual stream in bf16, with layernorm statistics and the head's
logits in float32. Pre-LN blocks, 4x MLP with the tanh-approximated
gelu (`jax.nn.gelu`'s default), or, with `moe_experts`, an MoE MLP
(`parallel/moe.py`): capacity routing in training, every expert with no
drop under `moe_inference` (prefill and decode).
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..data import prng
from ..ops.attention import attention, rope
from ..ops.gemv import QuantW, qmatmul, tree_map
from ..parallel.moe import init_moe_params, moe_mlp, moe_mlp_inference


def _weight_cast(cd: torch.dtype | None):
    """The compute-dtype weight cast; int8 `QuantW` leaves keep their own
    storage type (qmatmul dequantizes them in its kernel)."""
    if cd is None:
        return lambda t: t
    return lambda t: t if isinstance(t, QuantW) else t.to(cd)


def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layernorm with float32 statistics (population variance, as
    `jnp.var`); output back in x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * g + b
    return y.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class TransformerLM:
    """Decoder-only LM: vocab -> dim, `depth` pre-LN blocks, 4x MLP.
    Field names and defaults are the reference's."""

    vocab: int = 64
    dim: int = 64
    heads: int = 4
    depth: int = 2
    max_seq: int = 256
    kv_heads: int = 0      # 0 = heads (MHA); < heads = GQA (1 = MQA)
    pos: str = "learned"   # learned | rope
    moe_experts: int = 0   # 0 = dense MLP; > 0 = MoE MLP per block
    moe_top_k: int = 1     # experts per token: 1 = Switch, 2 = GShard
    name: str = "transformer_lm"

    @property
    def head_dim(self) -> int:
        if self.dim % self.heads:
            raise ValueError(f"dim {self.dim} not divisible by heads {self.heads}")
        return self.dim // self.heads

    @property
    def n_kv(self) -> int:
        hkv = self.kv_heads or self.heads
        if hkv <= 0 or self.heads % hkv:
            raise ValueError(
                f"kv_heads must be a positive divisor of heads "
                f"{self.heads}; got {hkv}"
            )
        return hkv

    def init(self, key, device: torch.device | str = "cpu") -> dict:
        """Random float32 parameters drawn from the threefry `key`
        (`data/prng.py`) on `device`, as the reference's init draws them:
        `split(key, 3 + 4 * depth)` taken in order (token embedding, the
        position key, drawn even for rope, the head, then four a block:
        qkv, wo and the two MLP keys, or the MoE key and one unused),
        GQA's q and kv from a split of the block's qkv key."""
        d, v, hd = self.dim, self.vocab, self.head_dim
        scale = 1.0 / math.sqrt(d)
        keys = iter(prng.split(key, 3 + 4 * self.depth))

        def normal(k, *shape):
            return prng.normal(k, shape, device)

        def dense(k, din, dout):
            # float32 division by the float32 root, rounded once
            return (normal(k, din, dout).double()
                    / float(np.float32(math.sqrt(din)))).float()

        def ones_zeros():
            return {"g": torch.ones(d, device=device),
                    "b": torch.zeros(d, device=device)}

        params = {"tok_emb": normal(next(keys), v, d) * scale,
                  "ln_f": ones_zeros(), "blocks": []}
        pos_key = next(keys)
        if self.pos == "learned":
            params["pos_emb"] = normal(pos_key, self.max_seq, d) * scale
        elif self.pos != "rope":
            raise ValueError(f"unknown pos {self.pos!r}; 'learned' or 'rope'")
        params["head"] = dense(next(keys), d, v)
        for _ in range(self.depth):
            blk = {"ln1": ones_zeros(), "ln2": ones_zeros()}
            qkv_key = next(keys)
            if self.n_kv == self.heads:
                blk["wqkv"] = dense(qkv_key, d, 3 * d)
            else:
                kq, kkv = prng.split(qkv_key, 2)
                blk["wq"] = dense(kq, d, d)
                blk["wkv"] = dense(kkv, d, 2 * self.n_kv * hd)
            blk["wo"] = dense(next(keys), d, d)
            if self.moe_experts:
                blk["moe"] = init_moe_params(next(keys), d, 4 * d,
                                             self.moe_experts, device)
                next(keys)      # the block's key budget stays four
            else:
                blk["w1"] = dense(next(keys), d, 4 * d)
                blk["w2"] = dense(next(keys), 4 * d, d)
            params["blocks"].append(blk)
        return params

    def project_qkv(self, blk: dict, y: torch.Tensor, *,
                    positions: torch.Tensor,
                    compute_dtype: torch.dtype | None = None):
        """QKV projections + head reshape + rotary. y: (B, S, dim);
        positions (S,) or (B, S). Weight matmuls go through `qmatmul`,
        so int8 `QuantW` leaves take the int8 kernel; other weights are
        cast to `compute_dtype` when one is given.
        Returns q: (B, S, H, hd); k, v: (B, S, Hkv, hd)."""
        b, s, _ = y.shape
        h, hd, hkv = self.heads, self.head_dim, self.n_kv
        w = _weight_cast(compute_dtype)
        if hkv == h:
            q, k, v = torch.chunk(qmatmul(y, w(blk["wqkv"])), 3, dim=-1)
        else:
            q = qmatmul(y, w(blk["wq"]))
            k, v = torch.chunk(qmatmul(y, w(blk["wkv"])), 2, dim=-1)
        q = q.reshape(b, s, h, hd)
        k = k.reshape(b, s, hkv, hd)
        v = v.reshape(b, s, hkv, hd)
        if self.pos == "rope":
            q = rope(q, positions)
            k = rope(k, positions)
        return q, k, v

    def mlp(self, blk: dict, y: torch.Tensor, *,
            compute_dtype: torch.dtype | None = None,
            moe_inference: bool = False, moe_dispatch_chunk: int = 0,
            moe_dispatch_dtype: torch.dtype | None = None, moe_group=None,
            moe_axis: str | None = None):
        """The block's MLP on the normed y (B, S, dim): the tanh-gelu 4x
        MLP, or the MoE MLP, whose expert weights and gate take the
        compute-dtype cast (the router's softmax stays float32). Returns
        (out, aux) with aux the MoE balance loss (0 dense or under
        `moe_inference`). `moe_group` and `moe_axis` are `moe_mlp`'s
        `group` and `axis`."""
        w = _weight_cast(compute_dtype)
        zero = torch.zeros((), device=y.device)
        if not self.moe_experts:
            hidden = F.gelu(qmatmul(y, w(blk["w1"])), approximate="tanh")
            return qmatmul(hidden, w(blk["w2"])), zero
        b, s, d = y.shape
        moe_p = tree_map(w, blk["moe"])
        if moe_inference:
            m = moe_mlp_inference(y.reshape(b * s, d), moe_p,
                                  n_experts=self.moe_experts,
                                  top_k=self.moe_top_k)
            aux = zero
        else:
            m, aux = moe_mlp(y.reshape(b * s, d), moe_p,
                             n_experts=self.moe_experts, top_k=self.moe_top_k,
                             dispatch_chunk=moe_dispatch_chunk,
                             dispatch_dtype=moe_dispatch_dtype,
                             group=moe_group, axis=moe_axis)
        return m.reshape(b, s, d), aux

    def apply_block(self, blk: dict, x: torch.Tensor, *,
                    pos: torch.Tensor, attn: Callable,
                    compute_dtype: torch.dtype | None = None, **moe):
        """One pre-LN block: attention + MLP (or MoE) with residuals.
        `moe` are `mlp`'s MoE keywords. Returns (x, aux) with aux the MoE
        balance loss, 0 for a dense block."""
        b, s, _ = x.shape
        w = _weight_cast(compute_dtype)
        y = _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"])
        q, k, v = self.project_qkv(blk, y, positions=pos,
                                   compute_dtype=compute_dtype)
        o = attn(q, k, v).reshape(b, s, self.heads * self.head_dim)
        x = x + qmatmul(o.to(x.dtype), w(blk["wo"]))
        y = _layernorm(x, blk["ln2"]["g"], blk["ln2"]["b"])
        m, aux = self.mlp(blk, y, compute_dtype=compute_dtype, **moe)
        return x + m.to(x.dtype), aux

    def apply(self, params: dict, tokens: torch.Tensor, *,
              attn_fn: Callable | None = None,
              pos_offset: int | torch.Tensor = 0, causal: bool = True,
              remat: bool = False, return_aux: bool = False,
              compute_dtype: torch.dtype | None = None,
              return_features: bool = False, moe_inference: bool = False,
              moe_dispatch_chunk: int = 0,
              moe_dispatch_dtype: torch.dtype | None = None, moe_group=None,
              moe_axis: str | None = None):
        """The training forward: tokens (B, S) -> float32 logits
        (B, S, vocab), or the final-LN features (B, S, dim) with
        `return_features` (for losses that fuse the head); with
        `return_aux` also the summed MoE balance loss (0 for a dense
        model).

        attn_fn (q, k, v) -> o replaces the causal oracle; pos_offset
        shifts the absolute positions; remat recomputes each block in
        the backward (`torch.utils.checkpoint`). MoE: `moe_inference`
        runs every expert with no drop (`moe_mlp_inference`);
        `moe_dispatch_chunk` and `moe_dispatch_dtype` are `moe_mlp`'s
        `dispatch_chunk` and `dispatch_dtype`; `moe_group`, a data mesh,
        routes its ranks' tokens as one global batch."""
        b, s = tokens.shape
        if s > self.max_seq:
            raise ValueError(f"sequence length {s} exceeds max_seq {self.max_seq}")
        cd = compute_dtype
        w = _weight_cast(cd)
        attn = attn_fn or (lambda q, k, v: attention(q, k, v, causal=causal))
        pos = pos_offset + torch.arange(s, device=tokens.device)
        x = params["tok_emb"][tokens.long()]
        if self.pos == "learned":
            x = x + params["pos_emb"][pos][None, :, :]
        x = w(x)

        def block(blk, x):
            return self.apply_block(
                blk, x, pos=pos, attn=attn, compute_dtype=cd,
                moe_inference=moe_inference,
                moe_dispatch_chunk=moe_dispatch_chunk,
                moe_dispatch_dtype=moe_dispatch_dtype, moe_group=moe_group,
                moe_axis=moe_axis)

        aux_total = torch.zeros((), device=x.device)
        for blk in params["blocks"]:
            if remat:
                x, aux = checkpoint(block, blk, x, use_reentrant=False)
            else:
                x, aux = block(blk, x)
            aux_total = aux_total + aux
        x = _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])
        if return_features:
            return (x, aux_total) if return_aux else x
        # The head product in the compute type; logits come back float32.
        logits = qmatmul(x, w(params["head"])).to(torch.float32)
        return (logits, aux_total) if return_aux else logits
