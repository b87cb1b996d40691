"""Decoder-only transformer LM: config, parameters and the QKV
projection (counterpart of the reference's `models/transformer.py`).

Parameters are a plain dict with the reference's names and shapes, so
`convert.params_from_jax` maps one onto the other leaf for leaf. Weight
matrices stay (din, dout) so `x @ W` matches the reference. Only what
the decode forward needs is here; the training `apply` comes with the
LM-training slice.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.attention import rope
from ..ops.gemv import qmatmul, tree_to


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
    moe_experts: int = 0   # > 0 is not served by this package yet
    moe_top_k: int = 1
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

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cpu") -> dict:
        """Random float32 parameters from an explicit CPU generator,
        moved to `device`. Same names, shapes and scales as the
        reference's init (its values differ: the two frameworks' random
        streams are different; tests share weights through
        `convert.params_from_jax`)."""
        if self.moe_experts:
            raise NotImplementedError(
                "MoE blocks are not ported yet (dense MLP only)")
        d, v, hd = self.dim, self.vocab, self.head_dim
        scale = 1.0 / math.sqrt(d)

        def normal(*shape):
            return torch.randn(*shape, generator=generator,
                               dtype=torch.float32)

        def dense(din, dout):
            return normal(din, dout) / math.sqrt(din)

        params = {
            "tok_emb": normal(v, d) * scale,
            "ln_f": {"g": torch.ones(d), "b": torch.zeros(d)},
            "blocks": [],
        }
        if self.pos == "learned":
            params["pos_emb"] = normal(self.max_seq, d) * scale
        elif self.pos != "rope":
            raise ValueError(f"unknown pos {self.pos!r}; 'learned' or 'rope'")
        params["head"] = dense(d, v)
        for _ in range(self.depth):
            blk = {
                "ln1": {"g": torch.ones(d), "b": torch.zeros(d)},
                "ln2": {"g": torch.ones(d), "b": torch.zeros(d)},
            }
            if self.n_kv == self.heads:
                blk["wqkv"] = dense(d, 3 * d)
            else:
                blk["wq"] = dense(d, d)
                blk["wkv"] = dense(d, 2 * self.n_kv * hd)
            blk["wo"] = dense(d, d)
            blk["w1"] = dense(d, 4 * d)
            blk["w2"] = dense(4 * d, d)
            params["blocks"].append(blk)
        return tree_to(params, device)

    def project_qkv(self, blk: dict, y: torch.Tensor, *,
                    positions: torch.Tensor):
        """QKV projections + head reshape + rotary. y: (B, S, dim);
        positions (S,) or (B, S). Weight matmuls go through `qmatmul`,
        so int8 `QuantW` leaves take the int8 kernel.
        Returns q: (B, S, H, hd); k, v: (B, S, Hkv, hd)."""
        b, s, _ = y.shape
        h, hd, hkv = self.heads, self.head_dim, self.n_kv
        if hkv == h:
            q, k, v = torch.chunk(qmatmul(y, blk["wqkv"]), 3, dim=-1)
        else:
            q = qmatmul(y, blk["wq"])
            k, v = torch.chunk(qmatmul(y, blk["wkv"]), 2, dim=-1)
        q = q.reshape(b, s, h, hd)
        k = k.reshape(b, s, hkv, hd)
        v = v.reshape(b, s, hkv, hd)
        if self.pos == "rope":
            q = rope(q, positions)
            k = rope(k, positions)
        return q, k, v

