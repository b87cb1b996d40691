"""The cached-decode forward (counterpart of the reference's
`models/generate.py`): the auto dtype routing, the int8 KV quantizer,
`token_forward` (the one forward skeleton serving runs, attention
injected per layer) and `attend_kv` (the masked GQA attention read over
materialized cache rows, the plain oracle of the paged kernel).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF
from ..ops.gemv import qmatmul
from .transformer import TransformerLM, _layernorm

# THE auto-dtype routing table, keyed by surface -> (GQA/MQA pick, MHA
# pick): the reference's table, unchanged. It was chosen from the
# reference's own decode measurements; it has not been re-measured on
# the card.
_AUTO_DTYPE_ROUTING: dict[str, tuple[str, str]] = {
    "cache": ("int8", "bfloat16"),
    "weights": ("int8", "float32"),
}


def _route_auto(surface: str, dtype: str, heads: int,
                kv_heads: int | None) -> str:
    if dtype != "auto":
        return dtype
    gqa_pick, mha_pick = _AUTO_DTYPE_ROUTING[surface]
    kv = kv_heads or heads
    return gqa_pick if kv < heads else mha_pick


def pick_cache_dtype(dtype: str, *, heads: int,
                     kv_heads: int | None = None) -> str:
    """Resolve a KV-cache dtype of "auto": int8 for GQA/MQA, bfloat16 for
    MHA. Explicit dtypes pass through."""
    return _route_auto("cache", dtype, heads, kv_heads)


def pick_weights_dtype(dtype: str, *, heads: int,
                       kv_heads: int | None = None) -> str:
    """Resolve a decode-weights dtype of "auto": int8 for GQA/MQA,
    float32 for MHA. Explicit dtypes pass through."""
    return _route_auto("weights", dtype, heads, kv_heads)


def _quant_kv(x: torch.Tensor):
    """Per-(batch, position, head) absmax int8 quantization of a
    (B, T, Hkv, hd) k/v tensor: (int8 values, float32 scales
    (B, T, Hkv, 1)) with x ~= values * scales. `torch.round` rounds half
    to even, as `jnp.round` does."""
    xf = x.to(torch.float32)
    s = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.clamp_min(s, 1e-10)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def token_forward(model: TransformerLM, params: dict, toks: torch.Tensor,
                  positions: torch.Tensor, attend) -> torch.Tensor:
    """THE cached-decode forward skeleton: k tokens per row at explicit
    absolute positions, the attention/cache behavior injected per layer.

    toks: (B, k) int64; positions: (k,) shared across rows, or (B, k)
    per-row positions (each serving slot at its own depth).
    attend(i, q, k, v) -> (B, k, H*hd) float32 performs layer i's cache
    write and masked attention read. Every weight matmul goes through
    `qmatmul`, so params may carry int8 QuantW leaves.
    Returns (B, k, vocab) float32 logits."""
    if model.moe_experts:
        raise NotImplementedError(
            "MoE token_forward is not ported yet (dense MLP only)")
    x = params["tok_emb"][toks]                           # (B, k, dim)
    if model.pos == "learned":
        # Padding rows of a last prefill chunk may run past the table;
        # clamp like the reference's gather (their outputs are dropped).
        x = x + params["pos_emb"][positions.long().clamp(max=model.max_seq - 1)]
    for i, blk in enumerate(params["blocks"]):
        y = _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"])
        q, k, v = model.project_qkv(blk, y, positions=positions)
        o = attend(i, q, k, v)
        x = x + qmatmul(o.to(x.dtype), blk["wo"])
        y = _layernorm(x, blk["ln2"]["g"], blk["ln2"]["b"])
        # jax.nn.gelu defaults to the tanh approximation.
        x = x + qmatmul(F.gelu(qmatmul(y, blk["w1"]), approximate="tanh"),
                        blk["w2"])
    x = _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    return qmatmul(x, params["head"]).to(torch.float32)


def attend_kv(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
              mask: torch.Tensor, cks: torch.Tensor | None = None,
              cvs: torch.Tensor | None = None) -> torch.Tensor:
    """THE masked GQA attention read over materialized cache rows.

    q: (B, k, H, hd); ck/cv: (B, L, Hkv, hd) rows in any storage dtype;
    int8 rows come with absmax scales cks/cvs (B, L, Hkv, 1), applied
    outside the products (a key's scale multiplies its logit, a value's
    scale its probability). mask: (k, L) or (B, k, L) bool, True =
    attend. Scores and softmax are float32; bf16 probabilities are
    rounded to bf16 before the PV product, as in the reference.
    Returns (B, k, H*hd) float32."""
    b, kk, h, hd = q.shape
    hkv = ck.shape[2]
    g = h // hkv
    int8 = ck.dtype == torch.int8
    f32 = torch.float32
    qg = q.reshape(b, kk, hkv, g, hd).to(f32)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.to(f32)) * scale
    if int8:
        logits = logits * cks.permute(0, 2, 3, 1)[:, :, None, :, :]
    if mask.dim() == 2:
        mask = mask[None]
    # A Python scalar, not a tensor made from one: building a CUDA tensor
    # from host memory would wait for the stream on every call.
    logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if int8:
        probs = probs * cvs.permute(0, 2, 3, 1)[:, :, None, :, :]
    elif cv.dtype != f32:
        probs = probs.to(cv.dtype).to(f32)
    o = torch.einsum("bhgqk,bkhd->bqhgd", probs, cv.to(f32))
    return o.reshape(b, kk, h * hd)
