"""Attention ops (counterpart of the reference's `ops/attention.py`):
the quadratic oracle the LM trains with as its "oracle" attention, the
online-softmax blockwise form, and the rotary and grouped-query helpers
the decode forward shares.

Layout as in the reference: q/k/v are (B, S, H, D). Under grouped-query
attention query head h reads kv head h // (H // Hkv). Logits are float32
whatever the input type: bf16 operands are widened before each product,
which is what the reference's `preferred_element_type=float32` computes
(products of bf16 values are exact in float32).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free


def repeat_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Expand (B, S, Hkv, D) k/v to the full H query heads by repeating
    each kv head over its group (group-major, the reference's order)."""
    hkv = kv.shape[2]
    if n_heads == hkv:
        return kv
    if n_heads % hkv:
        raise ValueError(f"heads {n_heads} not a multiple of kv heads {hkv}")
    return torch.repeat_interleave(kv, n_heads // hkv, dim=2)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding (rotate-half form) for x: (B, S, H, D).

    positions: (S,) absolute positions shared by every row, or (B, S)
    per-row positions (each serving slot at its own depth). Angles are
    computed in float32 whatever x's dtype; the result returns in x's
    dtype. D must be even."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope needs an even head dim, got {d}")
    half = d // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32,
                                   device=x.device), exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    cos = torch.cos(angles).unsqueeze(-2)
    sin = torch.sin(angles).unsqueeze(-2)
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False) -> torch.Tensor:
    """Full (quadratic) scaled dot-product attention, the oracle.
    q (B, S, H, D); k/v (B, S, Hkv, D) with H % Hkv == 0 (grouped-query
    through a reshape, no copy). Float32 logits and softmax; the
    probabilities rounded to v's type for the PV product; the output in
    q's type."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32,
                                          device=q.device))
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _block_logits(q: torch.Tensor, k: torch.Tensor, scale) -> torch.Tensor:
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def online_softmax_block(carry, q, k, v, mask=None):
    """Fold one key/value block into the online-softmax state.

    carry = (o (B, Sq, H, D) f32 running numerator, m (B, H, Sq) f32
    running row max, l (B, H, Sq) f32 running denominator); mask an
    optional (Sq, Sk) bool, True = attend. Returns the updated carry;
    finalize with `finalize_online`."""
    o, m, l = carry
    d = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32,
                                          device=q.device))
    logits = _block_logits(q, k, scale)               # (B, H, Sq, Sk)
    if mask is not None:
        logits = torch.where(mask[None, None], logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    if mask is not None:
        # A fully masked row keeps m == NEG_INF, where exp(0) = 1 would
        # count masked keys: zero them so l stays 0.
        p = torch.where(mask[None, None], p, 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha.transpose(1, 2)[..., None]
    o_new = o_new + torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                                 v.float())
    return o_new, m_new, l_new


def init_online(q: torch.Tensor):
    """Fresh online-softmax carry for queries q (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    return o, m, l


def finalize_online(carry, dtype: torch.dtype) -> torch.Tensor:
    """o / l, with fully masked rows (l == 0) mapped to zeros."""
    o, _, l = carry
    l_t = l.transpose(1, 2)[..., None]                # (B, Sq, H, 1)
    return torch.where(l_t > 0, o / l_t.clamp_min(1e-30), 0.0).to(dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        block_size: int, causal: bool = False) -> torch.Tensor:
    """Full attention computed block by block with the online softmax
    (the single-device form of the ring-attention algebra): exact parity
    with `attention`. q/k/v (B, S, H, D), S a multiple of block_size."""
    b, s, h, d = q.shape
    if s % block_size:
        raise ValueError(f"seq len {s} not divisible by block {block_size}")
    qi = torch.arange(s, device=q.device)[:, None]
    carry = init_online(q)
    for j in range(s // block_size):
        sl = slice(j * block_size, (j + 1) * block_size)
        ki = j * block_size + torch.arange(block_size, device=q.device)[None, :]
        mask = (ki <= qi) if causal else torch.ones(
            (s, block_size), dtype=torch.bool, device=q.device)
        carry = online_softmax_block(carry, q, k[:, sl], v[:, sl], mask)
    return finalize_online(carry, q.dtype)
